"""R1CS -> QRP reduction: instance maps and witness maps.

Port of ``ringsnark_tpu/reductions/r1cs_to_qrp.py``:

* ``r1cs_to_qrp_instance_map``: the constraint coefficients scattered into
  Lagrange-basis maps (host, the reference's form);
* ``r1cs_to_qrp_instance_map_with_evaluation`` / ``eval_instance_arrays``:
  the QRP basis polynomials at t by a transposed SpMV over the Lagrange
  values;
* ``prover_witness_map_chunked``: the non-ZK prover's witness map
  (a_full, b_full, H) — SpMVs, cyclic iNTTs of size M, and the size-2M
  cyclic NTT product whose upper half is H — assembled per slot chunk;
* ``witness_map_kernel_chunked``: the ZK witness map (modes ``"mid"`` and
  ``"all"``) over the full/io/mid assignment batches of
  ``_assignment_batches``, with the patch (d2·A + d1·B − d3) + d1·d2·Z,
  its transforms (``WitnessTransforms``) on one device or coefficient-sharded;
  ``r1cs_to_qrp_witness_map`` wraps its ``"all"`` mode in a ``QRPWitness``;
* ``r1cs_to_qrp_witness_map_generic``: the reference's control flow with
  list-based polynomials (``utils/poly.py``) on any domain and element type
  (``IntegerDomain``, ``OracleElem``), for cross-checks.

The io/mid split of the repo counts the constant column once, on the io
side (not the C++ reference's double count); the prover-mode map needs only
the full assignment, since io + mid = full and the map is linear.

Inside the maps every batch is slot-major, ``[n, L, M]``: the constraint
evaluations come that way from ``CompiledR1CS.evaluate`` (on the card
``spmv_kernel`` writes them so, reading the slot window of the assignment
in place), go through the interpolating inverse NTTs and the size-2M
product without a transposing copy, and are written into the ``[M, L, n]``
outputs once.  Every modular product of the maps is `_mulmod`: on the card
``ops/cuda_witness.mulmod`` (``mulmod_kernel``, the ZK patch's add fused),
elsewhere ``ops/modops``' int64 ``mul_mod`` and ``add_mod``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops import cuda_witness
from ..ops import ntt as _ntt
from ..ops.modops import add_mod, mul_mod, neg_mod, sub_mod
from ..relations.qrp import QRPInstance, QRPInstanceEvaluation, QRPWitness
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem
from ..rings.elem import RingElem
from ..utils import poly as _poly
from ..utils.domain import RootsDomain

__all__ = [
    "mod_powers_device",
    "r1cs_to_qrp_instance_map",
    "r1cs_to_qrp_instance_map_with_evaluation",
    "eval_instance_arrays",
    "r1cs_to_qrp_witness_map",
    "r1cs_to_qrp_witness_map_generic",
    "prover_witness_map_chunked",
    "witness_map_kernel_chunked",
    "WitnessTransforms",
    "LOCAL",
]


def mod_powers_device(t_res, count: int, ctx):
    """[1, t, ..., t^(count-1)] as int32[count, L, 1], by log(count) doublings."""
    pw = torch.ones((1, *t_res.shape), dtype=torch.int32, device=t_res.device)
    while pw.shape[0] < count:
        step = mul_mod(pw[-1], t_res, ctx.p)  # t^cur
        pw = torch.cat([pw, mul_mod(pw, step[None], ctx.p)], dim=0)
    return pw[:count]


# ---------------------------------------------------------------------------
# instance map with evaluation
# ---------------------------------------------------------------------------


def r1cs_to_qrp_instance_map(cs: R1CSConstraintSystem, domain) -> QRPInstance:
    """Scatter constraint coefficients into Lagrange-basis maps
    (`r1cs_to_qrp.tcc:26-58`)."""
    nv = cs.num_variables()
    A = [dict() for _ in range(nv + 1)]
    B = [dict() for _ in range(nv + 1)]
    C = [dict() for _ in range(nv + 1)]
    for i, cons in enumerate(cs.constraints):
        for M, lc in ((A, cons.a), (B, cons.b), (C, cons.c)):
            for term in lc.terms:
                d = M[term.index]
                d[i] = d[i] + term.coeff if i in d else term.coeff
    return QRPInstance(domain, nv, domain.m, cs.num_inputs(), A, B, C)


def r1cs_to_qrp_instance_map_with_evaluation(
    comp: CompiledR1CS, t: RingElem, domain: RootsDomain
) -> QRPInstanceEvaluation:
    """Evaluate the QRP instance at t: batched At/Bt/Ct ([nv+1, L, nc]),
    Ht ([M+1, L, 1]) and Zt."""
    ctx = comp.ctx
    At, Bt, Ct, Zt = eval_instance_arrays(comp, t.res, domain)
    Ht = mod_powers_device(t.res, domain.m + 1, ctx)
    return QRPInstanceEvaluation(
        domain, comp.num_variables, domain.m, comp.primary_input_size,
        t, RingElem(ctx, At), RingElem(ctx, Bt), RingElem(ctx, Ct),
        RingElem(ctx, Ht), RingElem(ctx, Zt),
    )


def eval_instance_arrays(comp, t_res, domain):
    """(At, Bt, Ct, Zt) arrays at t: At[k] = sum_i u_i * A[i, k] with u the
    Lagrange values at t."""
    ctx = comp.ctx
    t = RingElem(ctx, t_res)
    u = domain.evaluate_all_lagrange_polynomials(t).res  # [M, L, 1]
    Zt = domain.compute_vanishing_polynomial(t)
    At, Bt, Ct = comp.evaluate(u, comp.num_variables + 1, transposed=True)
    return At, Bt, Ct, Zt.res


# ---------------------------------------------------------------------------
# witness map — prover mode
# ---------------------------------------------------------------------------


def _pa_batches(ctx, primary, auxiliary):
    """(p_res, a_res) assignment arrays, each [rows, L, n] — the inputs of
    `prover_witness_map_chunked`.  Accepts RingElem batches or lists."""

    def arr(x):
        if isinstance(x, RingElem):
            return x.res
        if x:
            return RingElem.stack(list(x)).res
        return torch.zeros((0, ctx.L, 1), dtype=torch.int32, device=ctx.device)

    return arr(primary), arr(auxiliary)


def _assignment_batches(ctx, primary, auxiliary):
    """(full, io, mid) assignment batches, each [1+nv, L, n]:
    io = [1, primary, 0...], mid = [0, 0..., auxiliary] (the constant counted
    once, on the io side), at one slot width n.  Inputs are lists of RingElem
    or RingElem batches; each side is stacked once."""
    p_res, a_res = _pa_batches(ctx, primary, auxiliary)
    n = max(p_res.shape[-1], a_res.shape[-1], 1)
    p_res = p_res.expand(*p_res.shape[:-1], n)
    a_res = a_res.expand(*a_res.shape[:-1], n)
    one_r = RingElem.one(ctx).res.expand(1, ctx.L, n)
    full = torch.cat([one_r, p_res, a_res], dim=0)
    io = torch.cat([one_r, p_res, torch.zeros_like(a_res)], dim=0)
    mid = torch.cat([torch.zeros_like(one_r), torch.zeros_like(p_res), a_res], dim=0)
    return RingElem(ctx, full), RingElem(ctx, io), RingElem(ctx, mid)


def _mulmod(ctx, a, b, c=None, out=None):
    """a * b (+ c) mod p_l, b and c broadcasting to a: on the card one
    ``cuda_witness.mulmod`` (into `out`, which may be a or c), elsewhere
    the int64 ``mul_mod`` and ``add_mod``, its plain version."""
    if cuda_witness.on_card(a):
        return cuda_witness.mulmod(a, b, ctx.primes, c, out)
    y = mul_mod(a, b, ctx.p)
    y = y if c is None else add_mod(y, c, ctx.p)
    return y if out is None else out.copy_(y)


def _interp(domain: RootsDomain, evals):
    """[n, L, M] slot-major domain-order evals -> [n, L, M] coefficients (via iNTT)."""
    return domain.interpolate_arr(evals)


def _h_main(ctx, aA, aB, M: int):
    """The upper half of coeffs(A*B), slot-major [n, L, M]: a size-2M cyclic
    NTT product of the zero-padded slot-major coefficient batches.  (A*B - C
    is divisible by Z = X^M - 1, and C, of degree < M, never reaches these
    coefficients.)"""
    if M == 1:
        # A, B constants; A*B - C = q * (X - x_0) requires q = 0
        return torch.zeros_like(aA)
    plan2 = _ntt.get_plan(ctx.primes, 2 * M)

    def fwd2(a):  # [n, L, M] coefficients -> zero-padded [n, L, 2M] evals
        x = torch.zeros((a.shape[0], ctx.L, 2 * M), dtype=torch.int32, device=a.device)
        x[..., :M] = a
        return _ntt.cyclic_ntt_rev(x, plan2)

    x = fwd2(aA)
    prod = _ntt.cyclic_intt_nat(_mulmod(ctx, x, fwd2(aB), out=x), plan2)
    return prod[..., M:]  # q_{M-1} = 0


@dataclass(frozen=True)
class WitnessTransforms:
    """The transforms of the witness map, slot-major: ``interp(domain,
    evals)`` takes [n, L, M] domain-order evaluations to coefficients,
    ``h_main(ctx, aA, aB, M)`` gives the upper half of coeffs(A*B) as [n, L,
    M].  `LOCAL` runs them on one device; ``parallel/witness_sharded.py``
    coefficient-sharded."""

    interp: Callable
    h_main: Callable


LOCAL = WitnessTransforms(_interp, _h_main)


def _windows(n: int, slot_chunk: int):
    """The (lo, width) slot windows of a map over n slots: one window of all
    of them (width None) up to `slot_chunk`, else chunks of `slot_chunk`."""
    if n <= slot_chunk:
        return [(0, None)]
    assert n % slot_chunk == 0, (n, slot_chunk)
    return [(lo, slot_chunk) for lo in range(0, n, slot_chunk)]


def _outputs(ctx, rows, w: int, width, n: int, device):
    """Empty [r, L, n'] outputs for rows `rows`: n' the window's slots w for
    one window of everything (width None), else all n."""
    nw = w if width is None else n
    return [torch.empty((r, ctx.L, nw), dtype=torch.int32, device=device) for r in rows]


def _write(o, piece, lo: int):
    """The slot-major [w, L, r] piece into rows [0, r) of the [M', L, n]
    output o at slots [lo, lo + w)."""
    o[:piece.shape[2], :, lo:lo + piece.shape[0]] = piece.permute(2, 1, 0)


def _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain, outputs: str = "all",
                        tf: WitnessTransforms = LOCAL, lo: int = 0, width: int | None = None):
    """The ZK witness map (`r1cs_to_qrp.tcc:148-259`) of the slot window
    [lo, lo + width) (all slots where width is None): constraint evaluations
    and iNTTs of the io and mid legs, H from the full assignment, and the
    patch H += d2*A + d1*B, H[0] -= d3 + d1*d2, H[M] = d1*d2 (that is, +
    d1*d2*Z).  d's are [L, 1] or [L, n] (sliced to the window here).

    Returns (legs, H_main, head, d1d2, Z): the legs slot-major [w, L, M]
    ("all": a_io, b_io, c_io, a_mid, b_mid, c_mid; "mid": the mid three),
    H's rows 0..M-1 slot-major with the patch, its row 0 [L, w] and row M
    (d1*d2, [L, 1 or w]), and Z ([M+1, L, 1], "all" only).

    Only the legs an output needs are run (C of the full assignment never
    is; the io legs only for "all", so "mid" takes z_io = None).  `tf` holds
    the transforms."""
    assert outputs in ("all", "mid"), outputs
    ctx, M, p = comp.ctx, domain.m, comp.ctx.p

    def legs(z, k=3):
        return [tf.interp(domain, e)
                for e in comp.evaluate(z, M, range(k), lo, width, slot_major=True)]

    def window(d):
        return d if width is None or d.shape[-1] == 1 else d[..., lo:lo + width]

    d1r, d2r, d3r = (window(d) for d in (d1r, d2r, d3r))
    aA, aB = legs(z_full, 2)
    # the patch on the slot-major batches: d [L, 1 or w] as [1 or w, L, 1]
    H = _mulmod(ctx, aB, d1r.t()[:, :, None], c=tf.h_main(ctx, aA, aB, M))
    H = _mulmod(ctx, aA, d2r.t()[:, :, None], c=H, out=H)
    del aA, aB
    d1d2 = _mulmod(ctx, d1r.expand(ctx.L, max(d1r.shape[-1], d2r.shape[-1])).contiguous(), d2r)
    head = sub_mod(sub_mod(H[:, :, 0].t(), d3r, p), d1d2, p)  # [L, w]
    mids = legs(z_mid)
    if outputs == "mid":
        return mids, H, head, d1d2, None
    Z = torch.zeros((M + 1, ctx.L, 1), dtype=torch.int32, device=H.device)  # X^M - 1
    Z[0] = neg_mod(torch.ones_like(Z[0]), p)
    Z[M] = 1
    return legs(z_io) + mids, H, head, d1d2, Z


def r1cs_to_qrp_witness_map(comp: CompiledR1CS, primary, auxiliary, d1: RingElem,
                            d2: RingElem, d3: RingElem, domain: RootsDomain) -> QRPWitness:
    """The witness map on tensors (`r1cs_to_qrp.tcc:148-259` semantics): the
    io and mid coefficient vectors, Z and H with the ZK patch, as a
    ``QRPWitness`` of RingElem batches.  `primary`/`auxiliary` are lists of
    RingElem or RingElem batches."""
    ctx = comp.ctx
    full, io, mid = _assignment_batches(ctx, primary, auxiliary)
    outs = witness_map_kernel_chunked(comp, full.res, io.res, mid.res, d1.res, d2.res,
                                      d3.res, domain, outputs="all")
    a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H = (RingElem(ctx, x) for x in outs)
    return QRPWitness(
        num_variables=comp.num_variables,
        degree=domain.m,
        num_inputs=comp.primary_input_size,
        d1=d1, d2=d2, d3=d3,
        coefficients_for_ABCs=RingElem(ctx, full.res[1:]),
        coefficients_for_A_io=a_io,
        coefficients_for_B_io=b_io,
        coefficients_for_C_io=c_io,
        coefficients_for_A_mid=a_mid,
        coefficients_for_B_mid=b_mid,
        coefficients_for_C_mid=c_mid,
        coefficients_for_Z=Z,
        coefficients_for_H=H,
    )


def witness_map_kernel_chunked(comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain,
                               slot_chunk: int = 1024, outputs: str = "all",
                               tf: WitnessTransforms = LOCAL):
    """`_witness_map_kernel` over windows of `slot_chunk` slots (slots never
    interact; the assignment is read in place at each window), the pieces
    written into [M(+1), L, n] outputs.  d1r/d2r/d3r are [L, 1] constants or
    [L, n] per-slot vectors; Z ("all") is a slot-independent [M+1, L, 1]
    constant, taken once."""
    ctx, n, M = comp.ctx, z_full.shape[-1], domain.m
    for d in (d1r, d2r, d3r):
        assert d.shape[-1] in (1, n), (tuple(d.shape), n)
    out = None
    for lo, width in _windows(n, slot_chunk):
        legs, h, head, d1d2, Z = _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r,
                                                     domain, outputs, tf, lo, width)
        w = h.shape[0]
        if out is None:
            out = _outputs(ctx, [M] * len(legs) + [M + 1], w, width, n, h.device)
        for o, pc in zip(out, legs + [h]):
            _write(o, pc, lo)
        H = out[-1]
        H[0, :, lo:lo + w] = head
        H[M, :, lo:lo + w] = d1d2
        del legs, h
    if outputs == "mid":
        return tuple(out)
    return (*out[:6], Z, out[6])


def prover_witness_map_chunked(comp, p_res, a_res, domain, slot_chunk: int = 1024):
    """(a_full, b_full, H) for the non-ZK prover (d1 = d2 = d3 = 0), over
    windows of `slot_chunk` slots.

    Slots never interact, so each window runs the whole map on its slots of
    z_full = [1, primary, auxiliary], read in place as three row blocks (a
    one-slot block broadcasts); the pieces are written into [M(+1), L, n]
    outputs.  With zero d's the ZK patch vanishes: H is the upper half of
    coeffs(A*B) plus a zero row for X^M, and C·z never reaches these outputs
    (deg C < M leaves the quotient's source coefficients alone), so it is
    not evaluated.  The window bounds the temporaries of the size-2M product
    (at Rq N = 8192, M = 2^14 an unchunked [n, L, 2M] product alone is 1
    GiB)."""
    ctx, M = comp.ctx, domain.m
    n = max(p_res.shape[-1], a_res.shape[-1], 1)
    for x in (p_res, a_res):
        assert x.shape[-1] in (1, n), (tuple(x.shape), n)
    blocks = (torch.ones((1, ctx.L, 1), dtype=torch.int32, device=p_res.device), p_res, a_res)
    out = None
    for lo, width in _windows(n, slot_chunk):
        az, bz = comp.evaluate(blocks, M, (0, 1), lo, width, slot_major=True)
        aA, aB = _interp(domain, az), _interp(domain, bz)
        del az, bz
        h = _h_main(ctx, aA, aB, M)
        if out is None:
            out = _outputs(ctx, (M, M, M + 1), aA.shape[0], width, n, aA.device)
            out[2][M] = 0
        for o, pc in zip(out, (aA, aB, h)):
            _write(o, pc, lo)
        del aA, aB, h
    return tuple(out)


# ---------------------------------------------------------------------------
# witness map — generic host path (reference control flow, any ring/domain)
# ---------------------------------------------------------------------------


def r1cs_to_qrp_witness_map_generic(cs: R1CSConstraintSystem, primary: list, auxiliary: list,
                                    d1, d2, d3, domain) -> QRPWitness:
    """List-based witness map after `r1cs_to_qrp.tcc:148-259` (with the
    constant column counted once, on the io side)."""
    one = type(d1).one(d1.ctx)
    zero = one - one
    m = domain.m
    xs = [domain.get_domain_element(i) for i in range(m)]
    full = list(primary) + list(auxiliary)

    def eval_rows(assignment, const):
        rows = {"a": [], "b": [], "c": []}
        for cons in cs.constraints:
            for key, lc in (("a", cons.a), ("b", cons.b), ("c", cons.c)):
                rows[key].append(lc.evaluate(assignment, const))
        for key in rows:
            rows[key] += [zero] * (m - len(rows[key]))
        return rows

    ev_mid = eval_rows([zero] * len(primary) + list(auxiliary), zero)  # no constant in mid
    ev_io = eval_rows(list(primary) + [zero] * len(auxiliary), one)
    ev_full = eval_rows(full, one)

    a_mid, b_mid, c_mid = (_poly.interpolate(xs, ev_mid[k]) for k in "abc")
    a_io, b_io, c_io = (_poly.interpolate(xs, ev_io[k]) for k in "abc")
    aA, aB, aC = (_poly.interpolate(xs, ev_full[k]) for k in "abc")

    H = [zero] * (m + 1)
    for i in range(m):
        H[i] = d2 * aA[i] + d1 * aB[i]
    H[0] = H[0] - d3
    H = domain.add_poly_Z(d1 * d2, H)

    diff = _poly.add(_poly.multiply(aA, aB), [-c for c in aC])
    H_tmp = domain.divide_by_Z(diff)
    for i in range(min(len(H), len(H_tmp))):
        H[i] = H[i] + H_tmp[i]

    return QRPWitness(
        num_variables=cs.num_variables(),
        degree=m,
        num_inputs=cs.num_inputs(),
        d1=d1, d2=d2, d3=d3,
        coefficients_for_ABCs=full,
        coefficients_for_A_io=a_io,
        coefficients_for_B_io=b_io,
        coefficients_for_C_io=c_io,
        coefficients_for_A_mid=a_mid,
        coefficients_for_B_mid=b_mid,
        coefficients_for_C_mid=c_mid,
        coefficients_for_Z=domain.vanishing_polynomial(),
        coefficients_for_H=H,
    )
