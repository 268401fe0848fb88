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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops import ntt as _ntt
from ..ops.modops import add_mod, mul_mod, neg_mod, sub_mod
from ..relations.qrp import QRPInstance, QRPInstanceEvaluation, QRPWitness
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem, spmv
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
    At, Bt, Ct = (
        spmv(u, coeffs, rows, cols, comp.num_variables + 1, ctx.p)
        for rows, cols, coeffs in zip(comp.rows, comp.cols, comp.coeffs)
    )
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


def _interp(domain: RootsDomain, evals_bln):
    """[M, L, n] domain-order evals -> [M, L, n] coefficients (via iNTT)."""
    c = domain.interpolate_arr(evals_bln.permute(2, 1, 0))  # [n, L, M]
    return c.permute(2, 1, 0)


def _comp_slot_slice(comp, lo, slot_chunk):
    """Slot-slice dense (per-slot) constraint coefficients alongside the
    assignment chunk; scalar (nc == 1) coefficients broadcast."""
    if all(c.shape[-1] == 1 for c in comp.coeffs):
        return comp
    return CompiledR1CS(
        ctx=comp.ctx,
        num_constraints=comp.num_constraints,
        num_variables=comp.num_variables,
        primary_input_size=comp.primary_input_size,
        rows=comp.rows,
        cols=comp.cols,
        coeffs=tuple(
            c if c.shape[-1] == 1 else c[..., lo:lo + slot_chunk] for c in comp.coeffs
        ),
    )


def _witness_map_prover(comp, z_full, domain):
    """(a_full, b_full, H) for the non-ZK prover (d1 = d2 = d3 = 0).

    The "prover" mode of the JAX `_witness_map_kernel`: with zero d's the ZK
    patch vanishes, so H is the upper half of coeffs(A*B) plus a zero row
    for X^M.  C·z never reaches these outputs (deg C < M leaves the
    quotient's source coefficients alone), so it is not interpolated.
    """
    M = domain.m
    az, bz, _ = comp.eval_matrices(z_full, num_rows=M)  # [M, L, n]
    aA, aB = _interp(domain, az), _interp(domain, bz)
    h_main = _h_main(comp.ctx, aA, aB, M)
    H = torch.cat([h_main, torch.zeros_like(h_main[:1])], dim=0)  # [M+1, L, n]
    return aA, aB, H


def _h_main(ctx, aA, aB, M: int):
    """The upper half of coeffs(A*B), [M, L, n]: a size-2M cyclic NTT
    product of the zero-padded coefficient batches.  (A*B - C is divisible
    by Z = X^M - 1, and C, of degree < M, never reaches these coefficients.)"""
    if M == 1:
        # A, B constants; A*B - C = q * (X - x_0) requires q = 0
        return torch.zeros_like(aA)
    n = aA.shape[-1]
    plan2 = _ntt.get_plan(ctx.primes, 2 * M)

    def fwd2(a):  # [M, L, n] coefficients -> zero-padded [n, L, 2M] evals
        x = torch.zeros((n, ctx.L, 2 * M), dtype=torch.int32, device=a.device)
        x[..., :M] = a.permute(2, 1, 0)
        return _ntt.cyclic_ntt_rev(x, plan2)

    prod = _ntt.cyclic_intt_nat(mul_mod(fwd2(aA), fwd2(aB), ctx.p), plan2)
    return prod[..., M:].permute(2, 1, 0)  # q_{M-1} = 0


@dataclass(frozen=True)
class WitnessTransforms:
    """The transforms of the witness map: ``interp(domain, evals)`` takes
    [M, L, n] domain-order evaluations to coefficients, ``h_main(ctx, aA, aB,
    M)`` gives the upper half of coeffs(A*B).  `LOCAL` runs them on one
    device; ``parallel/witness_sharded.py`` coefficient-sharded."""

    interp: Callable
    h_main: Callable


LOCAL = WitnessTransforms(_interp, _h_main)


def _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain, outputs: str = "all",
                        tf: WitnessTransforms = LOCAL):
    """The ZK witness map (`r1cs_to_qrp.tcc:148-259`) of one slot chunk:
    constraint evaluations and iNTTs of the io and mid legs, H from the full
    assignment, and the patch H += d2*A + d1*B, H[0] -= d3 + d1*d2,
    H[M] = d1*d2 (that is, + d1*d2*Z).  d's are [L, 1] or [L, n].

      "all" -> (a_io, b_io, c_io, a_mid, b_mid, c_mid, Z, H)
      "mid" -> (a_mid, b_mid, c_mid, H)

    Only the legs an output needs are run (C of the full assignment never
    is; the io legs only for "all", so "mid" takes z_io = None).  `tf` holds
    the transforms."""
    assert outputs in ("all", "mid"), outputs
    ctx, M, p = comp.ctx, domain.m, comp.ctx.p

    def legs(z, k=3):
        return tuple(tf.interp(domain, e) for e in comp.eval_matrices(z, num_rows=M)[:k])

    aA, aB = legs(z_full, 2)
    patch = add_mod(mul_mod(aA, d2r, p), mul_mod(aB, d1r, p), p)  # [M, L, n]
    H = add_mod(tf.h_main(ctx, aA, aB, M), patch, p)
    del aA, aB, patch
    d1d2 = mul_mod(d1r, d2r, p)
    n = H.shape[-1]
    head = sub_mod(sub_mod(H[0], d3r, p), d1d2, p)
    H = torch.cat([head[None], H[1:], d1d2[None].expand(1, ctx.L, n)], dim=0)  # [M+1, L, n]
    mids = legs(z_mid)
    if outputs == "mid":
        return (*mids, H)
    Z = torch.zeros((M + 1, ctx.L, 1), dtype=torch.int32, device=H.device)  # X^M - 1
    Z[0] = neg_mod(torch.ones_like(Z[0]), p)
    Z[M] = 1
    return (*legs(z_io), *mids, Z, H)


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
    """`_witness_map_kernel` over chunks of `slot_chunk` slots (slots never
    interact), the pieces written into preallocated outputs.  d1r/d2r/d3r
    are [L, 1] constants or [L, n] per-slot vectors, sliced with the chunk;
    Z ("all") is a slot-independent [M+1, L, 1] constant, taken once."""
    n = z_full.shape[-1]
    for d in (d1r, d2r, d3r):
        assert d.shape[-1] in (1, n), (tuple(d.shape), n)
    if n <= slot_chunk:
        return _witness_map_kernel(comp, z_full, z_io, z_mid, d1r, d2r, d3r, domain, outputs,
                                   tf)
    assert n % slot_chunk == 0, (n, slot_chunk)
    z_idx = 6 if outputs == "all" else None

    out = None
    for lo in range(0, n, slot_chunk):
        sl = slice(lo, lo + slot_chunk)
        ds = (d if d.shape[-1] == 1 else d[..., sl] for d in (d1r, d2r, d3r))
        pieces = _witness_map_kernel(
            _comp_slot_slice(comp, lo, slot_chunk), z_full[..., sl],
            None if z_io is None else z_io[..., sl], z_mid[..., sl], *ds, domain, outputs, tf)
        if out is None:
            out = [pc if i == z_idx else
                   torch.empty((*pc.shape[:-1], n), dtype=pc.dtype, device=pc.device)
                   for i, pc in enumerate(pieces)]
        for i, (o, pc) in enumerate(zip(out, pieces)):
            if i != z_idx:
                o[..., sl] = pc
    return tuple(out)


def prover_witness_map_chunked(comp, p_res, a_res, domain, slot_chunk: int = 1024):
    """(a_full, b_full, H) for the non-ZK prover, assembled per slot chunk.

    Slots never interact, so each chunk of `slot_chunk` slots runs the whole
    map on its own slice of z_full = [1, primary, auxiliary]; the pieces are
    written into preallocated outputs.  The chunk bounds the int64
    temporaries of the SpMVs and the size-2M product (at Rq N = 8192,
    M = 2^14 an unchunked [n, L, 2M] product alone is 2 GiB in int64).
    """
    ctx = comp.ctx
    n = max(p_res.shape[-1], a_res.shape[-1], 1)

    def widen(x):
        if x.shape[-1] == n:
            return x
        assert x.shape[-1] == 1, (tuple(x.shape), n)
        return x.expand(*x.shape[:-1], n)

    one_w = RingElem.one(ctx).res.expand(1, ctx.L, n)
    p_w, a_w = widen(p_res), widen(a_res)

    if n <= slot_chunk:
        return _witness_map_prover(comp, torch.cat([one_w, p_w, a_w], dim=0), domain)
    assert n % slot_chunk == 0, (n, slot_chunk)

    out = None
    for lo in range(0, n, slot_chunk):
        sl = slice(lo, lo + slot_chunk)
        z_c = torch.cat([one_w[..., sl], p_w[..., sl], a_w[..., sl]], dim=0)
        pieces = _witness_map_prover(_comp_slot_slice(comp, lo, slot_chunk), z_c, domain)
        if out is None:
            out = [
                torch.empty((*pc.shape[:-1], n), dtype=pc.dtype, device=pc.device)
                for pc in pieces
            ]
        for o, pc in zip(out, pieces):
            o[..., sl] = pc
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
