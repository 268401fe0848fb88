"""Streamed provers: ringGroth16 and Rinocchio with the CRS never resident.

Port of ``ringsnark_tpu/snark/streamed.py``.  At M = 2^18 over Rq N=8192 the
seeded CRS alone would be 192 GiB of c0; here setup and prove run as one
pass, so no CRS batch ever exists whole:

* **outer-limb phasing**: RNS limbs never interact in the prover, so an
  L-limb proof is L single-limb proofs whose ciphertexts concatenate along
  the limb axis (dense multi-limb rings recurse per limb, so the witness
  vectors exist at one limb at a time);
* **row chunks**: each CRS phase (s_pows / delta_ts / delta_mid for
  ringGroth16; s_pows / alpha_s_pows / beta_prods for Rinocchio) is cut
  into `plan_chunks` chunks.  Chunk ci is encrypted like
  ``seeded.encode_seeded`` with ``fold_in(key, ci)`` (slab i of the chunk
  with ``fold_in(fold_in(key, ci), i)``), so the chunk plan fixes the
  ciphertexts, as in the JAX package;
* **encrypt and MAC in one pass**: each chunk is walked in the row
  sub-chunks of ``seeded._sub_rows``; a sub-chunk's CRS rows are
  generated (s^i rows as ``spow * carry``, the lincheck / delta_mid rows
  from the QRP instance at s), encrypted, and folded into int64
  accumulators of the inner products at once, its c1 used as drawn.  The
  JAX package encodes a whole chunk and regenerates c1 from the key in the
  MAC; the sums are exact (products reduced mod Q_j before an int64 sum of
  < 2^32 rows), so the result is bit-identical.  Rows past the end of
  every plaintext of a phase multiply zero and are not encrypted.

The modswitch chain runs once on each final sum.  `StreamRecord` times
the sections ("setup", "prove", "stream") on the host clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..encoding import Encoding, bgv, encode, keygen
from ..encoding.context import EncodingContext, SecretKey
from ..encoding.mac import mac_rows
from ..ops.modops import add_mod, mul_mod
from ..reductions.r1cs_to_qrp import (
    _assignment_batches,
    eval_instance_arrays,
    mod_powers_device,
    prover_witness_map_chunked,
    witness_map_kernel_chunked,
)
from ..relations.r1cs import CompiledR1CS
from ..rings.context import RingContext
from ..rings.elem import RingElem
from ..utils import prng
from ..utils.domain import RootsDomain
from . import rinocchio
from . import seeded as sd
from .api import SnarkParams
from .groth16 import Proof, VerificationKey
from .pipeline import zk_shifted

__all__ = [
    "limb_ring",
    "limb_enc_context",
    "limb_params",
    "limb_secret_key",
    "limb_slice",
    "limb_compiled",
    "StreamRecord",
    "stream_prove",
    "stream_prove_rinocchio",
    "plan_chunks",
]


# ---------------------------------------------------------------------------
# limb slicing
# ---------------------------------------------------------------------------


def limb_ring(ctx: RingContext, l: int | slice) -> RingContext:
    """The single-limb sub-ring Z_{q_l}[X]/(X^N+1), or that of the limbs of
    a slice (``parallel/sharded.py``'s limb blocks)."""
    primes = ctx.primes[l] if isinstance(l, slice) else (ctx.primes[l],)
    return RingContext(primes=primes, N=ctx.N, device=ctx.device)


def limb_enc_context(ectx: EncodingContext, l: int | slice) -> EncodingContext:
    """The encoding context of outer limb l, or of the limbs of a slice
    (plain moduli t_l = q_l)."""
    return EncodingContext(
        ring=limb_ring(ectx.ring, l),
        n_inner=ectx.n_inner,
        inner_primes=ectx.inner_primes,
        error_stddev=ectx.error_stddev,
        floor_limbs=ectx.floor_limbs,
    )


def limb_params(params: SnarkParams, l: int) -> SnarkParams:
    return SnarkParams(ring=limb_ring(params.ring, l), enc=limb_enc_context(params.enc, l),
                       use_modswitch=params.use_modswitch)


def limb_secret_key(ectx_l: EncodingContext, sk: SecretKey, l: int) -> SecretKey:
    return SecretKey(ctx=ectx_l, s_ntt=sk.s_ntt[l:l + 1], s_coeffs=sk.s_coeffs[l:l + 1])


def limb_slice(ctx_l: RingContext, res, l: int):
    """Slice the limb axis (-2) of a slot array: [*, L, n] -> [*, 1, n]."""
    return res[..., l:l + 1, :]


def limb_compiled(comp: CompiledR1CS, l: int) -> CompiledR1CS:
    """Limb-l view of a compiled R1CS (coefficients limb-sliced)."""
    ctx_l = limb_ring(comp.ctx, l)
    return CompiledR1CS(
        ctx=ctx_l,
        num_constraints=comp.num_constraints,
        num_variables=comp.num_variables,
        primary_input_size=comp.primary_input_size,
        rows=comp.rows,
        cols=comp.cols,
        coeffs=tuple(limb_slice(ctx_l, c, l) for c in comp.coeffs),
        plans=comp.plans,  # the same rows and cols: the same CSRs
    )


# ---------------------------------------------------------------------------
# chunk planning
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan_chunks(B: int, phase_rows: int, slab: int) -> tuple[int, int]:
    """(nchunks, chunk) with chunk a multiple of slab, nchunks*chunk >= B:
    ~B/phase_rows equal chunks of ceil(B/nchunks) rows rounded up to whole
    slabs.  All phases of all limbs share the plan."""
    nchunks = max(1, round(B / phase_rows))
    chunk = _ceil_div(_ceil_div(B, nchunks), slab) * slab
    while nchunks * chunk < B:  # round() may undershoot nchunks by one
        nchunks += 1
    return nchunks, chunk


# ---------------------------------------------------------------------------
# timing record
# ---------------------------------------------------------------------------


@dataclass
class StreamRecord:
    """Per-section wall-clock for the streamed provers.

    Kinds: "setup" (trapdoor and instance algebra, small encodes), "prove"
    (witness map, finalize), "stream" (one per phase: the chunked
    encrypt-and-MAC loop).  With `sync`, each section ends in a device
    synchronize, so its time is the device's too.  With `profile`, the
    phase loops instead record per chunk a "setup" section (encryption,
    CRS rows included) and a "prove" section (plaintext NTT and MAC),
    synchronizing around every row sub-chunk."""

    sync: bool = True
    profile: bool = False
    events: list = field(default_factory=list)  # (kind, name, seconds)

    def total(self, kind: str) -> float:
        return sum(dt for k, _, dt in self.events if k == kind)

    def add(self, kind: str, name: str, dt: float):
        self.events.append((kind, name, dt))

    def _sync(self, *tensors):
        if (self.sync or self.profile) and any(t is not None and t.is_cuda for t in tensors):
            torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# CRS rows
# ---------------------------------------------------------------------------


def _rows_at(x, lo: int, hi: int):
    """Rows [lo, hi) of x, zero-padded past its end."""
    sl = x[lo:hi]
    if sl.shape[0] == hi - lo:
        return sl
    pad = torch.zeros((hi - lo - sl.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([sl, pad], dim=0)


def _spow_table(ctx: RingContext, s_res, count: int):
    """([1, s, ..., s^(count-1)], s^count) as residue arrays."""
    pows = mod_powers_device(s_res, count + 1, ctx)
    return pows[:count], pows[count]


def _g16_stream_crs(comp, domain, s_res, alpha, beta, gamma_inv, delta_inv, n_io: int):
    """(gamma_io, delta_mid rows, Zt * delta^-1): the gamma_io ring vector
    [n_io, L, n], a function giving rows [lo, hi) of the delta_mid vector
    ((beta A_k + alpha B_k + C_k) / delta over the mid wires), and Zt/delta.

    delta_mid is made a row range at a time: whole, at Rq 2^18 it would be
    8 GiB (16 GiB of int64 products)."""
    p = comp.ctx.p
    At, Bt, Ct, Zt = eval_instance_arrays(comp, s_res, domain)  # [nv+1, L, 1]

    def combo(lo, hi):
        return add_mod(add_mod(mul_mod(_rows_at(At, lo, hi), beta, p),
                               mul_mod(_rows_at(Bt, lo, hi), alpha, p), p),
                       _rows_at(Ct, lo, hi), p)

    def delta_mid(lo, hi):
        return mul_mod(combo(n_io + lo, n_io + hi), delta_inv, p)

    return mul_mod(combo(0, n_io), gamma_inv, p), delta_mid, mul_mod(Zt, delta_inv, p)


def _rin_stream_crs(comp, domain, s_res, beta, r_v, r_w, r_y, n_io: int):
    """(lincheck rows, Zt): a function giving rows [lo, hi) of
    beta (r_v A_k + r_w B_k + r_y C_k) over the mid wires, and Zt."""
    p = comp.ctx.p
    At, Bt, Ct, Zt = eval_instance_arrays(comp, s_res, domain)

    def lincheck(lo, hi):
        lo, hi = n_io + lo, n_io + hi
        lin = add_mod(add_mod(mul_mod(_rows_at(At, lo, hi), r_v, p),
                              mul_mod(_rows_at(Bt, lo, hi), r_w, p), p),
                      mul_mod(_rows_at(Ct, lo, hi), r_y, p), p)
        return mul_mod(lin, beta, p)

    return lincheck, Zt


def _as_batch(ctx: RingContext, x) -> RingElem:
    """A RingElem batch from a RingElem or a (possibly empty) list."""
    if isinstance(x, RingElem):
        return x
    if x:
        return RingElem.stack(list(x))
    return RingElem(ctx, torch.zeros((0, ctx.L, ctx.N), dtype=torch.int32, device=ctx.device))


# ---------------------------------------------------------------------------
# the phase loop shared by both streamed provers
# ---------------------------------------------------------------------------


def _encode_mac(ectx, sk, rows, nrows: int, pts, lo: int, key, slab: int, accs, rec, tag,
                slab0: int = 0):
    """Encrypt rows [0, nrows) of one chunk (global rows lo + ...) as
    ``seeded.encode_seeded(..., key, slab)`` would, slab i under
    ``fold_in(key, slab0 + i)`` (a rank of ``parallel/stream_sharded.py``
    holds the slabs from slab0 on), and add each sub-chunk's
    products with the plaintext batches `pts` to the int64 accumulators
    `accs` (each product reduced mod Q_j).  `rows(a, b)` gives the chunk's
    CRS rows [a, b).  With ``rec.profile`` records the chunk's encryption
    ("setup") and MAC ("prove") times."""
    t_enc = t_mac = 0.0
    for i, a, b in sd._sub_chunks(nrows, slab, sd._sub_rows(ectx)):
        t0 = time.perf_counter()
        c0, c1 = bgv.encrypt(ectx, sk, rows(a, b), prng.fold_in(key, slab0 + i),
                             draw_rows=slab, lo=a - i * slab)
        if rec.profile:
            rec._sync(c0)
            t1 = time.perf_counter()
            t_enc += t1 - t0
            t0 = t1
        live = [(pt, acc) for pt, acc in zip(pts, accs) if pt.shape[0] > lo + a]
        mac_rows(ectx, 0, c0, c1,
                 [bgv.plain_to_inner_ntt(ectx, pt[lo + a:lo + b], 0) for pt, _ in live],
                 [acc for _, acc in live])
        if rec.profile:
            rec._sync(accs[0][0])
            t_mac += time.perf_counter() - t0
    if rec.profile:
        rec.add("setup", f"{tag}+{lo}", t_enc)
        rec.add("prove", f"{tag}+{lo}", t_mac)


def _run_phases(params_l: SnarkParams, sk_l: SecretKey, phases: list, nchunks: int, chunk: int,
                slab: int, spow_l, s_step_l, rec: StreamRecord, limb_tag: int) -> dict:
    """Encrypt-and-MAC every chunk of every phase for one limb.

    phases: (name, src, pts, key) with src ("pow", scale0) — chunk ci's rows
    are spow_l * (scale0 * s^(ci*chunk)) — or ("rows", fn), fn(lo, hi) giving
    the limb's rows [lo, hi).  Returns {name: [level-0 Encoding per pt]}."""
    ectx = params_l.enc
    p = params_l.ring.p
    Q = ectx.inner_consts(0)
    acc_shape = (ectx.L, ectx.L_inner, ectx.n_inner)
    partials = {}
    for name, (kind, src), pts, enc_key in phases:
        tp = time.perf_counter()
        accs = [tuple(torch.zeros(acc_shape, dtype=torch.int64, device=ectx.device)
                      for _ in range(2)) for _ in pts]
        # rows past every plaintext's end pair with zero: no encryption needed
        need = max(pt.shape[0] for pt in pts)
        carry = src
        for ci in range(nchunks):
            lo = ci * chunk
            if kind == "pow":
                rows = (lambda a, b, c=carry: mul_mod(spow_l[a:b], c, p))
            else:
                rows = (lambda a, b, lo=lo: src(lo + a, lo + b))
            nrows = min(chunk, need - lo)
            if nrows > 0:
                _encode_mac(ectx, sk_l, rows, nrows, pts, lo, prng.fold_in(enc_key, ci), slab,
                            accs, rec, f"limb{limb_tag}:{name}")
            if kind == "pow" and ci + 1 < nchunks:
                carry = mul_mod(carry, s_step_l, p)
        partials[name] = [
            Encoding(ectx, torch.remainder(a0, Q).to(torch.int32),
                     torch.remainder(a1, Q).to(torch.int32), 0) for a0, a1 in accs]
        if not rec.profile:
            rec._sync(partials[name][0].c0)
            rec.add("stream", f"limb{limb_tag}:{name}", time.perf_counter() - tp)
    return partials


def _finish_modswitch(e: Encoding, max_level: int) -> Encoding:
    for _ in range(max_level):
        e = e.modswitch()
    return e


def _cat_limbs(ectx: EncodingContext, encs, axis: int = 0) -> Encoding:
    """One Encoding from per-limb ones (limb axis: 0 for a single element,
    1 for a batch)."""
    lvl = encs[0].level
    assert all(e.level == lvl for e in encs)
    return Encoding(ectx, torch.cat([e.c0 for e in encs], dim=axis),
                    torch.cat([e.c1 for e in encs], dim=axis), lvl)


# ---------------------------------------------------------------------------
# the streamed groth16 prover
# ---------------------------------------------------------------------------


def _g16_vk(comp, domain, params, gamma_io, s, alpha, beta, gamma, delta, sk_enc):
    """The vk of a streamed proof: its pk is a CRS-less SeededProvingKey
    holding only gamma_io (the verifier needs compiled/domain/params)."""
    pk = sd.SeededProvingKey(compiled=comp, domain=domain, params=params, alpha=None,
                             beta=None, s_pows=None, gamma_io=gamma_io, delta_mid=None,
                             delta_ts=None)
    return VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma, delta=delta,
                           sk_enc=sk_enc)


def stream_prove(
    comp: CompiledR1CS,
    params: SnarkParams,
    primary,
    auxiliary,
    rng: np.random.Generator,
    key: prng.Key,
    *,
    slab: int = sd.DEFAULT_SLAB,
    phase_rows: int = 1 << 16,
    record: Optional[StreamRecord] = None,
    trapdoor: Optional[tuple] = None,
    sk_enc: Optional[SecretKey] = None,
    limb_tag: Optional[int] = None,
):
    """Setup + prove with the CRS never resident (`groth16.tcc:5-115`).

    Returns (proof, vk, record).  `trapdoor` = (s, alpha, beta, gamma,
    delta) RingElems and `sk_enc` may be injected; by default both are drawn
    from `rng` in the order of ``seeded.generator_seeded``, so one rng seed
    gives the seeded path's trapdoor and secret key.  Encryption keys: limb
    l's are ``split(fold_in(key, l), 8)`` (dense multi-limb rings first
    recurse per limb with ``fold_in(key, 1000 + l)``)."""
    rec = record if record is not None else StreamRecord(sync=False)
    ctx, ectx = params.ring, params.enc
    L = ctx.L
    M = max(comp.num_constraints, 1)
    n_io = comp.primary_input_size + 1

    t0 = time.perf_counter()
    domain = RootsDomain(ctx, M)
    if trapdoor is None:
        s = RingElem.random_exceptional_element(ctx, rng, domain)
    else:
        s, alpha, beta, gamma, delta = trapdoor
    if sk_enc is None:
        _, sk_enc = keygen(ectx, rng)
    if trapdoor is None:
        alpha, beta, gamma, delta = (RingElem.random_invertible_element(ctx, rng)
                                     for _ in range(4))

    if L > 1 and ctx.N > 1:
        # dense multi-limb ring: one single-limb proof per limb, with the
        # limb's slices of the compiled system, trapdoor and secret key, so
        # the witness and CRS vectors exist at one limb at a time
        rec.add("setup", "common", time.perf_counter() - t0)
        primary_b, aux_b = _as_batch(ctx, primary), _as_batch(ctx, auxiliary)
        parts = []
        for l in range(L):
            params_l = limb_params(params, l)
            ctx_l = params_l.ring
            proof_l, vk_l, rec = stream_prove(
                limb_compiled(comp, l), params_l,
                RingElem(ctx_l, limb_slice(ctx_l, primary_b.res, l)),
                RingElem(ctx_l, limb_slice(ctx_l, aux_b.res, l)),
                rng, prng.fold_in(key, 1000 + l), slab=slab, phase_rows=phase_rows,
                record=rec,
                trapdoor=tuple(RingElem(ctx_l, limb_slice(ctx_l, x.res, l))
                               for x in (s, alpha, beta, gamma, delta)),
                sk_enc=limb_secret_key(params_l.enc, sk_enc, l), limb_tag=l,
            )
            parts.append((proof_l, vk_l.pk.gamma_io))
        proof = Proof(*(_cat_limbs(ectx, [getattr(pf, f) for pf, _ in parts]) for f in "ABC"))
        gamma_io = _cat_limbs(ectx, [g for _, g in parts], axis=1)
        return proof, _g16_vk(comp, domain, params, gamma_io, s, alpha, beta, gamma, delta,
                              sk_enc), rec

    gamma_io_res, delta_mid_rows, zt_dinv = _g16_stream_crs(
        comp, domain, s.res, alpha.res, beta.res, gamma.inverse().res, delta.inverse().res,
        n_io)
    rec._sync(zt_dinv)
    rec.add("setup", "common", time.perf_counter() - t0)

    # one (nchunks, chunk) plan for every phase of every limb (delta_mid has
    # num_variables - primary rows, which can exceed M+1)
    n_aux = comp.num_variables - comp.primary_input_size
    nchunks, chunk = plan_chunks(max(domain.m + 1, n_aux), phase_rows, slab)
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0) if params.use_modswitch else 0

    t0 = time.perf_counter()
    aux_res = _as_batch(ctx, auxiliary).res
    a_full, b_full, H = prover_witness_map_chunked(comp, _as_batch(ctx, primary).res, aux_res,
                                                   domain)
    rec._sync(H)
    rec.add("prove", "witness_map", time.perf_counter() - t0)
    spow, s_step = _spow_table(ctx, s.res, chunk)

    limb_proofs, gamma_io_parts = [], []
    for l in range(L):
        lt = limb_tag if limb_tag is not None else l
        params_l = limb_params(params, l)
        ctx_l, ectx_l = params_l.ring, params_l.enc
        sk_l = limb_secret_key(ectx_l, sk_enc, l)
        keys = prng.split(prng.fold_in(key, l), 8)

        def sl(x):
            return limb_slice(ctx_l, x, l)

        t0 = time.perf_counter()
        alpha_enc = encode(ectx_l, sk_l, RingElem(ctx_l, sl(alpha.res)[None]), keys[0])[0]
        beta_enc = encode(ectx_l, sk_l, RingElem(ctx_l, sl(beta.res)[None]), keys[1])[0]
        gamma_io_parts.append(encode(ectx_l, sk_l, RingElem(ctx_l, sl(gamma_io_res)), keys[2]))
        rec._sync(gamma_io_parts[-1].c0)
        rec.add("setup", f"limb{lt}:small", time.perf_counter() - t0)

        # the phases: (name, CRS rows, plaintexts, key); s^i rows (scaled by
        # 1 or by Zt/delta) are regenerated, delta_mid rows made per row range
        phases = [
            ("s_pows", ("pow", RingElem.one(ctx_l).res), [sl(a_full), sl(b_full)], keys[3]),
            ("delta_ts", ("pow", sl(zt_dinv)), [sl(H)], keys[4]),
        ]
        if n_aux > 0:
            phases.append(("delta_mid", ("rows", lambda lo, hi: sl(delta_mid_rows(lo, hi))),
                           [sl(aux_res)], keys[5]))
        partials = _run_phases(params_l, sk_l, phases, nchunks, chunk, slab, sl(spow),
                               sl(s_step), rec, lt)

        t0 = time.perf_counter()
        finals = {name: [_finish_modswitch(e, max_level) for e in accs]
                  for name, accs in partials.items()}
        A_l = finals["s_pows"][0] + alpha_enc
        B_l = finals["s_pows"][1] + beta_enc
        C_l = finals["delta_ts"][0]
        if "delta_mid" in finals:
            C_l = C_l + finals["delta_mid"][0]
        rec._sync(C_l.c0)
        rec.add("prove", f"limb{lt}:finalize", time.perf_counter() - t0)
        limb_proofs.append((A_l, B_l, C_l))

    proof = Proof(*(_cat_limbs(ectx, [lp[i] for lp in limb_proofs]) for i in range(3)))
    gamma_io = _cat_limbs(ectx, gamma_io_parts, axis=1)
    return proof, _g16_vk(comp, domain, params, gamma_io, s, alpha, beta, gamma, delta,
                          sk_enc), rec


# ---------------------------------------------------------------------------
# streamed Rinocchio
# ---------------------------------------------------------------------------


def stream_prove_rinocchio(
    comp: CompiledR1CS,
    params: SnarkParams,
    primary,
    auxiliary,
    rng: np.random.Generator,
    key: prng.Key,
    *,
    slab: int = sd.DEFAULT_SLAB,
    phase_rows: int = 1 << 16,
    record: Optional[StreamRecord] = None,
):
    """Streamed Rinocchio setup + prove (`rinocchio.tcc:5-190` semantics).

    The row chunking of `stream_prove`; the prover runs 9 inner products
    against the two s-power phases (both regenerated from s: alpha_s_pows
    rows are alpha * s^i) and F against the lincheck phase.  ZK (d1..d3,
    F) is on when there are auxiliary inputs.  Draws from `rng` in the
    order of the JAX package's ``rinocchio.generator`` then ``prover``.

    Returns (proof, vk, record); vk carries a CRS-less ProvingKey stub."""
    rec = record if record is not None else StreamRecord(sync=False)
    ctx, ectx = params.ring, params.enc
    L = ctx.L
    M = max(comp.num_constraints, 1)
    n_io = comp.primary_input_size + 1
    n_aux = comp.num_variables - comp.primary_input_size
    use_zk = n_aux > 0

    t0 = time.perf_counter()
    domain = RootsDomain(ctx, M)
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    _, sk_enc = keygen(ectx, rng)
    alpha = RingElem.random_invertible_element(ctx, rng)
    r_v = RingElem.random_invertible_element(ctx, rng)
    r_w = RingElem.random_invertible_element(ctx, rng)
    r_y = r_v * r_w
    beta = RingElem.random_nonzero_element(ctx, rng)
    lincheck_rows, Zt = _rin_stream_crs(comp, domain, s.res, beta.res, r_v.res, r_w.res,
                                        r_y.res, n_io)
    beta_Zt = beta * RingElem(ctx, Zt)
    # the 3 F-shift CRS terms the prover uses
    shift_terms = RingElem.stack([beta_Zt * r_v, beta_Zt * r_w, beta_Zt * r_y])
    rec._sync(shift_terms.res)
    rec.add("setup", "common", time.perf_counter() - t0)

    t0 = time.perf_counter()
    if use_zk:
        d1, d2, d3 = (RingElem.random_invertible_element(ctx, rng) for _ in range(3))
    else:
        d1 = d2 = d3 = RingElem.zero(ctx)
    full, io, mid = _assignment_batches(ctx, primary, auxiliary)
    a_mid, b_mid, c_mid, H = witness_map_kernel_chunked(
        comp, full.res, io.res, mid.res, d1.res, d2.res, d3.res, domain, outputs="mid")
    del full, io, mid
    if use_zk:
        vecs = [zk_shifted(v, d.res, ctx.p) for v, d in ((a_mid, d1), (b_mid, d2), (c_mid, d3))]
    else:
        vecs = [a_mid, b_mid, c_mid]
    del a_mid, b_mid, c_mid
    vecs.append(H)
    aux_res = _as_batch(ctx, auxiliary).res
    rec._sync(H)
    rec.add("prove", "witness_map", time.perf_counter() - t0)

    nchunks, chunk = plan_chunks(max(domain.m + 1, n_aux), phase_rows, slab)
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0) if params.use_modswitch else 0
    spow, s_step = _spow_table(ctx, s.res, chunk)

    limb_elems = []  # per limb: A, A', B, B', C, C', D, D', F
    for l in range(L):
        params_l = limb_params(params, l)
        ctx_l, ectx_l = params_l.ring, params_l.enc
        sk_l = limb_secret_key(ectx_l, sk_enc, l)
        keys = prng.split(prng.fold_in(key, l), 8)

        def sl(x):
            return limb_slice(ctx_l, x, l)

        t0 = time.perf_counter()
        shifts_l = encode(ectx_l, sk_l, RingElem(ctx_l, sl(shift_terms.res)), keys[0])
        rec._sync(shifts_l.c0)
        rec.add("setup", f"limb{l}:small", time.perf_counter() - t0)

        main_pts = [sl(v) for v in vecs]
        phases = [
            ("s_pows", ("pow", RingElem.one(ctx_l).res), main_pts, keys[1]),
            ("alpha_s_pows", ("pow", sl(alpha.res)), main_pts, keys[2]),
        ]
        if use_zk:
            phases.append(("beta_prods", ("rows", lambda lo, hi: sl(lincheck_rows(lo, hi))),
                           [sl(aux_res)], keys[3]))
        partials = _run_phases(params_l, sk_l, phases, nchunks, chunk, slab, sl(spow),
                               sl(s_step), rec, l)

        t0 = time.perf_counter()
        # proof order: A, A', B, B', C, C', D, D' (rinocchio.hpp:117-146)
        elems = [_finish_modswitch(partials[name][i], max_level)
                 for i in range(4) for name in ("s_pows", "alpha_s_pows")]
        f = None
        if use_zk:
            f = _finish_modswitch(partials["beta_prods"][0], max_level)
            # the F shift terms multiply single fresh encodings (level 0)
            for i, d in enumerate((d1, d2, d3)):
                f = f + RingElem(ctx_l, sl(d.res)) * shifts_l[i]
        elems.append(f)
        rec._sync(elems[0].c0)
        rec.add("prove", f"limb{l}:finalize", time.perf_counter() - t0)
        limb_elems.append(elems)

    names = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime")
    cat = {n: _cat_limbs(ectx, [le[i] for le in limb_elems]) for i, n in enumerate(names)}
    F = _cat_limbs(ectx, [le[8] for le in limb_elems]) if use_zk else None
    proof = rinocchio.Proof(F=F, **cat)
    pk = rinocchio.ProvingKey(
        constraint_system=None, compiled=comp, domain=domain, params=params,
        s_pows=None, alpha_s_pows=None, beta_prods=None, beta_rv_ts=None, beta_rw_ts=None,
        beta_ry_ts=None, alpha_rv_ts=None, alpha_rw_ts=None, alpha_ry_ts=None, rv_vs=None,
        rw_ws=None, ry_ys=None,
    )
    vk = rinocchio.VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, r_v=r_v, r_w=r_w,
                                   r_y=r_y, sk_enc=sk_enc)
    return proof, vk, rec
