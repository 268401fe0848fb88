"""Sharded provers: ringGroth16 and Rinocchio over a ('limb', ['coeff',] 'data') mesh.

Port of ``ringsnark_tpu/parallel/sharded.py``.  Each rank holds the CRS
rows of its 'data' block and the outer limbs of its 'limb' block
(``crs_sharding``); the witness map is computed whole on every rank (or
coefficient-sharded over 'coeff', ``witness_sharded.py``) and sliced to
the same rows and limbs.  A rank multiply-accumulates its rows into the
exact int64 sums of ``encoding.mac_accumulate`` and those are summed over
'data' (``all_reduce``) **before** the final reduction mod Q_j and the
modswitch chain: modswitch rounds, so switching partial sums would not give
the switched sum.  Every product is reduced mod Q_j and the sums are exact
in 64 bits, so any partition of the rows gives the same bits.  The limb
blocks are then gathered over 'limb' and every rank returns the same
``Proof``, bit-identical to the single-device prover's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..encoding.context import EncodingContext
from ..encoding.encoding import Encoding
from ..ops.modops import add_mod
from ..reductions.r1cs_to_qrp import (
    _assignment_batches,
    _pa_batches,
    prover_witness_map_chunked,
)
from ..rings.elem import RingElem
from ..snark.pipeline import (
    groth16_ip_core,
    groth16_proof_levels,
    rinocchio_ip_core,
    rinocchio_vectors,
)
from ..snark.streamed import limb_enc_context
from .mesh import axis_group, axis_size, block, crs_sharding

__all__ = [
    "shard_groth16_inputs",
    "groth16_prove_sharded",
    "shard_rinocchio_inputs",
    "rinocchio_prove_sharded",
]


def _shard_crs(mesh, batches: dict, singles: dict):
    """This rank's blocks of the CRS: batches [B, L, L', N'] split over
    (data, limb), single encodings [L, L', N'] over limb.  Returns (crs
    dict of (c0, c1) pairs, rows: the row slice of each batch, limbs)."""
    sh = crs_sharding(mesh)
    assert axis_size(mesh, "limb") <= batches["s_pows"].c0.shape[1], "more limb ranks than limbs"
    crs, rows, limbs = {}, {}, None
    for name, enc in batches.items():
        if enc is None:
            crs[name] = None
            continue
        sl = sh.slices(enc.c0.shape)
        rows[name], limbs = sl
        crs[name] = (enc.c0[sl], enc.c1[sl])
    for name, enc in singles.items():
        crs[name] = (enc.c0[limbs], enc.c1[limbs])
    return crs, rows, limbs


def shard_groth16_inputs(pk, mesh):
    """The ringGroth16 CRS blocks of this rank: (crs, rows, limbs), see
    `_shard_crs`."""
    return _shard_crs(mesh, {"s_pows": pk.s_pows, "delta_ts": pk.delta_ts,
                             "delta_mid": pk.delta_mid},
                      {"alpha": pk.alpha, "beta": pk.beta})


def shard_rinocchio_inputs(pk, mesh):
    """The Rinocchio CRS blocks of this rank: (crs, rows, limbs)."""
    return _shard_crs(mesh, {"s_pows": pk.s_pows, "alpha_s_pows": pk.alpha_s_pows,
                             "beta_prods": pk.beta_prods}, {})


def _sum_over_data(mesh):
    """The `reduce` hook of the cores: the exact int64 partial sums of this
    rank's rows, summed over 'data'."""
    group = axis_group(mesh, "data")

    def reduce(accs):
        for a in accs:
            dist.all_reduce(a, op=dist.ReduceOp.SUM, group=group)
        return accs

    return reduce


def _gather_limbs(mesh, ectx: EncodingContext, pair, level: int) -> Encoding:
    """The whole [L, L', N'] element from the limb blocks of the 'limb'
    group (padded to the longest block for the gather, then trimmed)."""
    parts = axis_size(mesh, "limb")
    group = axis_group(mesh, "limb")
    L = ectx.ring.L
    width = -(-L // parts)
    out = []
    for c in pair:
        buf = torch.zeros((width, *c.shape[1:]), dtype=c.dtype, device=c.device)
        buf[:c.shape[0]] = c
        blocks = [torch.empty_like(buf) for _ in range(parts)]
        dist.all_gather(blocks, buf, group=group)
        out.append(torch.cat([b[:block(L, parts, i).stop - block(L, parts, i).start]
                              for i, b in enumerate(blocks)], dim=0))
    return Encoding(ectx, out[0], out[1], level)


def groth16_prove_sharded(pk, primary_input, auxiliary_input, mesh):
    """The ringGroth16 prover over the mesh; every rank of the mesh calls it
    with the same key and assignment and returns the same Proof, equal bit
    for bit to ``groth16.prover``'s.  On a mesh with a 'coeff' dimension
    (and M >= 2 * its size) the witness map's M/2M NTTs run
    coefficient-sharded (`witness_sharded.make_witness_map_sharded`)."""
    from ..snark.groth16 import Proof

    ctx, ectx = pk.params.ring, pk.params.enc
    ums = pk.params.use_modswitch
    M = pk.domain.m
    p_res, a_res = _pa_batches(ctx, primary_input, auxiliary_input)
    if "coeff" in mesh.mesh_dim_names and M >= 2 * axis_size(mesh, "coeff"):
        from .witness_sharded import make_witness_map_sharded

        full, io, mid = _assignment_batches(ctx, primary_input, auxiliary_input)
        wmap = make_witness_map_sharded(pk.compiled, pk.domain, mesh)
        a_io, b_io, _, a_mid, b_mid, _, _, H = wmap(full.res, io.res, mid.res)
        a_full, b_full = add_mod(a_io, a_mid, ctx.p), add_mod(b_io, b_mid, ctx.p)
    else:
        a_full, b_full, H = prover_witness_map_chunked(pk.compiled, p_res, a_res, pk.domain)
    crs, rows, limbs = shard_groth16_inputs(pk, mesh)
    aux = a_res[rows["delta_mid"], limbs] if a_res.shape[0] > 0 else None
    outs = groth16_ip_core(
        limb_enc_context(ectx, limbs), crs, a_full[rows["s_pows"], limbs],
        b_full[rows["s_pows"], limbs], H[rows["delta_ts"], limbs], aux, ums,
        reduce=_sum_over_data(mesh))
    la, lb, lc = groth16_proof_levels(ectx, ums)
    A, B, C = (_gather_limbs(mesh, ectx, pair, lvl) for pair, lvl in zip(outs, (la, lb, lc)))
    return Proof(A=A, B=B, C=C)


def rinocchio_prove_sharded(pk, primary_input, auxiliary_input, mesh, rng=None):
    """The Rinocchio prover over a ('limb', 'data') mesh: its 10 inner
    products (`rinocchio.tcc:106-163`) on this rank's CRS rows and limbs,
    summed over 'data' and gathered over 'limb'.  d1, d2, d3 are drawn from
    `rng` exactly as ``rinocchio.prover`` draws them, so every rank given
    the same seed returns the same Proof, equal bit for bit to the
    single-device one; F's d-shift terms stay in the object layer."""
    from ..snark.rinocchio import _PROOF_MAIN, Proof

    ctx, ectx = pk.params.ring, pk.params.enc
    ums = pk.params.use_modswitch
    rng = rng or np.random.default_rng()
    use_zk = len(auxiliary_input) > 0
    if use_zk:
        d1, d2, d3 = (RingElem.random_invertible_element(ctx, rng) for _ in range(3))
    else:
        d1 = d2 = d3 = RingElem.zero(ctx)
    full, _, mid = _assignment_batches(ctx, primary_input, auxiliary_input)
    vecs = rinocchio_vectors(pk.compiled, full.res, mid.res, d1.res, d2.res, d3.res, pk.domain,
                             use_zk)
    crs, rows, limbs = shard_rinocchio_inputs(pk, mesh)
    assert rows["s_pows"] == rows["alpha_s_pows"], (rows["s_pows"], rows["alpha_s_pows"])
    aux = None
    if use_zk and pk.beta_prods is not None:
        aux = mid.res[-len(auxiliary_input):][rows["beta_prods"], limbs]
    main, f = rinocchio_ip_core(limb_enc_context(ectx, limbs), crs,
                                [v[rows["s_pows"], limbs] for v in vecs], aux, ums,
                                reduce=_sum_over_data(mesh))
    level = max(ectx.L_inner - ectx.floor_limbs, 0) if ums else 0
    elems = {n: _gather_limbs(mesh, ectx, pair, level) for n, pair in zip(_PROOF_MAIN, main)}
    f_enc = None
    if f is not None:
        f_enc = _gather_limbs(mesh, ectx, f, level)
        # the shift terms multiply single fresh encodings (level 0)
        f_enc = f_enc + d1 * pk.beta_rv_ts
        f_enc = f_enc + d2 * pk.beta_rw_ts
        f_enc = f_enc + d3 * pk.beta_ry_ts
    return Proof(F=f_enc, **elems)
