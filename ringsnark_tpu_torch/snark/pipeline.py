"""Prover cores on raw tensors: the whole prover as one function of arrays.

Port of ``ringsnark_tpu/snark/pipeline.py``.  The object-level provers in
groth16.py / rinocchio.py take keys and assignments as objects; these cores
take the compiled R1CS, the CRS as ``(c0, c1)`` pairs and the assignment
batches as tensors, and return the proof elements as ``(c0, c1)`` pairs:
plain functions, no compilation step, the unit a multi-device path shards.

The JAX package zero-pads every inner-product batch to a multiple of its
mesh quantum so the batch axis divides evenly over a mesh.  A zero
coefficient makes a term an exact no-op, so here the encodings past the
coefficient rows are left out instead; a multi-device path pads to whatever
its own sharding needs.
"""

from __future__ import annotations

import torch

from ..encoding.context import EncodingContext
from ..encoding.encoding import Encoding, inner_product
from ..ops.modops import sub_mod
from ..reductions.r1cs_to_qrp import prover_witness_map_chunked, witness_map_kernel_chunked
from ..relations.r1cs import CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain

__all__ = ["groth16_core", "groth16_proof_levels", "rinocchio_core", "zk_shifted"]


def groth16_proof_levels(ectx: EncodingContext, use_modswitch: bool):
    """Static result level of the three proof elements."""
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0)
    lvl = max_level if use_modswitch else 0
    return (lvl, lvl, lvl)


def _ip(ectx: EncodingContext, pair, arr, ums: bool) -> Encoding:
    """<E, arr> over the rows of `arr`: the encodings past them would meet
    zero coefficients and are left out."""
    c0, c1 = pair
    n = arr.shape[0]
    assert n <= c0.shape[0], (n, c0.shape[0])
    return inner_product(Encoding(ectx, c0[:n], c1[:n], 0), RingElem(ectx.ring, arr),
                         use_modswitch=ums)


def _pairs(encs):
    return tuple((e.c0, e.c1) for e in encs)


def groth16_core(comp: CompiledR1CS, crs: dict, p_res, a_res, domain: RootsDomain,
                 ectx: EncodingContext, ums: bool):
    """The full ringGroth16 prover on tensors: the non-ZK witness map
    (d1 = d2 = d3 = 0) of the primary and auxiliary assignment batches
    (``[rows, L, n]``, see `_pa_batches`; a_res may have 0 rows), then

      A = <E(s^i), a> + E(alpha),  B = <E(s^i), b> + E(beta),
      C = <E(Z(s) s^i / delta), H> + <E(mid_k / delta), aux>.

    crs: {"s_pows", "delta_ts", "delta_mid" (or None), "alpha", "beta"} ->
    (c0, c1) pairs.  Returns ((A_c0, A_c1), (B_c0, B_c1), (C_c0, C_c1)) at
    the static levels of `groth16_proof_levels`.  a_full / b_full have M
    rows: the s^M term's coefficient is zero.
    """
    assert crs["s_pows"][0].shape[0] == domain.m + 1
    a_full, b_full, H = prover_witness_map_chunked(comp, p_res, a_res, domain)

    def enc(pair):
        return Encoding(ectx, pair[0], pair[1], 0)

    a_enc = _ip(ectx, crs["s_pows"], a_full, ums) + enc(crs["alpha"])
    b_enc = _ip(ectx, crs["s_pows"], b_full, ums) + enc(crs["beta"])
    c_enc = _ip(ectx, crs["delta_ts"], H, ums)
    if a_res.shape[0] > 0:
        c_enc = c_enc + _ip(ectx, crs["delta_mid"], a_res, ums)
    return _pairs((a_enc, b_enc, c_enc))


def zk_shifted(coeffs, dr, p):
    """Coefficients of poly + d * Z for Z = X^M - 1: [a_0 - d, a_1, ...,
    a_{M-1}, d].  coeffs: [M, L, n]; dr: [L, 1] or [L, n]."""
    head = sub_mod(coeffs[0], dr, p)[None]
    tail = dr[None].expand(1, *coeffs.shape[1:])
    return torch.cat([head, coeffs[1:], tail], dim=0)


def rinocchio_core(comp: CompiledR1CS, crs: dict, z_full, z_mid, aux_values,
                   d1r, d2r, d3r, domain: RootsDomain, ectx: EncodingContext,
                   ums: bool, use_zk: bool):
    """The Rinocchio prover's 8 main proof elements and the unshifted F on
    tensors (F's d-shift terms multiply single fresh encodings and stay in
    the object layer).

    crs: {"s_pows", "alpha_s_pows", "beta_prods" (or None)} -> (c0, c1).
    With `use_zk` the shifts d*Z are folded into the coefficient vectors of
    A, B and C.  Only the mid legs of the witness map are proof elements, so
    the io assignment batch the JAX core also takes is not an argument.
    Returns (8 (c0, c1) pairs in proof order, F's pair or None).
    """
    p = comp.ctx.p
    a_mid, b_mid, c_mid, H = witness_map_kernel_chunked(
        comp, z_full, None, z_mid, d1r, d2r, d3r, domain, outputs="mid")
    if use_zk:
        vecs = [zk_shifted(a_mid, d1r, p), zk_shifted(b_mid, d2r, p),
                zk_shifted(c_mid, d3r, p), H]
    else:
        vecs = [a_mid, b_mid, c_mid, H]
    outs = []
    for v in vecs:
        outs.append(_ip(ectx, crs["s_pows"], v, ums))
        outs.append(_ip(ectx, crs["alpha_s_pows"], v, ums))
    f = None
    if aux_values is not None and aux_values.shape[0] > 0:
        f = _ip(ectx, crs["beta_prods"], aux_values, ums)
    return _pairs(outs), (None if f is None else (f.c0, f.c1))
