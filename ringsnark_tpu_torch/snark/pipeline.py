"""Prover cores on raw tensors: the whole prover as one function of arrays.

Port of ``ringsnark_tpu/snark/pipeline.py``.  The object-level provers in
groth16.py / rinocchio.py take keys and assignments as objects; these cores
take the compiled R1CS, the CRS as ``(c0, c1)`` pairs and the assignment
batches as tensors, and return the proof elements as ``(c0, c1)`` pairs:
plain functions, no compilation step, the unit a multi-device path shards.

The JAX package zero-pads every inner-product batch to a multiple of its
mesh quantum so the batch axis divides evenly over a mesh.  A zero
coefficient makes a term an exact no-op, so here the encodings past the
coefficient rows are left out instead, and the multi-device path
(``parallel/sharded.py``) splits the rows into uneven blocks.  Each core is
split into its witness map and its inner products (``groth16_ip_core``,
``rinocchio_ip_core``), which take the ``reduce`` hook where that path sums
its ranks' exact partial sums.
"""

from __future__ import annotations

import torch

from ..encoding.context import EncodingContext
from ..encoding.encoding import Encoding, finish_inner_product, mac_accumulate
from ..ops.modops import sub_mod
from ..reductions.r1cs_to_qrp import prover_witness_map_chunked, witness_map_kernel_chunked
from ..relations.r1cs import CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain

__all__ = ["groth16_core", "groth16_ip_core", "groth16_proof_levels", "rinocchio_core",
           "rinocchio_ip_core", "rinocchio_vectors", "zk_shifted"]


def groth16_proof_levels(ectx: EncodingContext, use_modswitch: bool):
    """Static result level of the three proof elements."""
    max_level = max(ectx.L_inner - ectx.floor_limbs, 0)
    lvl = max_level if use_modswitch else 0
    return (lvl, lvl, lvl)


def _ip(ectx: EncodingContext, pair, arr, ums: bool, reduce=None) -> Encoding:
    """<E, arr> over the rows of `arr`: the encodings past them would meet
    zero coefficients and are left out.  `reduce`, where given, takes the
    exact int64 sums (``mac_accumulate``) before they are reduced mod Q_j
    and switched down: a multi-device path sums its ranks' partial sums
    there."""
    c0, c1 = pair
    n = arr.shape[0]
    assert n <= c0.shape[0], (n, c0.shape[0])
    accs = mac_accumulate(Encoding(ectx, c0[:n], c1[:n], 0), RingElem(ectx.ring, arr))
    if reduce is not None:
        accs = reduce(accs)
    return finish_inner_product(ectx, accs, 0, ums)


def _pairs(encs):
    return tuple((e.c0, e.c1) for e in encs)


def groth16_ip_core(ectx: EncodingContext, crs: dict, a_full, b_full, H, aux_values,
                    ums: bool, reduce=None):
    """The inner-product half of the ringGroth16 prover (after its witness
    map):

      A = <E(s^i), a> + E(alpha),  B = <E(s^i), b> + E(beta),
      C = <E(Z(s) s^i / delta), H> + <E(mid_k / delta), aux>,

    the last term only where `aux_values` is not None.  crs: {"s_pows",
    "delta_ts", "delta_mid" (or None), "alpha", "beta"} -> (c0, c1) pairs.
    Returns ((A_c0, A_c1), (B_c0, B_c1), (C_c0, C_c1)) at the static levels
    of `groth16_proof_levels`; `reduce` as in `_ip`."""

    def enc(pair):
        return Encoding(ectx, pair[0], pair[1], 0)

    a_enc = _ip(ectx, crs["s_pows"], a_full, ums, reduce) + enc(crs["alpha"])
    b_enc = _ip(ectx, crs["s_pows"], b_full, ums, reduce) + enc(crs["beta"])
    c_enc = _ip(ectx, crs["delta_ts"], H, ums, reduce)
    if aux_values is not None:
        c_enc = c_enc + _ip(ectx, crs["delta_mid"], aux_values, ums, reduce)
    return _pairs((a_enc, b_enc, c_enc))


def groth16_core(comp: CompiledR1CS, crs: dict, p_res, a_res, domain: RootsDomain,
                 ectx: EncodingContext, ums: bool):
    """The full ringGroth16 prover on tensors: the non-ZK witness map
    (d1 = d2 = d3 = 0) of the primary and auxiliary assignment batches
    (``[rows, L, n]``, see `_pa_batches`; a_res may have 0 rows), then
    `groth16_ip_core`.  a_full / b_full have M rows: the s^M term's
    coefficient is zero.
    """
    assert crs["s_pows"][0].shape[0] == domain.m + 1
    a_full, b_full, H = prover_witness_map_chunked(comp, p_res, a_res, domain)
    return groth16_ip_core(ectx, crs, a_full, b_full, H,
                           a_res if a_res.shape[0] > 0 else None, ums)


def zk_shifted(coeffs, dr, p):
    """Coefficients of poly + d * Z for Z = X^M - 1: [a_0 - d, a_1, ...,
    a_{M-1}, d].  coeffs: [M, L, n]; dr: [L, 1] or [L, n]."""
    head = sub_mod(coeffs[0], dr, p)[None]
    tail = dr[None].expand(1, *coeffs.shape[1:])
    return torch.cat([head, coeffs[1:], tail], dim=0)


def rinocchio_vectors(comp: CompiledR1CS, z_full, z_mid, d1r, d2r, d3r, domain: RootsDomain,
                      use_zk: bool) -> list:
    """The Rinocchio prover's four coefficient vectors [a, b, c, H]: the mid
    legs of the ZK witness map (the io assignment batch the JAX core also
    takes is not needed), with the shifts d*Z folded into a, b and c under
    `use_zk`."""
    p = comp.ctx.p
    a_mid, b_mid, c_mid, H = witness_map_kernel_chunked(
        comp, z_full, None, z_mid, d1r, d2r, d3r, domain, outputs="mid")
    if use_zk:
        return [zk_shifted(a_mid, d1r, p), zk_shifted(b_mid, d2r, p),
                zk_shifted(c_mid, d3r, p), H]
    return [a_mid, b_mid, c_mid, H]


def rinocchio_ip_core(ectx: EncodingContext, crs: dict, vecs: list, aux_values, ums: bool,
                      reduce=None):
    """The Rinocchio prover's inner products: each vector of `vecs` against
    E(s^i) and E(alpha s^i), and F's <E(beta prods), aux> where `aux_values`
    is not None (F's d-shift terms multiply single fresh encodings and stay
    in the object layer).  crs: {"s_pows", "alpha_s_pows", "beta_prods" (or
    None)} -> (c0, c1).  Returns (8 (c0, c1) pairs in proof order, F's pair
    or None); `reduce` as in `_ip`."""
    outs = []
    for v in vecs:
        outs.append(_ip(ectx, crs["s_pows"], v, ums, reduce))
        outs.append(_ip(ectx, crs["alpha_s_pows"], v, ums, reduce))
    f = None
    if aux_values is not None:
        f = _ip(ectx, crs["beta_prods"], aux_values, ums, reduce)
    return _pairs(outs), (None if f is None else (f.c0, f.c1))


def rinocchio_core(comp: CompiledR1CS, crs: dict, z_full, z_mid, aux_values,
                   d1r, d2r, d3r, domain: RootsDomain, ectx: EncodingContext,
                   ums: bool, use_zk: bool):
    """The Rinocchio prover's 8 main proof elements and the unshifted F on
    tensors: `rinocchio_vectors`, then `rinocchio_ip_core` (F where
    `aux_values` has rows)."""
    vecs = rinocchio_vectors(comp, z_full, z_mid, d1r, d2r, d3r, domain, use_zk)
    has_aux = aux_values is not None and aux_values.shape[0] > 0
    return rinocchio_ip_core(ectx, crs, vecs, aux_values if has_aux else None, ums)
