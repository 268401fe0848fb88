"""Seeded-CRS ringGroth16: resident c0, c1 regenerated from a key, slab MAC.

Port of ``ringsnark_tpu/snark/seeded.py`` (its generic "u64"/"dense" MAC;
the TPU's byte-plane MXU MAC is not ported).  In symmetric BGV the second
ciphertext component c1 = a is uniform, so the three large CRS batches
(E(s^i), E(mid/delta), E(Z(s) s^i/delta)) keep only c0 and regenerate c1
from their key inside the prover's inner products.  That halves the CRS:
at Rq N=8192, M=2^16, N'=16384, L'=4 the resident CRS would be 96 GiB, the
seeded one about 48 GiB.

PRNG convention (the JAX package's, so a JAX seeded keypair proves here bit
for bit): slab i of a batch is encrypted with ``fold_in(key, i)`` as one
draw of `slab` rows, so its c1 is
``_sample_uniform(ctx, split(fold_in(key, i))[0], (slab,))``.  The slab is
the PRNG's unit: another slab size gives other ciphertexts.

Memory: every pass runs over row sub-chunks of a slab (``_sub_rows``),
which threefry's partitionable draws allow (a row range of a draw has the
bits it has in the whole draw).  The plaintext NTT runs per sub-chunk
inside the loop, in ``encode_seeded`` and in the MAC, never over the whole
batch (at full size one plaintext batch in NTT form would be 16 GiB).  c0
holds only the batch's rows; the JAX package pads it to whole slabs with
encryptions of zero that no inner product reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..encoding import Encoding, bgv, encode, finish_inner_product, keygen
from ..encoding.context import EncodingContext
from ..encoding.mac import Drawn, mac_rows
from ..reductions.r1cs_to_qrp import (
    _pa_batches,
    prover_witness_map_chunked,
    r1cs_to_qrp_instance_map_with_evaluation,
)
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem
from ..rings.elem import RingElem
from ..utils import prng
from ..utils.domain import RootsDomain
from ..utils.poly_arr import ring_batch_scale
from .api import KeyPair, SnarkParams
from .groth16 import Proof, VerificationKey, _compiled_and_system

__all__ = [
    "SeededEncoding",
    "SeededProvingKey",
    "encode_seeded",
    "seeded_inner_product",
    "generator_seeded",
    "prover_seeded",
    "DEFAULT_SLAB",
]

DEFAULT_SLAB = 4096
# Residues per row sub-chunk: 128 MiB of int32 a batch (512 rows at L = 1,
# L' = 4, N' = 16384).
_SUB_ELEMS = 1 << 25


def _sub_rows(ctx: EncodingContext) -> int:
    return max(1, _SUB_ELEMS // (ctx.L * ctx.L_inner * ctx.n_inner))


def _slab_c1_key(key: prng.Key, i: int) -> prng.Key:
    """The c1 (= uniform a) key of slab i: bgv.sample_a_e's split of fold_in(key, i)."""
    return prng.split(prng.fold_in(key, i))[0]


def _sub_chunks(B: int, slab: int, sub: int):
    """(slab index, lo, hi) over rows [0, B): slab by slab, `sub` rows at most."""
    for i in range(-(-B // slab)):
        end = min(B, (i + 1) * slab)
        for lo in range(i * slab, end, sub):
            yield i, lo, min(lo + sub, end)


@dataclass
class SeededEncoding:
    """A CRS encoding batch with only c0 resident.

    c0: int32[batch, L, L', N']; the c1 of slab i is regenerated from `key`
    (module docstring).
    """

    ctx: EncodingContext
    c0: Any
    key: prng.Key
    slab: int
    batch: int

    def size_in_bits(self) -> int:
        """Stored size: c0 only (c1 is the key)."""
        return self.ctx.size_in_bits(self.batch) // 2

    @property
    def nslab(self) -> int:
        return -(-self.batch // self.slab)

    def expand(self) -> Encoding:
        """The full (c0, c1) Encoding (tests and small sizes)."""
        c1 = torch.empty_like(self.c0)
        for i, lo, hi in _sub_chunks(self.batch, self.slab, _sub_rows(self.ctx)):
            c1[lo:hi] = bgv._sample_uniform(self.ctx, _slab_c1_key(self.key, i), (self.slab,),
                                            rows=(lo - i * self.slab, hi - i * self.slab))
        return Encoding(self.ctx, self.c0, c1, 0)


def encode_seeded(ctx: EncodingContext, sk, rs: RingElem, key: prng.Key,
                  slab: int = DEFAULT_SLAB) -> SeededEncoding:
    """Encrypt a RingElem batch slab by slab (slab i with fold_in(key, i)),
    keeping only c0 and the key: each sub-chunk's c0 is written into its
    rows of the batch, and its c1 is never written."""
    slots = rs.res
    B = slots.shape[0]
    slab = min(slab, max(8, B))
    c0 = torch.empty((B, ctx.L, ctx.L_inner, ctx.n_inner), dtype=torch.int32, device=ctx.device)
    for i, lo, hi in _sub_chunks(B, slab, _sub_rows(ctx)):
        bgv.encrypt(ctx, sk, slots[lo:hi], prng.fold_in(key, i), draw_rows=slab,
                    lo=lo - i * slab, c0_out=c0[lo:hi])
    return SeededEncoding(ctx=ctx, c0=c0, key=key, slab=slab, batch=B)


def _mac_accs(senc: SeededEncoding, pts):
    """The exact int64 sums sum_i c[i] * pt[i] (each product reduced mod Q_j)
    of one seeded batch against several plaintext batches, at level 0 and
    before the final reduction: a Python loop over slabs and their row
    sub-chunks, each one `mac_rows` for all plaintexts with its rows of c1
    `Drawn` from the slab's key (on the card, in the kernel's registers)."""
    ctx = senc.ctx
    acc_shape = (ctx.L, ctx.L_inner, ctx.n_inner)
    accs = [(torch.zeros(acc_shape, dtype=torch.int64, device=ctx.device),
             torch.zeros(acc_shape, dtype=torch.int64, device=ctx.device)) for _ in pts]
    rows = max(pt.shape[0] for pt in pts)  # rows past a plaintext's end are zero terms
    for i, lo, hi in _sub_chunks(rows, senc.slab, _sub_rows(ctx)):
        c1 = Drawn(_slab_c1_key(senc.key, i), (senc.slab,),
                   (lo - i * senc.slab, hi - i * senc.slab))
        live = [(pt, acc) for pt, acc in zip(pts, accs) if pt.shape[0] > lo]
        mac_rows(ctx, 0, senc.c0[lo:hi], c1,
                 [bgv.plain_to_inner_ntt(ctx, pt[lo:hi], 0) for pt, _ in live],
                 [acc for _, acc in live])
    return accs


def seeded_inner_product(senc: SeededEncoding, pts: list, use_modswitch: bool = True) -> list:
    """Inner products of one seeded CRS batch against several plaintext
    batches ([B_j, L, n] slot arrays, B_j <= batch); the same schedule and
    result as `encoding.inner_product` on the expanded CRS: the level-0
    sums, then the modswitch chain down to the floor."""
    ctx = senc.ctx
    for pt in pts:
        assert pt.shape[0] <= senc.batch, (tuple(pt.shape), senc.batch)
    return [finish_inner_product(ctx, accs, 0, use_modswitch) for accs in _mac_accs(senc, pts)]


@dataclass
class SeededProvingKey:
    """groth16 CRS with the three big batches seeded (groth16.hpp:10-48)."""

    compiled: CompiledR1CS
    domain: RootsDomain
    params: SnarkParams
    alpha: Encoding
    beta: Encoding
    s_pows: SeededEncoding
    gamma_io: Encoding
    delta_mid: Optional[SeededEncoding]
    delta_ts: SeededEncoding
    pk_enc: Any = None
    constraint_system: Optional[R1CSConstraintSystem] = None  # None on the array path

    def size_in_bits(self) -> int:
        return sum(e.size_in_bits() for e in (self.alpha, self.beta, self.gamma_io, self.s_pows,
                                              self.delta_mid, self.delta_ts)
                   if e is not None)

    def c0_bytes(self) -> int:
        """Device bytes of the resident CRS (seeded batches: c0 only)."""
        total = 0
        for e in (self.alpha, self.beta, self.gamma_io):
            total += (e.c0.numel() + e.c1.numel()) * e.c0.element_size()
        for e in (self.s_pows, self.delta_mid, self.delta_ts):
            if e is not None:
                total += e.c0.numel() * e.c0.element_size()
        return total


def generator_seeded(cs: R1CSConstraintSystem | CompiledR1CS, params: SnarkParams,
                     rng: np.random.Generator, key: prng.Key,
                     slab: int = DEFAULT_SLAB) -> KeyPair:
    """Trusted setup with seeded CRS batches (`groth16.tcc:5-67`), drawing
    from `rng` and `key` exactly as the JAX package's `generator_seeded`.
    `cs` is an R1CSConstraintSystem or a CompiledR1CS."""
    ctx = params.ring
    comp, cs_obj = _compiled_and_system(cs, ctx)
    primary_size = comp.primary_input_size
    n_aux = comp.num_variables - primary_size
    domain = RootsDomain(ctx, max(comp.num_constraints, 1))
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    qrp = r1cs_to_qrp_instance_map_with_evaluation(comp, s, domain)

    pk_enc, sk_enc = keygen(params.enc, rng)
    alpha = RingElem.random_invertible_element(ctx, rng)
    beta = RingElem.random_invertible_element(ctx, rng)
    gamma = RingElem.random_invertible_element(ctx, rng)
    delta = RingElem.random_invertible_element(ctx, rng)
    gamma_inv = gamma.inverse()
    delta_inv = delta.inverse()

    s_pows_ring = qrp.Ht  # [M+1, L, 1]
    delta_ts_ring = ring_batch_scale(ring_batch_scale(s_pows_ring, qrp.Zt), delta_inv)
    combo = ring_batch_scale(qrp.At, beta) + ring_batch_scale(qrp.Bt, alpha) + qrp.Ct
    n_io = primary_size + 1
    gamma_io_ring = ring_batch_scale(RingElem(ctx, combo.res[:n_io]), gamma_inv)

    enc = params.enc
    keys = prng.split(key, 6)
    alpha_enc = encode(enc, sk_enc, RingElem.stack([alpha]), keys[0])[0]
    beta_enc = encode(enc, sk_enc, RingElem.stack([beta]), keys[1])[0]
    s_pows = encode_seeded(enc, sk_enc, s_pows_ring, keys[2], slab)
    gamma_io = encode(enc, sk_enc, gamma_io_ring, keys[3])
    delta_mid = None
    if n_aux > 0:
        delta_mid_ring = ring_batch_scale(RingElem(ctx, combo.res[n_io:]), delta_inv)
        delta_mid = encode_seeded(enc, sk_enc, delta_mid_ring, keys[4], slab)
    delta_ts = encode_seeded(enc, sk_enc, delta_ts_ring, keys[5], slab)

    pk = SeededProvingKey(
        compiled=comp, domain=domain, params=params,
        alpha=alpha_enc, beta=beta_enc, s_pows=s_pows, gamma_io=gamma_io,
        delta_mid=delta_mid, delta_ts=delta_ts, pk_enc=pk_enc, constraint_system=cs_obj,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma,
                         delta=delta, sk_enc=sk_enc)
    return KeyPair(pk=pk, vk=vk)


def prover_seeded(pk: SeededProvingKey, primary_input, auxiliary_input) -> Proof:
    """Prove (`groth16.tcc:69-115`, non-ZK like the reference): the
    prover-mode witness map, then three slab MACs (E(s^i) shared by A and B;
    E(Z(s) s^i/delta) with H; E(mid/delta) with the auxiliary input) and the
    modswitch chain.  Verified by `groth16.verifier` with the keypair's vk."""
    ctx = pk.params.ring
    ums = pk.params.use_modswitch
    p_res, a_res = _pa_batches(ctx, primary_input, auxiliary_input)
    a_full, b_full, H = prover_witness_map_chunked(pk.compiled, p_res, a_res, pk.domain)

    A_ip, B_ip = seeded_inner_product(pk.s_pows, [a_full, b_full], ums)
    del a_full, b_full
    (C_ip,) = seeded_inner_product(pk.delta_ts, [H], ums)
    del H
    a_enc = A_ip + pk.alpha
    b_enc = B_ip + pk.beta
    c_enc = C_ip
    if a_res.shape[0] > 0 and pk.delta_mid is not None:
        (mid_ip,) = seeded_inner_product(pk.delta_mid, [a_res], ums)
        c_enc = c_enc + mid_ip
    return Proof(A=a_enc, B=b_enc, C=c_enc)
