"""ringGroth16: Groth16 over rings with linear-only encodings.

Port of ``ringsnark_tpu/snark/groth16.py`` (the resident-CRS path): CRS of
E(alpha), E(beta), E(s^i), E((beta A_k + alpha B_k + C_k)/gamma) for io,
the same /delta for mid wires, E(Z(s) s^i / delta); 3-element proof
(A, B, C); the designated verifier checks
A*B = alpha*beta + gamma*f_io + delta*C.

The prover is non-ZK, as in the reference (`use_zk = false` there) and the
JAX package.  The generator takes the ring secrets from a numpy `rng`
and the encryption randomness from a threefry key (``utils/prng.py``),
both drawn as the JAX package draws them: one ``(rng seed, key)`` gives the
JAX package's CRS bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..encoding import Encoding, encode, decode, keygen
from ..ops.modops import dot_mod
from ..reductions.r1cs_to_qrp import (
    _interp,
    _pa_batches,
    r1cs_to_qrp_instance_map_with_evaluation,
)
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain
from ..utils import prng
from ..utils.poly_arr import eval_coeffs_at, ring_batch_scale
from .api import KeyPair, SnarkParams
from .pipeline import groth16_core, groth16_proof_levels

__all__ = ["ProvingKey", "VerificationKey", "ProcessedVerificationKey", "Proof",
           "generator", "prover", "verifier", "verifier_process", "online_verifier"]


@dataclass
class ProvingKey:
    """CRS (groth16.hpp:10-48)."""

    compiled: CompiledR1CS
    domain: RootsDomain
    params: SnarkParams
    alpha: Encoding  # E(alpha)
    beta: Encoding  # E(beta)
    s_pows: Encoding  # [M+1] E(s^i)
    gamma_io: Encoding  # [primary+1] E((beta A_k + alpha B_k + C_k)/gamma)
    delta_mid: Optional[Encoding]  # [aux] same with /delta
    delta_ts: Encoding  # [M+1] E(Z(s) s^i / delta)
    pk_enc: Any = None
    constraint_system: Optional[R1CSConstraintSystem] = None  # None on the array path

    def size_in_bits(self) -> int:
        return sum(e.size_in_bits() for e in (self.alpha, self.beta, self.s_pows,
                                              self.gamma_io, self.delta_mid, self.delta_ts)
                   if e is not None)


@dataclass
class VerificationKey:
    pk: ProvingKey
    s: RingElem
    alpha: RingElem
    beta: RingElem
    gamma: RingElem
    delta: RingElem
    sk_enc: Any

    def size_in_bits(self) -> int:
        return self.pk.size_in_bits()


@dataclass
class Proof:
    """3 encodings (groth16.hpp:106-116)."""

    A: Encoding
    B: Encoding
    C: Encoding

    def size_in_bits(self) -> int:
        return self.A.size_in_bits() + self.B.size_in_bits() + self.C.size_in_bits()


def _compiled_and_system(cs, ctx):
    """(compiled, constraint system or None) of a generator's `cs` argument."""
    if isinstance(cs, CompiledR1CS):
        return cs, None
    return cs.compile(ctx), cs


def generator(
    cs: R1CSConstraintSystem | CompiledR1CS,
    params: SnarkParams,
    rng: np.random.Generator,
    key,
) -> KeyPair:
    """Trusted setup (`groth16.tcc:5-67`).

    `cs` may be an R1CSConstraintSystem (frontend path) or a CompiledR1CS
    (array path for benchmark-scale synthetic instances).
    """
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

    # (beta A_k + alpha B_k + C_k) / gamma for io (incl. constant column),
    # the same with /delta for mid wires
    combo = ring_batch_scale(qrp.At, beta) + ring_batch_scale(qrp.Bt, alpha) + qrp.Ct
    n_io = primary_size + 1
    gamma_io_ring = ring_batch_scale(RingElem(ctx, combo.res[:n_io]), gamma_inv)

    enc = params.enc
    keys = prng.split(key, 6)
    alpha_enc = encode(enc, sk_enc, RingElem.stack([alpha]), keys[0])[0]
    beta_enc = encode(enc, sk_enc, RingElem.stack([beta]), keys[1])[0]
    s_pows = encode(enc, sk_enc, s_pows_ring, keys[2])
    gamma_io = encode(enc, sk_enc, gamma_io_ring, keys[3])
    delta_mid = None
    if n_aux > 0:
        delta_mid_ring = ring_batch_scale(RingElem(ctx, combo.res[n_io:]), delta_inv)
        delta_mid = encode(enc, sk_enc, delta_mid_ring, keys[4])
    delta_ts = encode(enc, sk_enc, delta_ts_ring, keys[5])

    pk = ProvingKey(
        compiled=comp, domain=domain, params=params,
        alpha=alpha_enc, beta=beta_enc, s_pows=s_pows, gamma_io=gamma_io,
        delta_mid=delta_mid, delta_ts=delta_ts, pk_enc=pk_enc,
        constraint_system=cs_obj,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta, gamma=gamma,
                         delta=delta, sk_enc=sk_enc)
    return KeyPair(pk=pk, vk=vk)


def prover(pk: ProvingKey, primary_input, auxiliary_input,
           rng: np.random.Generator | None = None) -> Proof:
    """Prove (`groth16.tcc:69-115`), non-ZK: `pipeline.groth16_core` (the
    prover-mode witness map, then the four encoding inner products) on the
    key's and the assignment's tensors.  `rng` is
    unused (d1 = d2 = d3 = 0, as in the reference); it keeps the signature
    of `rinocchio.prover`."""
    ectx = pk.params.enc
    ums = pk.params.use_modswitch
    p_res, a_res = _pa_batches(pk.params.ring, primary_input, auxiliary_input)
    crs = {
        "s_pows": (pk.s_pows.c0, pk.s_pows.c1),
        "delta_ts": (pk.delta_ts.c0, pk.delta_ts.c1),
        "delta_mid": None if pk.delta_mid is None else (pk.delta_mid.c0, pk.delta_mid.c1),
        "alpha": (pk.alpha.c0, pk.alpha.c1),
        "beta": (pk.beta.c0, pk.beta.c1),
    }
    A, B, C = groth16_core(pk.compiled, crs, p_res, a_res, pk.domain, ectx, ums)
    la, lb, lc = groth16_proof_levels(ectx, ums)
    return Proof(
        A=Encoding(ectx, A[0], A[1], la),
        B=Encoding(ectx, B[0], B[1], lb),
        C=Encoding(ectx, C[0], C[1], lc),
    )


def _io_assignment_with_one(ctx, primary_input) -> RingElem:
    """[1, primary...] assignment rows (io columns only), [n_io, L, n]."""
    if isinstance(primary_input, RingElem):
        p_res = primary_input.res
        one = RingElem.one(ctx).res.expand(1, ctx.L, max(p_res.shape[-1], 1))
        return RingElem(ctx, torch.cat([one, p_res], dim=0))
    return RingElem.stack([RingElem.one(ctx)] + list(primary_input))


def _io_eval_kernel(ctx, At_io, Bt_io, Ct_io, z_io):
    """(v_io(s), w_io(s), y_io(s)) = per-matrix sum_k z_k * Mt[k], O(n_io)."""

    return tuple(dot_mod(vals, z_io, ctx.p) for vals in (At_io, Bt_io, Ct_io))


def _io_terms_at_s(pvk_qrp, ctx, n_io: int, primary_input):
    """v_io(s), w_io(s), y_io(s) as RingElems from a QRPInstanceEvaluation."""
    z_io = _io_assignment_with_one(ctx, primary_input)
    assert z_io.res.shape[0] == n_io
    v, w, y = _io_eval_kernel(
        ctx, pvk_qrp.At.res[:n_io], pvk_qrp.Bt.res[:n_io], pvk_qrp.Ct.res[:n_io],
        z_io.res,
    )
    return RingElem(ctx, v), RingElem(ctx, w), RingElem(ctx, y)


def _io_terms_via_interpolation(pk, primary_input, s: RingElem):
    """Reference-shaped io route (evaluate the constraints on the padded
    primary, interpolate, evaluate at s — `groth16.tcc:140-158`).  Kept as
    the cross-check of `_io_terms_at_s`; O(M log M * n)."""
    ctx = pk.params.ring
    domain = pk.domain
    z_io = _padded_primary_with_one(pk, primary_input)
    evals = pk.compiled.evaluate(z_io.res, domain.m, slot_major=True)
    return tuple(eval_coeffs_at(RingElem(ctx, _interp(domain, e).permute(2, 1, 0)), s)
                 for e in evals)


def _padded_primary_with_one(pk, primary_input) -> RingElem:
    """[1, primary..., 0...] assignment column (zeros for aux wires)."""
    ctx = pk.params.ring
    n_aux = pk.compiled.num_variables - pk.compiled.primary_input_size
    if isinstance(primary_input, RingElem):
        io = _io_assignment_with_one(ctx, primary_input).res
        zeros = torch.zeros((n_aux, *io.shape[1:]), dtype=torch.int32, device=io.device)
        return RingElem(ctx, torch.cat([io, zeros], dim=0))
    return RingElem.stack(
        [RingElem.one(ctx)] + list(primary_input) + [RingElem.zero(ctx)] * n_aux)


@dataclass
class ProcessedVerificationKey:
    """io-independent precomputation."""

    vk: VerificationKey
    qrp: Any
    alpha_beta: RingElem


def verifier_process(vk: VerificationKey) -> ProcessedVerificationKey:
    qrp = r1cs_to_qrp_instance_map_with_evaluation(vk.pk.compiled, vk.s, vk.pk.domain)
    return ProcessedVerificationKey(vk=vk, qrp=qrp, alpha_beta=vk.alpha * vk.beta)


def verifier(vk: VerificationKey, primary_input, proof: Proof) -> bool:
    """Verify (`groth16.tcc:117-170`): A*B = alpha*beta + gamma*f_io + delta*C."""
    return online_verifier(verifier_process(vk), primary_input, proof)


def online_verifier(pvk: ProcessedVerificationKey, primary_input, proof: Proof) -> bool:
    vk = pvk.vk
    pk = vk.pk
    ctx = pk.params.ring
    enc_ctx = pk.params.enc

    A = decode(enc_ctx, vk.sk_enc, proof.A)
    B = decode(enc_ctx, vk.sk_enc, proof.B)
    C = decode(enc_ctx, vk.sk_enc, proof.C)

    n_io = pk.compiled.primary_input_size + 1
    v_io, w_io, y_io = _io_terms_at_s(pvk.qrp, ctx, n_io, primary_input)

    # f_io = (beta v_io + alpha w_io + y_io) / gamma (kept /gamma then *gamma
    # to mirror the reference check shape, groth16.tcc:159-167)
    f_io = (vk.beta * v_io + vk.alpha * w_io + y_io) / vk.gamma

    lhs = A * B
    rhs = pvk.alpha_beta + vk.gamma * f_io + vk.delta * C
    return lhs == rhs
