"""Rinocchio: designated-verifier zkSNARK for ring arithmetic.

Port of ``ringsnark_tpu/snark/rinocchio.py`` (protocol of
Ganesh–Nitulescu–Soria-Vazquez, eprint 2021/322): CRS of encoded s-powers
and lincheck terms, a 9-element proof (A, A', B, B', C, C', D, D', F) and
the verifier's 6 checks.  `generator` and `prover` keep the CRS resident;
``snark/streamed.py:stream_prove_rinocchio`` never holds it.

The generator takes the ring secrets from a numpy `rng` and the encryption
randomness from a threefry key (``utils/prng.py``), both drawn as the JAX
package draws them: one ``(rng seed, key)`` gives its CRS bit for bit, and
one prover `rng` its ZK shifts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..encoding import Encoding, decode, encode, keygen
from ..reductions.r1cs_to_qrp import (
    _assignment_batches,
    r1cs_to_qrp_instance_map_with_evaluation,
)
from ..relations.r1cs import CompiledR1CS, R1CSConstraintSystem
from ..rings.elem import RingElem
from ..utils import prng
from ..utils.domain import RootsDomain
from ..utils.poly_arr import ring_batch_scale
from .api import KeyPair, SnarkParams
from .groth16 import _io_terms_at_s
from .pipeline import rinocchio_core

__all__ = ["ProvingKey", "VerificationKey", "ProcessedVerificationKey", "Proof",
           "generator", "prover", "verifier", "verifier_process", "online_verifier"]

_PROOF_MAIN = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime")


@dataclass
class ProvingKey:
    """CRS (rinocchio.hpp:10-58).  `alpha_rv_ts`..`ry_ys` are carried for
    CRS-shape parity though unused by the prover (the reference marks them
    "Unused?", rinocchio.hpp:18-19).  The streamed prover's key holds none
    of the encodings: the verifier needs only compiled/domain/params."""

    constraint_system: Any
    compiled: CompiledR1CS
    domain: RootsDomain
    params: SnarkParams
    s_pows: Optional[Encoding]  # [M+1] E(s^i)
    alpha_s_pows: Optional[Encoding]  # [M+1] E(alpha s^i)
    beta_prods: Optional[Encoding]  # [aux] E(beta(r_v v_k + r_w w_k + r_y y_k)(s))
    beta_rv_ts: Optional[Encoding]  # E(beta Z(s) r_v)
    beta_rw_ts: Optional[Encoding]
    beta_ry_ts: Optional[Encoding]
    alpha_rv_ts: Optional[Encoding]
    alpha_rw_ts: Optional[Encoding]
    alpha_ry_ts: Optional[Encoding]
    rv_vs: Optional[Encoding]
    rw_ws: Optional[Encoding]
    ry_ys: Optional[Encoding]
    pk_enc: Any = None

    def size_in_bits(self) -> int:
        return sum(e.size_in_bits() for e in (
            self.s_pows, self.alpha_s_pows, self.beta_prods, self.beta_rv_ts,
            self.beta_rw_ts, self.beta_ry_ts, self.alpha_rv_ts, self.alpha_rw_ts,
            self.alpha_ry_ts, self.rv_vs, self.rw_ws, self.ry_ys) if e is not None)


@dataclass
class VerificationKey:
    """Designated-verifier key: trapdoors + decoding key (rinocchio.hpp:61-97)."""

    pk: ProvingKey
    s: RingElem
    alpha: RingElem
    beta: RingElem
    r_v: RingElem
    r_w: RingElem
    r_y: RingElem
    sk_enc: Any

    def size_in_bits(self) -> int:
        return self.pk.size_in_bits()


@dataclass
class Proof:
    """9 encodings (rinocchio.hpp:117-146); F is None when there are no
    auxiliary inputs (non-ZK mode, rinocchio.tcc:177-185 / 200-205)."""

    A: Encoding
    A_prime: Encoding
    B: Encoding
    B_prime: Encoding
    C: Encoding
    C_prime: Encoding
    D: Encoding
    D_prime: Encoding
    F: Optional[Encoding]

    def size_in_bits(self) -> int:
        return sum(e.size_in_bits() for e in (
            self.A, self.A_prime, self.B, self.B_prime, self.C, self.C_prime,
            self.D, self.D_prime, self.F) if e is not None)


def generator(
    cs: R1CSConstraintSystem,
    params: SnarkParams,
    rng: np.random.Generator,
    key,
) -> KeyPair:
    """Trusted setup (`rinocchio.tcc:5-72`).  Draws from `rng` in the order
    s, the encoding key, alpha, r_v, r_w, beta, and encodes with keys 0-6
    of ``split(key, 8)``."""
    ctx = params.ring
    domain = RootsDomain(ctx, max(cs.num_constraints(), 1))
    comp = cs.compile(ctx)
    s = RingElem.random_exceptional_element(ctx, rng, domain)
    qrp = r1cs_to_qrp_instance_map_with_evaluation(comp, s, domain)

    pk_enc, sk_enc = keygen(params.enc, rng)

    alpha = RingElem.random_invertible_element(ctx, rng)
    r_v = RingElem.random_invertible_element(ctx, rng)
    r_w = RingElem.random_invertible_element(ctx, rng)
    r_y = r_v * r_w
    beta = RingElem.random_nonzero_element(ctx, rng)

    s_pows_ring = qrp.Ht  # [M+1, L, 1]: the monomials 1, s, ..., s^M
    alpha_s_pows_ring = ring_batch_scale(s_pows_ring, alpha)

    enc = params.enc
    keys = prng.split(key, 8)
    s_pows = encode(enc, sk_enc, s_pows_ring, keys[0])
    alpha_s_pows = encode(enc, sk_enc, alpha_s_pows_ring, keys[1])

    beta_prods = rv_vs = rw_ws = ry_ys = None
    if cs.auxiliary_input_size > 0:
        aux_slice = slice(cs.primary_input_size + 1, cs.num_variables() + 1)
        rv_vs_ring = ring_batch_scale(RingElem(ctx, qrp.At.res[aux_slice]), r_v)
        rw_ws_ring = ring_batch_scale(RingElem(ctx, qrp.Bt.res[aux_slice]), r_w)
        ry_ys_ring = ring_batch_scale(RingElem(ctx, qrp.Ct.res[aux_slice]), r_y)
        lincheck = ring_batch_scale(rv_vs_ring + rw_ws_ring + ry_ys_ring, beta)
        beta_prods = encode(enc, sk_enc, lincheck, keys[2])
        rv_vs = encode(enc, sk_enc, rv_vs_ring, keys[3])
        rw_ws = encode(enc, sk_enc, rw_ws_ring, keys[4])
        ry_ys = encode(enc, sk_enc, ry_ys_ring, keys[5])

    beta_Zt = beta * qrp.Zt
    alpha_Zt = alpha * qrp.Zt
    shift_terms = RingElem.stack(
        [beta_Zt * r_v, beta_Zt * r_w, beta_Zt * r_y,
         alpha_Zt * r_v, alpha_Zt * r_w, alpha_Zt * r_y]
    )
    shifts = encode(enc, sk_enc, shift_terms, keys[6])

    pk = ProvingKey(
        constraint_system=cs, compiled=comp, domain=domain, params=params,
        s_pows=s_pows, alpha_s_pows=alpha_s_pows, beta_prods=beta_prods,
        beta_rv_ts=shifts[0], beta_rw_ts=shifts[1], beta_ry_ts=shifts[2],
        alpha_rv_ts=shifts[3], alpha_rw_ts=shifts[4], alpha_ry_ts=shifts[5],
        rv_vs=rv_vs, rw_ws=rw_ws, ry_ys=ry_ys, pk_enc=pk_enc,
    )
    vk = VerificationKey(pk=pk, s=s, alpha=alpha, beta=beta,
                         r_v=r_v, r_w=r_w, r_y=r_y, sk_enc=sk_enc)
    return KeyPair(pk=pk, vk=vk)


def prover(
    pk: ProvingKey,
    primary_input,
    auxiliary_input,
    rng: np.random.Generator | None = None,
) -> Proof:
    """Prove (`rinocchio.tcc:75-190`) with the resident CRS.

    ZK is on exactly when there are auxiliary inputs (`rinocchio.tcc:81-90`):
    d1, d2, d3 are drawn from `rng`, the shifts d*Z are folded into the
    coefficient vectors of A, B and C (Z = X^M - 1 gives [a_0 - d, a_1, ...,
    a_{M-1}, d]; the reference multiplies the finished, noisy E(Z(s)) by d
    instead, `rinocchio.tcc:166-174`), and F takes three shift terms, each a
    multiple of one fresh CRS encoding.  Without auxiliary inputs F is None.
    """
    ctx = pk.params.ring
    ectx = pk.params.enc
    rng = rng or np.random.default_rng()
    use_zk = len(auxiliary_input) > 0
    if use_zk:
        d1, d2, d3 = (RingElem.random_invertible_element(ctx, rng) for _ in range(3))
    else:
        d1 = d2 = d3 = RingElem.zero(ctx)

    full, _, mid = _assignment_batches(ctx, primary_input, auxiliary_input)
    aux = mid.res[-len(auxiliary_input):] if pk.beta_prods is not None and use_zk else None
    crs = {
        "s_pows": (pk.s_pows.c0, pk.s_pows.c1),
        "alpha_s_pows": (pk.alpha_s_pows.c0, pk.alpha_s_pows.c1),
        "beta_prods": None if pk.beta_prods is None else (pk.beta_prods.c0, pk.beta_prods.c1),
    }
    ums = pk.params.use_modswitch
    main, f = rinocchio_core(pk.compiled, crs, full.res, mid.res, aux, d1.res, d2.res, d3.res,
                             pk.domain, ectx, ums, use_zk)
    level = max(ectx.L_inner - ectx.floor_limbs, 0) if ums else 0
    elems = {n: Encoding(ectx, c0, c1, level) for n, (c0, c1) in zip(_PROOF_MAIN, main)}

    f_enc = None
    if f is not None:
        f_enc = Encoding(ectx, f[0], f[1], level)
        # the shift terms multiply single fresh encodings (level 0)
        f_enc = f_enc + d1 * pk.beta_rv_ts
        f_enc = f_enc + d2 * pk.beta_rw_ts
        f_enc = f_enc + d3 * pk.beta_ry_ts
    return Proof(F=f_enc, **elems)


@dataclass
class ProcessedVerificationKey:
    """io-independent verifier precomputation: the QRP instance at s."""

    vk: VerificationKey
    qrp: Any  # QRPInstanceEvaluation at s


def verifier_process(vk: VerificationKey) -> ProcessedVerificationKey:
    qrp = r1cs_to_qrp_instance_map_with_evaluation(vk.pk.compiled, vk.s, vk.pk.domain)
    return ProcessedVerificationKey(vk=vk, qrp=qrp)


def verifier(vk: VerificationKey, primary_input, proof: Proof) -> bool:
    """Designated verifier (`rinocchio.tcc:193-295`): decode the proof
    elements and run the 6 checks."""
    return online_verifier(verifier_process(vk), primary_input, proof)


def online_verifier(pvk: ProcessedVerificationKey, primary_input, proof: Proof) -> bool:
    vk = pvk.vk
    pk = vk.pk
    ctx = pk.params.ring
    enc_ctx = pk.params.enc

    V_mid, V_mid_p, W_mid, W_mid_p, Y_mid, Y_mid_p, H, H_p = (
        decode(enc_ctx, vk.sk_enc, e) for e in (
            proof.A, proof.A_prime, proof.B, proof.B_prime, proof.C, proof.C_prime,
            proof.D, proof.D_prime))
    aux_present = proof.F is not None
    L_beta = decode(enc_ctx, vk.sk_enc, proof.F) if aux_present else None

    qrp = pvk.qrp
    # L = beta (r_v V_mid + r_w W_mid + r_y Y_mid)
    Lc = (V_mid * vk.r_v + W_mid * vk.r_w + Y_mid * vk.r_y) * vk.beta
    # the io terms at s: a weighted sum over the io rows of the QRP at s
    n_io = pk.compiled.primary_input_size + 1
    v_io, w_io, y_io = _io_terms_at_s(qrp, ctx, n_io, primary_input)
    P = (V_mid + v_io) * (W_mid + w_io) - (Y_mid + y_io)

    checks = (
        V_mid_p == V_mid * vk.alpha,
        W_mid_p == W_mid * vk.alpha,
        Y_mid_p == Y_mid * vk.alpha,
        H_p == H * vk.alpha,
        not aux_present or Lc == L_beta,
        P == H * qrp.Zt,
    )
    return all(checks)
