"""Rinocchio: designated-verifier zkSNARK for ring arithmetic.

Port of the key, proof and verifier parts of ``ringsnark_tpu/snark/rinocchio.py``
(protocol of Ganesh–Nitulescu–Soria-Vazquez, eprint 2021/322): CRS of
encoded s-powers and lincheck terms, a 9-element proof (A, A', B, B', C, C',
D, D', F) and the verifier's 6 checks.  Proofs come from the streamed prover
(``snark/streamed.py:stream_prove_rinocchio``), which takes a compiled R1CS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..encoding import Encoding, decode
from ..reductions.r1cs_to_qrp import r1cs_to_qrp_instance_map_with_evaluation
from ..relations.r1cs import CompiledR1CS
from ..rings.elem import RingElem
from ..utils.domain import RootsDomain
from .api import SnarkParams
from .groth16 import _io_terms_at_s

__all__ = ["ProvingKey", "VerificationKey", "ProcessedVerificationKey", "Proof",
           "verifier", "verifier_process", "online_verifier"]


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
