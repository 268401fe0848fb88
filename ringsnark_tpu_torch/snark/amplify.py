"""Soundness amplification by independent repetition.

Port of ``ringsnark_tpu/snark/amplify.py``.  One ringGroth16 pass has
Schwartz-Zippel soundness error ~2M/q_min: every verifier check is
limb-diagonal, and a statement false over Z_q is only guaranteed false in
one limb.  K independent repetitions of the whole proof (fresh trapdoor
and encryption keys each) bring it to (2M/q_min)^K for any statement; with
31-bit limbs at M = 2^18 that is ~2^-12 per repetition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..relations.r1cs import CompiledR1CS
from ..utils import prng
from . import groth16 as g16
from . import streamed as st
from .api import SnarkParams

__all__ = ["RepeatedProof", "soundness_err_log2", "prove_repeated", "verify_repeated"]


def soundness_err_log2(M: int, pbits: int, reps: int = 1) -> int:
    """log2 soundness error of `reps` independent proofs at degree-M QRP
    over limbs of `pbits`-bit primes: reps * (log2(2M) - log2(q_min))."""
    return reps * (M.bit_length() - (pbits - 1))


@dataclass
class RepeatedProof:
    """K independent (proof, vk) pairs for one statement."""

    proofs: list
    vks: list

    @property
    def reps(self) -> int:
        return len(self.proofs)

    def size_in_bits(self) -> int:
        return sum(p.size_in_bits() for p in self.proofs)


def prove_repeated(comp: CompiledR1CS, params: SnarkParams, primary, auxiliary,
                   rng: np.random.Generator, key: prng.Key, reps: int,
                   **stream_kwargs) -> RepeatedProof:
    """K independent streamed setup+prove passes (ringGroth16): repetition
    r draws its trapdoor from `rng` and encrypts with ``fold_in(key, 7000 + r)``."""
    proofs, vks = [], []
    for r in range(reps):
        proof, vk, _ = st.stream_prove(comp, params, primary, auxiliary, rng,
                                       prng.fold_in(key, 7000 + r), **stream_kwargs)
        proofs.append(proof)
        vks.append(vk)
    return RepeatedProof(proofs=proofs, vks=vks)


def verify_repeated(rp: RepeatedProof, primary) -> bool:
    """Accept iff every repetition verifies (`groth16.tcc:117-170` x K)."""
    return all(g16.verifier(vk, primary, proof) for proof, vk in zip(rp.proofs, rp.vks))
