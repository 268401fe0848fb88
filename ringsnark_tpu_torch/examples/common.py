"""The examples' shared loop: set up, prove and verify a protoboard's
circuit with Rinocchio and then ringGroth16, drawing every secret from one
numpy generator in the JAX examples' order."""

from __future__ import annotations

import time

import numpy as np

from ..scripts.common import sync

__all__ = ["prove_both"]


def prove_both(pb, params, rng: np.random.Generator, seed: int) -> dict:
    """For each system: `generator(cs, params, rng, key(seed))`, then
    `prover(pk, primary, aux, rng)`, then `verifier`, printed as the JAX
    examples print them.  A rejected proof raises.  Returns per system the
    proof, the verification bit, the pk and proof sizes and the seconds of
    each step (synchronized)."""
    from ..snark import groth16, rinocchio
    from ..utils import prng

    device = params.ring.device
    out = {}
    for name, system in (("Rinocchio", rinocchio), ("RingGroth16", groth16)):
        print(f"\n=== {name} ===")
        t0 = time.perf_counter()
        kp = system.generator(pb.get_constraint_system(), params, rng, prng.key(seed))
        sync(device)
        setup_s = time.perf_counter() - t0
        print(f"Setup: {setup_s:.2f}s; pk {kp.pk.size_in_bits()} bits")
        t0 = time.perf_counter()
        proof = system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(), rng)
        sync(device)
        prove_s = time.perf_counter() - t0
        print(f"Prove: {prove_s:.2f}s; proof {proof.size_in_bits()} bits")
        t0 = time.perf_counter()
        verif = system.verifier(kp.vk, pb.primary_input(), proof)
        verify_s = time.perf_counter() - t0
        print(f"Verify: {verify_s:.2f}s")
        print(f"Verification passed: {verif}")
        if verif is not True:
            raise RuntimeError(f"{name}: the verifier rejected the example's proof")
        out[name] = {"proof": proof, "verified": verif, "pk_bits": kp.pk.size_in_bits(),
                     "proof_bits": proof.size_in_bits(), "setup_s": setup_s,
                     "prove_s": prove_s, "verify_s": verify_s}
    return out
