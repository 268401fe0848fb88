"""The port's examples (``ringsnark_tpu_torch.examples``) on the CPU: each
example's proofs equal, bit for bit, the same calls on ``ringsnark_tpu``
under the same numpy seed and PRNGKey (Z_q L=3 replicate 2; R_q N=16,
N'=512, L=3; the plaintext check at N=16), rebuilt through the JAX
package's API (the repository's example scripts are not imported); and
microbench's timings and analytic proof size."""

import jax
import numpy as np
import pytest

from ringsnark_tpu.models import build_plaintext_check as jbuild_plaintext_check
from ringsnark_tpu.models import build_toy_circuit as jbuild_toy_circuit
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import rinocchio as jrin
from ringsnark_tpu_torch.examples import (example_int_ring, example_plaintext_check,
                                          example_poly_ring, microbench)
from script_parity import assert_same_proof, jax_params


def _example_jax(name):
    """The JAX example's calls through the package API: (params, pb, rng)."""
    rng = np.random.default_rng(0)
    if name == "int_ring":
        jp = jax_params(3, 1, 512, max(1 << 12, 1024), 4)
        return jp, jbuild_toy_circuit(jp.ring, rng, replicate=2), rng
    # example_poly_ring.make_params(N, 512): N'=512 is outside the security
    # table, so the primes come from the fallback loop
    jp = jax_params(3, 16, 512, max(1 << 12, 1024, 64), 4)
    if name == "poly_ring":
        return jp, jbuild_toy_circuit(jp.ring, rng), rng
    return jp, jbuild_plaintext_check(jp.ring, rng, log_t=16), rng


EXAMPLES = {
    "int_ring": (example_int_ring, ["--cpu", "--replicate", "2"]),
    "poly_ring": (example_poly_ring, ["--cpu", "--N", "16", "--n-inner", "512"]),
    "plaintext_check": (example_plaintext_check, ["--cpu", "--N", "16"]),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_proofs_equal_jax(name, capsys):
    mod, argv = EXAMPLES[name]
    out = mod.main(argv)
    jp, pb, rng = _example_jax(name)
    assert pb.is_satisfied() and out["constraints"] == pb.num_constraints()
    for sname, system in (("Rinocchio", jrin), ("RingGroth16", jg16)):
        kp = system.generator(pb.get_constraint_system(), jp, rng, jax.random.PRNGKey(0))
        jproof = system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(), rng)
        mine = out["systems"][sname]
        assert mine["verified"] is True and mine["proof_bits"] == jproof.size_in_bits()
        assert mine["pk_bits"] == kp.pk.size_in_bits()
        assert_same_proof(mine["proof"], jproof)
    assert capsys.readouterr().out.count("Verification passed: True") == 2


def test_microbench_times_and_analytic_size(capsys):
    out = microbench.main(["--cpu", "--N", "64", "--L", "2", "--n-inner", "512",
                           "--L-inner", "2"])
    for k in ("ntt_s", "scalar_mul_s", "add_s", "mul_s", "enc_s", "dec_s"):
        assert out[k] > 0, k
    assert out["rinocchio_proof_bits"] == 9 * 2 * 2 * 2 * 512 * 31
    printed = capsys.readouterr().out
    for label in ("NTT", "A x R", "R + R", "R x R", "1 Enc", "1 Dec"):
        assert f"[TIME] {label}" in printed, label
