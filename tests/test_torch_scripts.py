"""The port's entry-point scripts (``ringsnark_tpu_torch.scripts``) on the
CPU, at small sizes.

The JAX side is rebuilt through the JAX package's API, never by importing
the repository's scripts (``bench_scaling.py`` changes the XLA flags and
the platform when imported).  Every proof comparison is exact:

* ``bench_prover`` (both rings, seeded and streamed) returns a row with the
  JAX script's keys, and its proof equals ``ringsnark_tpu.snark.seeded`` /
  ``streamed``'s for that seed and key;
* ``bench_circuits``' resident proof equals the JAX generator's and
  prover's under the script's seeds;
* ``bench_cpu_full``'s prover outputs equal the JAX package's
  ``groth16_prover_cpu``;
* ``bench --cpu``: the twin equals the native output (the script checks it
  and raises otherwise), and a time under the memory bound raises;
* ``bench_scaling --cpu`` on 1 and 2 gloo ranks;
* without ``--cpu`` and without a card every entry point, the examples'
  too, raises.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ringsnark_tpu.encoding.noise import plan_inner_chain as jplan_inner_chain
from ringsnark_tpu.models import build_plaintext_check as jbuild_plaintext_check
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.native.cpu_prover import groth16_prover_cpu as jprover_cpu
from ringsnark_tpu.reductions.r1cs_to_qrp import _assignment_batches as j_assignment_batches
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import seeded as jsd
from ringsnark_tpu.snark import streamed as jst
from ringsnark_tpu_torch import native
from ringsnark_tpu_torch.examples import (example_int_ring, example_plaintext_check,
                                          example_poly_ring, microbench)
from ringsnark_tpu_torch.scripts import (bench, bench_circuits, bench_cpu_full,
                                         bench_encode_profile, bench_prover, bench_scaling)
from script_parity import assert_same_proof, jax_params

# ---------------------------------------------------------------------------
# bench_prover
# ---------------------------------------------------------------------------

# the keys of bench_prover.py's row (its relay-only keys aside)
PROVER_KEYS = {"metric", "unit", "config", "soundness_err_log2_single", "soundness_err_log2",
               "value", "proof_bits", "verify_s", "verify_cold_s", "verify_process_s",
               "cpu_mac_s", "cpu_threads", "vs_baseline"}
SEEDED_KEYS = {"setup_s", "setup_cold_s", "prove_cold_s", "pk_c0_bits"}
PHASED_KEYS = {"combined_cold_s", "combined_s", "stream_s", "stream_breakdown"}
PROFILED_KEYS = {"setup_breakdown", "prove_breakdown", "witness_map_s", "n_profile_syncs"}
CONFIG_KEYS = {"M", "ring", "N", "L", "n_inner", "L_inner", "floor", "slab", "phased", "device"}


@pytest.mark.parametrize("ring,phased", [("zq", False), ("zq", True), ("rq", False),
                                         ("rq", True)])
def test_bench_prover_row_and_proof_equal_jax(ring, phased):
    """L=2, M=2^5, N'=64 (R_q at N=8: the streamed prover's limb-local
    branch); streamed with three passes (the last profiled), seeded with the
    warm setup; the proof is the last pass's / the warm keypair's."""
    argv = ["--cpu", "--ring", ring, "--L", "2", "--N", "8", "--n-inner", "64", "--log-m", "5",
            "--slab", "8", "--phase-chunk", "16", "--cpu-slabs", "1"]
    if phased:
        argv += ["--phased", "--cpu-full"]
    row, proof = bench_prover.run(bench_prover.parse_args(argv))
    keys = PROVER_KEYS | (PHASED_KEYS | PROFILED_KEYS if phased else SEEDED_KEYS)
    assert keys <= set(row), keys - set(row)
    assert CONFIG_KEYS <= set(row["config"])
    assert row["metric"] == f"groth16_prover_{ring}_2e5" and row["verified"]
    assert row["tampered_rejected"] and row["peak_gib"] is None
    assert (ring == "rq") == ("cpu_ntt_s" in row)
    assert not phased or {"cpu_prover_s", "vs_cpu_prover"} <= set(row)
    json.dumps(row)

    N = 1 if ring == "zq" else 8
    L_inner, floor = jplan_inner_chain(64, 31, 33, margin_bits=10, dense=N > 1)
    assert (row["config"]["L_inner"], row["config"]["floor"]) == (L_inner, floor)
    jp = jax_params(2, N, 64, max(1 << 7, 128, 4 * N), L_inner, floor)
    rng = np.random.default_rng(0)
    jcomp, jprim, jaux = jsquare_chain(jp.ring, 32, rng)
    key = jax.random.PRNGKey(0)
    if phased:
        jproof, _, _ = jst.stream_prove(jcomp, jp, jprim, jaux, np.random.default_rng(2),
                                        jax.random.fold_in(key, 2), slab=8, phase_rows=16)
    else:
        kp = jsd.generator_seeded(jcomp, jp, np.random.default_rng(1), key, slab=8)
        jproof = jsd.prover_seeded(kp.pk, jprim, jaux)
    assert_same_proof(proof, jproof)


def test_bench_prover_rinocchio_needs_phased():
    with pytest.raises(ValueError, match="streamed prover only"):
        bench_prover.run(bench_prover.parse_args(["--cpu", "--system", "rinocchio"]))


# ---------------------------------------------------------------------------
# bench, bench_cpu_full, bench_circuits, bench_encode_profile, bench_scaling
# ---------------------------------------------------------------------------

def test_bench_twin_equals_native_and_bound_check(monkeypatch):
    row = bench.main(["--cpu", "--batch", "2", "--rep", "1"])
    assert row["metric"] == "ntt_neg_8192_6limb" and row["shape"] == [2, 6, 8192]
    assert 0 < row["plain_share_of_bound"] <= 1 and 0 < row["plain_inv_share_of_bound"] <= 1
    assert row["cpu_threads"] == native.max_threads() and row["value"] > 0
    assert row["cpu_rows_socket"] == 2 and row["cpu_rows_1core"] == 2  # the whole batch
    assert "kernel_us" not in row  # no kernel leg without a card
    assert row["bound_us"] == pytest.approx(2 * 6 * 8192 * 4 * 2 / row["bound_rate_GBps"] / 1e3)
    with pytest.raises(RuntimeError, match="beats the memory bound"):
        bench.check_bound("kernel", 1e-6, 3.76e-6)
    assert bench.check_bound("kernel", 3.76e-5, 3.76e-6) == pytest.approx(0.1)
    monkeypatch.setattr(native, "negacyclic_ntt", lambda data, *a: np.zeros_like(data))
    with pytest.raises(RuntimeError, match="differs from the native"):
        bench.main(["--cpu", "--batch", "1", "--rep", "1"])


def test_bench_cpu_full_equals_jax():
    row, outs = bench_cpu_full.run(bench_cpu_full._parse(["--log-m", "6"]))
    assert row["metric"] == "cpu_full_prover_zq_2e6" and row["threads"] == native.max_threads()
    assert row["value"] == pytest.approx(row["witness_map_s"] + row["mac_s"], abs=2e-3)
    L_inner, floor = jplan_inner_chain(4096, 31, 65, margin_bits=6, dense=False)
    jp = jax_params(1, 1, 4096, max(1 << 8, 8192, 4), L_inner, floor)
    assert row["config"]["L_inner"] == L_inner
    jcomp, jprim, jaux = jsquare_chain(jp.ring, 64, np.random.default_rng(0))
    jfull, _, _ = j_assignment_batches(jp.ring, jprim, jaux)
    _, jouts = jprover_cpu(jcomp, jp.enc, np.asarray(jfull.res), np.asarray(jaux.res),
                           np.random.default_rng(11))
    assert len(outs) == len(jouts) == 1
    for mine, theirs in zip(outs, jouts):
        for a, b in zip(mine, theirs):
            assert np.array_equal(a, np.asarray(b))


def test_bench_circuits_resident_proof_equals_jax():
    out = bench_circuits.main(["--cpu", "--N", "16", "--n-inner", "512", "--features", "4",
                               "--circuit", "plaintext_check", "--system", "groth16"])
    (row,) = out["rows"]
    assert row["metric"] == "plaintext_check_groth16"
    for k in ("setup_s", "setup_cold_s", "prove_s", "prove_cold_s", "verify_s", "proof_bits"):
        assert k in row, k
    jp = jax_params(2, 16, 512, max(1 << 14, 1024, 64),
                     *jplan_inner_chain(512, 31, max(4 * 4 + 8, 18, 18), dense=True))
    rng = np.random.default_rng(0)
    pb = jbuild_plaintext_check(jp.ring, rng, log_t=16)
    kp = jg16.generator(pb.get_constraint_system(), jp, rng, jax.random.PRNGKey(1))
    jproof = jg16.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                         np.random.default_rng(7))
    assert_same_proof(row["proof"], jproof)


def test_bench_circuits_streamed_and_fhe_side(tmp_path):
    out_file = tmp_path / "rows.jsonl"
    out = bench_circuits.main(["--cpu", "--N", "16", "--n-inner", "512", "--features", "4",
                               "--circuit", "logreg", "--streamed", "--slab", "8",
                               "--out", str(out_file)])
    metrics = [r["metric"] for r in out["rows"]]
    assert metrics == ["logreg_rinocchio", "logreg_groth16", "logreg_fhe_side"]
    assert all(r["streamed"] for r in out["rows"][:2])
    fhe = out["rows"][2]
    assert fhe["fhe_enc_count"] == 8 and fhe["fhe_eval_s"] > 0
    written = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert [r["metric"] for r in written] == metrics and "proof" not in written[0]


def test_bench_encode_profile_sections(capsys):
    row = bench_encode_profile.main(["--cpu", "--rows", "32", "--slab", "16", "--n-inner", "256",
                                     "--reps", "1"])
    for k in ("a_only_s", "err_only_s", "errntt_only_s", "encrypt_s", "mac2_s"):
        assert row[k] > 0, k
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row


def test_bench_scaling_on_gloo_ranks():
    out = bench_scaling.main(["--cpu", "--D", "1", "2"])
    rows = out["rows"]
    assert [(r["section"], r["D"]) for r in rows] == [
        ("coeff_sharded_ntt_fwd", 1), ("data_sharded_mac", 1),
        ("coeff_sharded_ntt_fwd", 2), ("data_sharded_mac", 2)]
    assert all(r["backend"] == "gloo" and r["wall_s"] > 0 for r in rows)
    assert rows[0]["collective_bytes"] == 0 and rows[2]["collective_bytes"] == 8 * 2 * 2048 * 4 * 2
    assert rows[3]["collective_bytes"] == 3 * 1024 * 8


ENTRY_POINTS = [bench, bench_prover, bench_circuits, bench_encode_profile, bench_scaling,
                example_int_ring, example_poly_ring, example_plaintext_check, microbench]


@pytest.mark.parametrize("mod", ENTRY_POINTS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_points_need_a_card_or_cpu(mod, monkeypatch):
    """Nothing falls back to the CPU: without --cpu and without a card every
    entry point raises before it computes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
