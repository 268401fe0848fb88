"""Prover-scale benchmark: ringGroth16 at synthetic R1CS sizes (the
repository's ``bench_prover.py``).

Setup, prove and verify of a 2^log_m-constraint squaring chain
(``models.synthetic``).  Two prover layouts:

* unphased (default): the seeded CRS (``snark/seeded.py``), c0 resident,
  c1 regenerated from the key; setup cold and warm, prove cold and warm;
* ``--phased``: the limb-phased streamed prover (``snark/streamed.py``),
  setup and prove in one pass, the CRS never resident.  Pass 0 is cold,
  pass 1 warm (its sections, synced once each, give the combined wall),
  pass 2 and later warm and profiled (``StreamRecord(profile=True)``: each
  chunk's encryption as "setup", its MAC as "prove", at a synchronize per
  row sub-chunk).

The verifier must accept and must reject a changed public input; either
failure raises.  CPU legs: the native C++ MAC on ``--cpu-slabs`` sampled
slabs, scaled to the whole prover (a lower bound: witness map left out;
dense rings also pay the reference's per-term plaintext NTT), and with
``--cpu-full`` the measured CPU prover (``native/cpu_prover.py``).  Every
timed section ends in a synchronize.

    python -m ringsnark_tpu_torch.scripts.bench_prover [--log-m 16] [--ring zq|rq]
        [--n-inner 4096] [--L 1] [--phased] [--cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .common import (bench_params, card, device_for, emit, log, native_binding, peak_gib,
                     reset_peak, sync, timed)

__all__ = ["main", "parse_args"]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-m", type=int, default=16)
    ap.add_argument("--system", choices=["groth16", "rinocchio"], default="groth16",
                    help="rinocchio streams a ~2x CRS and 10 inner products (phased only)")
    ap.add_argument("--ring", choices=["zq", "rq"], default="zq")
    ap.add_argument("--N", type=int, default=256, help="outer degree for rq")
    ap.add_argument("--n-inner", type=int, default=4096)
    ap.add_argument("--L", type=int, default=1,
                    help="outer limbs; soundness ~ (M/2^31)^L")
    ap.add_argument("--slab", type=int, default=4096)
    ap.add_argument("--phased", action="store_true", help="the limb-phased streamed prover")
    ap.add_argument("--phase-chunk", type=int, default=1 << 16,
                    help="phased: CRS rows resident at a time")
    ap.add_argument("--passes", type=int, default=3,
                    help="phased: pass 0 cold, pass 1 warm (combined wall), later passes "
                         "warm and profiled (setup/prove split)")
    ap.add_argument("--margin", type=int, default=10, help="noise planner margin bits")
    ap.add_argument("--cpu-slabs", type=int, default=4,
                    help="slabs sampled for the native CPU MAC leg")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--cpu-full", action="store_true",
                    help="also run the measured full CPU prover (groth16 only)")
    ap.add_argument("--skip-warm-setup", action="store_true",
                    help="unphased: skip the second setup")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    ap.add_argument("--out", default=None, help="append the row to this file")
    return ap.parse_args(argv)


def _agg(rec, kind: str) -> dict:
    """Seconds per section name (a name's '+' suffix dropped) of one kind."""
    agg = {}
    for k, name, dt in rec.events:
        if k == kind:
            base = name.split("+")[0]
            agg[base] = agg.get(base, 0.0) + dt
    return agg


def _seeded(args, comp, params, primary, aux, key, device, result, rng):
    """The cold setup draws from `rng` (the circuit's), the warm one from
    seed 1, as ``bench_prover.py`` does."""
    from ..snark import seeded as sd

    def setup(seed_rng):
        return timed(lambda: sd.generator_seeded(comp, params, seed_rng, key, slab=args.slab),
                     device)

    kp, setup_cold = setup(rng)
    setup_s = setup_cold
    if not args.skip_warm_setup:
        kp = None  # one seeded CRS at a time
        if device == "cuda":
            torch.cuda.empty_cache()
        kp, setup_s = setup(np.random.default_rng(1))
    pk_bits = kp.pk.size_in_bits()
    log(f"[setup] {setup_s:.3f} s (cold {setup_cold:.3f} s), pk c0 {kp.pk.c0_bytes() / 2**30:.3f}"
        " GiB")
    proof, prove_cold = timed(lambda: sd.prover_seeded(kp.pk, primary, aux), device)
    proof2, prove_s = timed(lambda: sd.prover_seeded(kp.pk, primary, aux), device)
    if not all(a == b for a, b in zip((proof.A, proof.B, proof.C),
                                      (proof2.A, proof2.B, proof2.C))):
        raise RuntimeError("the cold and warm seeded proofs differ")
    log(f"[prove] {prove_s:.3f} s (cold {prove_cold:.3f} s)")
    result.update(value=prove_s, setup_s=setup_s, setup_cold_s=setup_cold,
                  prove_cold_s=prove_cold, proof_bits=proof.size_in_bits(), pk_c0_bits=pk_bits,
                  pk_c0_gib=kp.pk.c0_bytes() / 2**30)
    return proof, kp.vk


def _streamed(args, comp, params, primary, aux, key, device, result):
    from ..snark import streamed as st
    from ..utils import prng

    fn = st.stream_prove if args.system == "groth16" else st.stream_prove_rinocchio
    proof = vk = warm = prof = None
    for p_i in range(max(2, args.passes)):
        proof = vk = None
        profile = p_i >= 2
        rec = st.StreamRecord(sync=True, profile=profile)
        (proof, vk, rec), wall = timed(lambda: fn(
            comp, params, primary, aux, np.random.default_rng(p_i), prng.fold_in(key, p_i),
            slab=args.slab, phase_rows=args.phase_chunk, record=rec), device)
        log(f"[pass {p_i}{' prof' if profile else ''}] setup {rec.total('setup'):.3f} s stream "
            f"{rec.total('stream'):.3f} s prove {rec.total('prove'):.3f} s (wall {wall:.3f} s)")
        if p_i == 0:
            result["combined_cold_s"] = wall
        elif not profile:
            warm = rec
            result["combined_wall_s"] = wall
        else:
            prof = rec
    combined = warm.total("setup") + warm.total("stream") + warm.total("prove")
    result.update(combined_s=combined, stream_s=warm.total("stream"),
                  stream_breakdown=_agg(warm, "stream"),
                  warm_setup_breakdown=_agg(warm, "setup"),
                  warm_prove_breakdown=_agg(warm, "prove"))
    log(f"[warm] combined setup+prove {combined:.3f} s; stream "
        + " ".join(f"{k}={v:.3f}s" for k, v in result["stream_breakdown"].items()))
    if prof is not None:
        for kind in ("setup", "prove"):
            result[f"{kind}_breakdown"] = _agg(prof, kind)
        result.update(value=prof.total("prove"), setup_s=prof.total("setup"),
                      witness_map_s=result["prove_breakdown"].get("witness_map", 0.0),
                      n_profile_syncs=sum(1 for k, _, _ in prof.events if k in ("setup", "prove")))
    else:
        result["value"] = combined
    result["proof_bits"] = proof.size_in_bits()
    return proof, vk


def _verify(args, vk, primary, proof, device, result):
    """The processed vk, then a cold and a warm online verify (True) and one
    with a changed public input (False)."""
    from ..snark import groth16, rinocchio

    system = groth16 if args.system == "groth16" else rinocchio
    pvk, process_s = timed(lambda: system.verifier_process(vk), device)
    ok_cold, verify_cold = timed(lambda: system.online_verifier(pvk, primary, proof), device)
    ok, verify_s = timed(lambda: system.online_verifier(pvk, primary, proof), device)
    rejected = not system.online_verifier(pvk, primary + 1, proof)
    if not (ok_cold is True and ok is True):
        raise RuntimeError("the verifier rejected an honest proof")
    if not rejected:
        raise RuntimeError("the verifier accepted a proof against a changed public input")
    log(f"[verify] {verify_s:.3f} s warm (cold {verify_cold:.3f} s, vk process {process_s:.3f} s)"
        "; a changed public input is rejected")
    result.update(verify_s=verify_s, verify_cold_s=verify_cold, verify_process_s=process_s,
                  verified=True, tampered_rejected=True)


def _cpu_mac(args, params, M, result):
    """The native MAC on sampled slabs, scaled to every MAC of the prover."""
    native = native_binding()
    threads = native.max_threads()
    native.set_threads(threads)
    ring, ectx = params.ring, params.enc
    q0, S, n = ectx.inner_primes[0], args.slab, ectx.L_inner * ectx.n_inner
    crng = np.random.default_rng(7)
    ct = crng.integers(0, q0, (S, n), dtype=np.uint64).astype(np.uint32)
    pt = crng.integers(0, q0, (S, n), dtype=np.uint64).astype(np.uint32)
    native.ip_accumulate(ct[:8], pt[:8], q0)  # warm
    t0 = time.perf_counter()
    for _ in range(args.cpu_slabs):
        native.ip_accumulate(ct, pt, q0)
    per_slab = (time.perf_counter() - t0) / args.cpu_slabs
    # groth16: 4 sides (A, B over s_pows; H over delta_ts; aux over
    # delta_mid); rinocchio: 9 -- x 2 components x L x (M+1) terms
    sides = 4 if args.system == "groth16" else 9
    cpu_mac_s = per_slab * sides * 2 * ring.L * ((M + 1) / S)
    if ring.N > 1:
        # dense rings: the reference's multiply_plain transforms the
        # plaintext per term, outer limb and inner limb
        from ..ops import ntt as nttm

        nplan = nttm.get_plan((q0,), ectx.n_inner, negacyclic=True)
        w, psi = int(nplan.w_np[0]), int(nplan.psi[0, 1])
        x = crng.integers(0, q0, (1, ectx.n_inner), dtype=np.uint64).astype(np.uint32)
        native.negacyclic_ntt(x, q0, w, psi)
        t0 = time.perf_counter()
        for _ in range(64):
            native.negacyclic_ntt(x, q0, w, psi)
        per_ntt = (time.perf_counter() - t0) / 64
        cpu_ntt_s = per_ntt * sides * ring.L * (M + 1) * ectx.L_inner / threads
        cpu_mac_s += cpu_ntt_s
        result["cpu_ntt_s"] = cpu_ntt_s
    log(f"[cpu] native MAC ({threads} threads): {per_slab * 1e3:.2f} ms/slab -> whole prover's "
        f"MAC ~{cpu_mac_s:.2f} s (a lower bound: witness map left out)")
    result.update(cpu_mac_s=cpu_mac_s, cpu_threads=threads, vs_baseline=cpu_mac_s / result["value"])


def _cpu_full(params, comp, primary, aux, result):
    native_binding()
    from ..native.cpu_prover import groth16_prover_cpu
    from ..reductions.r1cs_to_qrp import _assignment_batches

    full, _, _ = _assignment_batches(params.ring, primary, aux)
    t, _ = groth16_prover_cpu(comp, params.enc, full.res, aux.res, np.random.default_rng(11))
    log(f"[cpu-full] measured CPU prover ({t['threads']} threads): witness map "
        f"{t['witness_map_s']:.3f} s + MACs {t['mac_s']:.3f} s = {t['total_s']:.3f} s")
    result.update(cpu_prover_s=t["total_s"], cpu_prover_wm_s=t["witness_map_s"],
                  cpu_prover_threads=t["threads"], vs_cpu_prover=t["total_s"] / result["value"])


def run(args) -> tuple[dict, object]:
    """The row and the proof."""
    from ..models.synthetic import build_synthetic_square_chain
    from ..utils import prng

    if args.system == "rinocchio" and not args.phased:
        raise ValueError("rinocchio runs through the streamed prover only (--phased)")
    device = device_for(args.cpu)
    M = 1 << args.log_m
    N = 1 if args.ring == "zq" else args.N
    params = bench_params(args.L, N, args.n_inner, args.log_m, args.margin, device)
    ring, ectx = params.ring, params.enc
    dev = card(device)
    crs_gib = 3 * (M + 1) * args.L * ectx.L_inner * args.n_inner * 4 / 2**30
    log(f"[cfg] M=2^{args.log_m}, ring={args.ring} N={N} L={args.L}, inner N'={args.n_inner} "
        f"L'={ectx.L_inner} floor={ectx.floor_limbs}, CRS c0 ~{crs_gib:.2f} GiB, "
        f"{dev['name']} ({dev.get('power_limit', 'cpu')}), phased={args.phased}")
    reset_peak(device)
    rng = np.random.default_rng(0)
    (comp, primary, aux), build_s = timed(lambda: build_synthetic_square_chain(ring, M, rng),
                                          device)
    log(f"[build] circuit {build_s:.3f} s")
    key = prng.key(0)
    # soundness (DESIGN.md §12): 2M/q_min per proof, the L-fold product for
    # limb-global statements or K=L repetitions
    per_limb = (args.log_m + 1) - (min(int(p).bit_length() for p in ring.primes) - 1)
    result = {
        "metric": f"{args.system}_prover_{args.ring}_2e{args.log_m}",
        "unit": "s",
        "config": {"M": M, "ring": args.ring, "N": N, "L": args.L, "n_inner": args.n_inner,
                   "L_inner": ectx.L_inner, "floor": ectx.floor_limbs, "slab": args.slab,
                   "phased": bool(args.phased), "margin": args.margin,
                   "device": dev["name"]},
        "card": dev,
        "build_s": build_s,
        "soundness_err_log2_single": per_limb,
        "soundness_err_log2": args.L * per_limb,
    }
    if args.phased:
        proof, vk = _streamed(args, comp, params, primary, aux, key, device, result)
    else:
        proof, vk = _seeded(args, comp, params, primary, aux, key, device, result, rng)
    _verify(args, vk, primary, proof, device, result)
    result["peak_gib"] = peak_gib(device)
    sync(device)
    if not args.skip_cpu:
        _cpu_mac(args, params, M, result)
    if args.cpu_full and args.system == "groth16":
        _cpu_full(params, comp, primary, aux, result)
    return result, proof


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    result, _ = run(args)
    return emit(result, args.out)


if __name__ == "__main__":
    main()
