"""The measured full CPU prover, alone (the repository's ``bench_cpu_full.py``).

Runs ``native/cpu_prover.groth16_prover_cpu`` (the native C++ library,
OpenMP) for a ``bench_prover`` configuration on the host CPU and prints one
JSON row.  The tables and roots come from this package's ``ops.ntt`` plans
on the CPU; no card is involved.  Pair it with the card's row of
``bench_prover`` at the same configuration for a ratio.

    python -m ringsnark_tpu_torch.scripts.bench_cpu_full [--log-m 14]
        [--ring rq --N 8192 --n-inner 16384] [--L 2] [--threads N] [--out FILE]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .common import bench_params, emit, host_cpu, log, native_binding

__all__ = ["main", "run"]


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-m", type=int, default=14)
    ap.add_argument("--ring", choices=["zq", "rq"], default="zq")
    ap.add_argument("--N", type=int, default=8192)
    ap.add_argument("--n-inner", type=int, default=4096)
    ap.add_argument("--L", type=int, default=1)
    ap.add_argument("--margin", type=int, default=6)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--out", default=None, help="append the row to this file")
    return ap.parse_args(argv)


def run(args):
    """(row, outputs): the row and the prover's per-limb (a_full, b_full, H)."""
    from ..models.synthetic import build_synthetic_square_chain
    from ..native.cpu_prover import groth16_prover_cpu
    from ..reductions.r1cs_to_qrp import _assignment_batches

    native_binding()
    M = 1 << args.log_m
    N = 1 if args.ring == "zq" else args.N
    params = bench_params(args.L, N, args.n_inner, args.log_m, args.margin, "cpu")
    ring, ectx = params.ring, params.enc
    t0 = time.perf_counter()
    comp, primary, aux = build_synthetic_square_chain(ring, M, np.random.default_rng(0))
    full, _, _ = _assignment_batches(ring, primary, aux)
    log(f"[build] {time.perf_counter() - t0:.3f} s")
    timings, outputs = groth16_prover_cpu(comp, ectx, full.res, aux.res,
                                          np.random.default_rng(11), threads=args.threads)
    row = {
        "metric": f"cpu_full_prover_{args.ring}_2e{args.log_m}",
        "unit": "s",
        "value": timings["total_s"],
        "witness_map_s": timings["witness_map_s"],
        "mac_s": timings["mac_s"],
        "threads": timings["threads"],
        "cpu_model": host_cpu(),
        "config": {"M": M, "ring": args.ring, "N": N, "L": args.L, "n_inner": args.n_inner,
                   "L_inner": ectx.L_inner},
    }
    log(f"[cpu-full] {timings['threads']} threads ({row['cpu_model']}): witness map "
        f"{timings['witness_map_s']:.3f} s + MACs {timings['mac_s']:.3f} s")
    return row, outputs


def main(argv: list[str] | None = None) -> dict:
    args = _parse(argv)
    row, _ = run(args)
    return emit(row, args.out)


if __name__ == "__main__":
    main()
