#!/usr/bin/env python3
"""Profile the resident frontend path's two unexplained costs on one GPU.

    python3 profile_torch_frontend.py
    python3 profile_torch_frontend.py --small     # small shapes (debugging)

At `chip_smoke.py`'s reference shapes (ring L=2, N'=16384):

1. the in-circuit NTT circuit (N=4096, one constraint, 4097 public wires):
   `rinocchio.generator`, then `rinocchio.prover` `--proves` times in a row,
   each timed on the host clock between synchronizes, with the allocator's
   counters (device mallocs, reserved bytes) read after each; then one more
   prove under `torch.profiler`.
2. logistic regression's setup unit: `encode` of 2049 ring elements (one CRS
   block of its keys) and of 8196 (a long batch), each timed over three
   calls after a warm-up, then one call of 2049 rows under `torch.profiler`.

For each profiled call the script prints the wall time, the device's busy
time (the sum of every kernel's device time), its idle share, the NTT
kernels' share of the busy time, the ten kernels with the most device time
and the ten host-side operations with the most self CPU time (where a
`cudaMalloc`, a `cudaStreamSynchronize` or an `aten::item` would show).  The
last line is a JSON object with those numbers.  Needs a GPU; exits nonzero
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

NTT_KERNELS = ("ntt_kernel", "outer_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def alloc_stats() -> dict:
    st = torch.cuda.memory_stats()
    return {"device_mallocs": st.get("num_device_alloc", 0),
            "device_frees": st.get("num_device_free", 0),
            "reserved_gib": st.get("reserved_bytes.all.current", 0) / 2**30,
            "allocated_gib": st.get("allocated_bytes.all.current", 0) / 2**30}


def profiled(label, fn) -> dict:
    """One call of fn under torch.profiler: wall, busy, idle, top kernels and
    top host operations."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(fn)
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    host = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    ntt = sum(_device_us(e) for e in kernels if any(k in e.key for k in NTT_KERNELS)) / 1e6
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    print(f"{label} (under the profiler): wall {wall:.4f} s, device busy {busy:.4f} s, idle "
          f"{100 * (1 - busy / wall):.1f} %, {launches} kernel launches, NTT kernels {ntt:.4f} s "
          f"({100 * ntt / max(busy, 1e-12):.1f} % of busy)", flush=True)
    for e in top:
        print(f"  device {_device_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
    for e in top_host:
        print(f"  host   {e.self_cpu_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}",
              flush=True)
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall, "launches": launches,
            "ntt_share_of_busy": ntt / max(busy, 1e-12),
            "top": [[e.key[:90], _device_us(e) / 1e6, e.count] for e in top],
            "top_host": [[e.key[:90], e.self_cpu_time_total / 1e6, e.count] for e in top_host]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--proves", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frontend: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke
    from ringsnark_tpu_torch.encoding import encode, keygen
    from ringsnark_tpu_torch.rings.elem import RingElem
    from ringsnark_tpu_torch.snark import rinocchio
    from ringsnark_tpu_torch.utils import prng

    circuits = chip_smoke.SMALL_CIRCUITS if args.small else chip_smoke.REFERENCE_CIRCUITS
    print(f"gpu: {chip_smoke.gpu_line()}", flush=True)
    out = {}

    # 1. the in-circuit NTT's Rinocchio prove, call after call
    cfg = circuits["incircuit_ntt"]
    params = chip_smoke.make_circuit_params(cfg, "cuda")
    pb = chip_smoke.build_circuit("incircuit_ntt", cfg, params.ring, 0)
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    torch.cuda.empty_cache()
    kp, setup_s = timed(lambda: rinocchio.generator(pb.get_constraint_system(), params,
                                                    np.random.default_rng(1), prng.key(1)))
    print(f"incircuit_ntt N={cfg['N']}: setup {setup_s:.4f} s; {alloc_stats()}", flush=True)
    proves, kept = [], []
    for i in range(args.proves):
        proof, s = timed(lambda: rinocchio.prover(kp.pk, primary, aux, np.random.default_rng(7)))
        if i < 2:
            kept.append(proof)  # as chip_smoke holds its cold and warm proofs
        st = alloc_stats()
        proves.append({"s": s, **st})
        print(f"  prove {i}: {s:.4f} s; {st}", flush=True)
    out["incircuit_ntt_rinocchio"] = {
        "setup_s": setup_s, "proves": proves,
        "profile": profiled("incircuit_ntt rinocchio.prover", lambda: rinocchio.prover(
            kp.pk, primary, aux, np.random.default_rng(7)))}
    del kp, kept, proof, pb, primary, aux
    torch.cuda.empty_cache()

    # 2. encode on a short and on a long batch at logreg's parameters
    cfg = circuits["logreg"]
    params = chip_smoke.make_circuit_params(cfg, "cuda")
    ring, ectx = params.ring, params.enc
    rng = np.random.default_rng(2)
    _, sk = keygen(ectx, rng)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def scalars(rows):  # CRS rows are scalar ring elements, [rows, L, 1]
        return RingElem(ring, torch.cat([torch.randint(
            0, p, (rows, 1, 1), generator=gen, dtype=torch.int32, device="cuda")
            for p in ring.primes], dim=1))

    short, long_ = (9, 36) if args.small else (2049, 8196)
    enc_out = {}
    for rows in (short, long_):
        vals = scalars(rows)
        timed(lambda: encode(ectx, sk, vals, prng.key(4)))  # warm-up
        times = [timed(lambda: encode(ectx, sk, vals, prng.key(4)))[1] for _ in range(3)]
        per = [1e3 * t / (rows * ring.L) for t in times]
        print(f"encode of {rows} rows, L={ring.L}, N'={ectx.n_inner}, L'={ectx.L_inner}: "
              f"{[f'{t:.4f}' for t in times]} s = {[f'{x:.4f}' for x in per]} ms per limb-row",
              flush=True)
        enc_out[str(rows)] = {"s": times, "ms_per_limb_row": per}
    vals = scalars(short)
    enc_out["profile"] = profiled(f"encode of {short} rows",
                                  lambda: encode(ectx, sk, vals, prng.key(4)))
    out["encode_logreg"] = enc_out
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
