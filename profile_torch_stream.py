#!/usr/bin/env python3
"""Profile one encrypt-and-MAC pass of the streamed ringGroth16 prover on one GPU.

    python3 profile_torch_stream.py              # 1024 CRS rows, 4 plaintexts
    python3 profile_torch_stream.py --rows 2048

At `chip_smoke.py`'s streamed configuration (Rq N=8192, L=1, N'=16384,
L'=4: FULL_STREAMED), one pass of `streamed._encode_mac` over `--rows`
random CRS rows (two row sub-chunks of 512 at 1024 rows) with 4 random
plaintext batches folded into the MACs, as phase 7 runs it, after one
warm-up pass.  `torch.profiler` (CPU and CUDA activities) records the pass;
the script prints the wall time, the device's busy time (the sum of every
kernel's device time), its idle share, the NTT kernels' time and share of
the busy time, and the ten kernels with the most device time.  The last
line is a JSON object with those numbers.  Needs a GPU; exits nonzero
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--plaintexts", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_stream: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke
    from ringsnark_tpu_torch.encoding.context import keygen
    from ringsnark_tpu_torch.snark import streamed
    from ringsnark_tpu_torch.utils import prng

    params = chip_smoke.make_params(chip_smoke.FULL_STREAMED, "cuda")
    ring, ectx = params.ring, params.enc
    _, sk = keygen(ectx, np.random.default_rng(1))
    gen = torch.Generator(device="cuda").manual_seed(3)

    def residues(n):
        return torch.cat([torch.randint(0, p, (n, 1, ring.N), generator=gen, dtype=torch.int32,
                                        device="cuda") for p in ring.primes], dim=1)

    crs, pts = residues(args.rows), [residues(args.rows) for _ in range(args.plaintexts)]
    shape = (ectx.L, ectx.L_inner, ectx.n_inner)
    accs = [tuple(torch.zeros(shape, dtype=torch.int64, device="cuda") for _ in range(2))
            for _ in pts]
    rec = streamed.StreamRecord(sync=False)

    def one_pass():
        streamed._encode_mac(ectx, sk, lambda a, b: crs[a:b], args.rows, pts, 0, prng.key(5),
                             4096, accs, rec, "profile")

    one_pass()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    ntt = sum(_device_us(e) for e in kernels if any(k in e.key for k in NTT_KERNELS)) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    print(f"gpu: {chip_smoke.gpu_line()}", flush=True)
    print(f"one pass of {args.rows} rows, {args.plaintexts} plaintexts: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle {100 * (1 - busy / wall):.1f} %, NTT kernels "
          f"{ntt:.4f} s ({100 * ntt / busy:.1f} % of busy)", flush=True)
    for e in top:
        print(f"  {_device_us(e) / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:100]}", flush=True)
    print(json.dumps({"rows": args.rows, "plaintexts": args.plaintexts, "wall_s": wall,
                      "busy_s": busy, "idle_share": 1 - busy / wall, "ntt_s": ntt,
                      "ntt_share_of_busy": ntt / busy,
                      "top": [[e.key[:100], _device_us(e) / 1e6, e.count] for e in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
