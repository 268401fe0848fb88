"""The one-time cost of the kernels' library in a fresh process: the CUDA
context, loading the library that ``cuda_ntt.build()`` makes, and the first
launch of each kernel against its later launches.  Under
``CUDA_MODULE_LOADING=LAZY`` (PyTorch's default) the library's module is
loaded at its first launch and each kernel at its own; under ``EAGER`` the
module and every kernel load when the library does.

    CUDA_MODULE_LOADING=LAZY python3 ringsnark_tpu_torch/scripts/load_cost.py \\
        [--cell rq8192_g16_resident_2e14 --setups 4]

Imports the package absolutely, so ``PYTHONPATH`` picks the tree it times
(two trees compare in one call).  With ``--cell``, the cell's set-up
(``bench_torch.traffic.prepare``) and `--setups` generator runs, each from
a freed card as ``bench_torch``'s resident traffic times them, follow the
library's load and precede every other launch here, so the first of them
pays what a benchmark run's first setup pays.  Prints one JSON object:
seconds for each step (the CUDA context, PyTorch's first launch, the
library's load, and per kernel its ``first`` call and the median of five
``warm`` ones), the library's size in bytes and the card's name and power
limit.  Needs the card and a built library (it builds one if there is
none, and reports that time apart).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch


def _sync():
    torch.cuda.synchronize()


def _seconds(fn):
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t0


def _first_and_warm(fn, warm: int = 5) -> dict:
    first = _seconds(fn)
    return {"first": first, "warm": statistics.median(_seconds(fn) for _ in range(warm))}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _setups(name: str, count: int) -> dict:
    from bench_torch import cells, traffic

    cell = cells.load(name)
    t0 = time.perf_counter()
    params, circ = traffic.prepare(cell, "cuda", 0)
    _sync()
    prepare_s = time.perf_counter() - t0
    setups = []
    for _ in range(count):
        traffic._free("cuda")
        setups.append(_seconds(lambda: traffic._setup(cell, params, circ, 0)))
    return {"cell": name, "prepare_s": prepare_s, "setups": setups}


def _kernels() -> dict:
    """First and warm launches of the draw, the generator's NTT, lift and
    encryption, and both MACs, at the north star's widths."""
    from ringsnark_tpu_torch.encoding import bgv, keygen, mac
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.scripts.common import bench_params
    from ringsnark_tpu_torch.utils import prng

    out = {"draw": _first_and_warm(lambda: cuda_prng.bits(prng.key(1), (64, 1024), "cuda"))}
    ctx = bench_params(1, 8192, 16384, 18, 10, "cuda").enc
    ring, rows = ctx.ring, 8
    g = torch.Generator(device="cuda").manual_seed(2)
    slots = torch.cat([torch.randint(0, p, (rows, 1, ring.N), generator=g, dtype=torch.int32,
                                     device="cuda") for p in ring.primes], dim=1)
    _, sk = keygen(ctx, np.random.default_rng(3))
    out["ntt"] = _first_and_warm(lambda: bgv.plain_to_inner_ntt(ctx, slots))
    out["encrypt"] = _first_and_warm(lambda: bgv.encrypt(ctx, sk, slots, prng.key(4)))
    c0, c1 = bgv.encrypt(ctx, sk, slots, prng.key(5))
    pts = [bgv.plain_to_inner_ntt(ctx, slots)] * 2
    accs = [tuple(torch.zeros(c0.shape[1:], dtype=torch.int64, device="cuda")
                  for _ in range(2)) for _ in pts]
    out["mac"] = _first_and_warm(lambda: mac.mac_rows(ctx, 0, c0, c1, pts, accs))
    drawn = mac.Drawn(prng.key(6), (rows,), (0, rows))
    out["mac_drawn"] = _first_and_warm(lambda: mac.mac_rows(ctx, 0, c0, drawn, pts, accs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", help="a resident cell of BENCHMARK.json whose setups to time")
    ap.add_argument("--setups", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("load_cost: needs the card")
    t0 = time.perf_counter()
    import ringsnark_tpu_torch
    from ringsnark_tpu_torch.ops import cuda_ntt

    row = {"package": os.path.dirname(ringsnark_tpu_torch.__file__),
           "module_loading": os.environ.get("CUDA_MODULE_LOADING", "(unset)"),
           "import_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    torch.cuda.init()
    _sync()
    row["context_s"] = time.perf_counter() - t0
    row["first_torch_launch_s"] = _seconds(lambda: torch.zeros(1, device="cuda"))
    t0 = time.perf_counter()
    path = cuda_ntt.build().path
    row["build_s"] = time.perf_counter() - t0
    row["library_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    cuda_ntt._lib()
    row["load_library_s"] = time.perf_counter() - t0
    if args.cell:
        row["setup"] = _setups(args.cell, args.setups)
    row["kernels"] = _kernels()
    row["card"] = _card()
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
