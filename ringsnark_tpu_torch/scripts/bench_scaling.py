"""Scaling structure of the sharded prover's sections at 1, 2, 4 and 8 ranks
(the repository's ``bench_scaling.py``).

For each world size D, D ranks are started (``parallel/dryrun.spawn``):
one per card over NCCL, or gloo ranks on the CPU with ``--cpu`` (with fewer
cards than ranks it raises).  Every rank runs two sections:

* coeff_sharded_ntt_fwd: the coefficient-sharded negacyclic NTT
  (``parallel.make_sharded_ntt``) of [8, 2, 4096] residues, M/D
  coefficients a rank, log2(D) exchange stages; its blocks must equal the
  single-device transform's;
* data_sharded_mac: the MAC of 2048 rows of [3, 1024] residues, a row
  block a rank, the exact int64 sums ``all_reduce``d over 'data' and then
  reduced; it must equal the unsharded result.

One row per (section, D): the wall seconds of one call (mean of a few, the
ranks synchronized before and after) and the collective traffic the
program's structure implies (the NTT: log2(D) exchanges of half a block a
rank; the MAC: one [L', N'] int64 sum).  Ranks on the CPU share its cores,
so there the times show the overhead of sharding, not its speed-up.

    python -m ringsnark_tpu_torch.scripts.bench_scaling [--D 1 2 4 8] [--cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .common import card, device_for, emit, log

__all__ = ["main"]

M, L, BATCH = 4096, 2, 8  # the sharded NTT
B, LP, NP = 2048, 3, 1024  # the sharded MAC
NTT_REPS, MAC_REPS = 5, 10


def _wall(fn, reps: int, device: str) -> float:
    """Seconds per call of fn, every rank in step before and after."""
    import torch.distributed as dist

    fn()  # warm
    if device != "cpu":
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device != "cpu":
        torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) / reps


def _rank(rank: int, D: int, device_type: str, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..ops import ntt as nttm
    from ..ops import primes as pr
    from ..parallel.mesh import block, init_rank
    from ..parallel.ntt_sharded import make_sharded_ntt

    init_rank(rank, D, Path(tmp) / "pg", device_type)
    try:
        device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
        rng = np.random.default_rng(0)
        primes = tuple(pr.find_ntt_primes(L, 2 * M))
        plan = nttm.get_plan(primes, M, negacyclic=True)
        x = torch.as_tensor(np.stack(
            [np.stack([rng.integers(0, q, M, dtype=np.uint64) for q in primes])
             for _ in range(BATCH)]).astype(np.int32), device=device)
        cmesh = init_device_mesh(device_type, (D,), mesh_dim_names=("coeff",))
        own = slice(rank * (M // D), (rank + 1) * (M // D))
        xs = x[:, :, own].contiguous()
        fwd = make_sharded_ntt(plan, cmesh, negacyclic=True)
        if not torch.equal(fwd(xs), nttm.negacyclic_ntt_rev(x, plan)[:, :, own]):
            raise RuntimeError(f"rank {rank}: the sharded NTT's block differs")
        ntt_s = _wall(lambda: fwd(xs), NTT_REPS, device)

        qs = tuple(pr.find_ntt_primes(LP, 2 * NP))
        p = torch.tensor(qs, dtype=torch.int64, device=device)[:, None]
        c0 = rng.integers(0, qs[0], (B, LP, NP), dtype=np.uint64).astype(np.int64)
        w = rng.integers(0, qs[0], (B, LP, NP), dtype=np.uint64).astype(np.int64)
        rows = block(B, D, rank)
        c_t = torch.as_tensor(c0[rows], device=device)
        w_t = torch.as_tensor(w[rows], device=device)

        def mac():
            s = torch.remainder(c_t * w_t, p).sum(0)
            dist.all_reduce(s)  # the sum over 'data'
            return torch.remainder(s, p)

        want = np.sum((c0 * w) % np.array(qs, dtype=np.int64)[:, None], axis=0) % np.array(
            qs, dtype=np.int64)[:, None]
        if not np.array_equal(mac().cpu().numpy(), want):
            raise RuntimeError(f"rank {rank}: the data-sharded MAC differs")
        mac_s = _wall(mac, MAC_REPS, device)
        if rank == 0:
            (Path(tmp) / "report.json").write_text(json.dumps(
                {"ntt_s": ntt_s, "mac_s": mac_s, "backend": dist.get_backend()}))
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> dict:
    """Returns {"rows": [...]}, one row per (section, D)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--D", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="world sizes (ranks) to run")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--out", default=None, help="append the rows to this file")
    args = ap.parse_args(argv)

    from ..parallel.dryrun import spawn

    device = device_for(args.cpu)
    dev = card(device)
    rows = []
    for D in args.D:
        if D & (D - 1) or D > M // 2:
            raise ValueError(f"world size {D} is not a power of two up to {M // 2}")
        if device == "cuda" and torch.cuda.device_count() < D:
            raise RuntimeError(f"{D} ranks need {D} cards, {torch.cuda.device_count()} visible")
        with tempfile.TemporaryDirectory(prefix="ringsnark_scaling_") as tmp:
            t0 = time.perf_counter()
            spawn(_rank, D, (D, device, tmp))
            rep = json.loads((Path(tmp) / "report.json").read_text())
        log(f"[scaling] D={D} over {rep['backend']}: ranks up and done in "
            f"{time.perf_counter() - t0:.1f} s")
        k = D.bit_length() - 1
        for section, dt, traffic, note in (
            ("coeff_sharded_ntt_fwd", rep["ntt_s"], k * BATCH * L * (M // D) * 4 * D,
             "log2(D) batch_isend_irecv exchange stages"),
            ("data_sharded_mac", rep["mac_s"], LP * NP * 8 * (D - 1),
             "one [L', N'] int64 all_reduce (the only cross-host collective)"),
        ):
            log(f"[scaling] {section} D={D}: {dt * 1e3:.3f} ms (collectives "
                f"{traffic / 1e6:.3f} MB)")
            rows.append({"section": section, "D": D, "wall_s": dt, "collective_bytes": traffic,
                         "note": note, "backend": rep["backend"], "device": dev["name"]})
    for row in rows:
        emit(row, args.out)
    return {"rows": rows, "card": dev}


if __name__ == "__main__":
    main()
