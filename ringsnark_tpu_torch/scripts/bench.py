"""The north-star NTT on the card: N=8192, 6 limbs, batch 32 (the repository's
``bench.py``).

Prints one JSON line::

  {"metric": "ntt_neg_8192_6limb", "value": <NTTs/s>, "unit": "ntt/s",
   "vs_baseline": <ratio to the native C++ CPU leg on all threads>, ...}

One NTT is a full 6-limb negacyclic forward transform of one degree-8192
polynomial over ``find_ntt_primes(6, 2^21)``.  Legs:

* kernel: ``ops.ntt.negacyclic_ntt_rev`` / ``negacyclic_intt_nat`` on the
  card, so ``csrc/ntt.cu:ntt_kernel``.  A chain of REP dependent transforms
  is captured once in a CUDA graph and replayed between two CUDA events,
  best of TRIES: at this size a launch from the host costs about as much as
  the transform, so the graph gives the card's time per transform; the same
  chain launched from the host is reported beside it (``*_eager_us``);
* plain: the plain PyTorch twin, the same chain (a comparison leg; never
  used in the kernel's place).  With ``--cpu`` it is the only transform leg;
* cpu: the native C++ library (OpenMP): one thread on the first
  BASE_BATCH rows (as ``bench.py`` runs it), all threads on the whole
  batch, so that each thread has rows to transform.

Self-checks, each raising: the kernel equals the plain twin on the whole
batch in both directions (``max_abs_err`` is the largest difference,
measured); the kernel's output (the twin's with ``--cpu``) equals the
native output on the whole batch; no leg beats the memory
bound, one read and one write of every residue (32 x 6 x 8192 int32 =
12.6 MB: 3.76 us at 3.35 TB/s on the card; at the measured copy rate with
``--cpu``).

    python -m ringsnark_tpu_torch.scripts.bench [--batch 32] [--rep 10] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .common import (HBM_BYTES_PER_S, card, device_for, emit, event_seconds, host_cpu, log,
                     native_binding)

__all__ = ["main", "check_bound"]

N, L, BATCH = 8192, 6, 32
REP, TRIES = 10, 5
BASE_BATCH = 4  # rows the one-thread CPU leg transforms


def inputs(primes: tuple, batch: int) -> np.ndarray:
    """uint32 [batch, L, N] residues, drawn as ``bench.py`` draws them."""
    rng = np.random.default_rng(0)
    return np.stack([np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in primes])
                     for _ in range(batch)]).astype(np.uint32)


def check_bound(leg: str, seconds: float, bound_s: float) -> float:
    """The leg's share of the memory bound; raises above 100 %."""
    share = bound_s / seconds
    if share > 1.0:
        raise RuntimeError(f"{leg}: {seconds * 1e6:.2f} us beats the memory bound "
                           f"{bound_s * 1e6:.2f} us ({100 * share:.1f} %): measurement invalid")
    return share


def _chain_seconds(step, x, rep: int, device: str, graph: bool) -> float:
    """Seconds per transform of `rep` dependent applications of `step`, best
    of TRIES; with `graph`, the chain captured once in a CUDA graph."""

    def run():
        v = x
        for _ in range(rep):
            v = step(v)
        return v

    fn = run
    if graph:
        run()  # tables and allocator warm before the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        fn = g.replay
    fn()
    return min(event_seconds(fn, device) for _ in range(TRIES)) / rep


def _native_legs(x_np: np.ndarray, primes: tuple, plan) -> dict:
    """The native C++ transforms, best of three each: one thread on the first
    BASE_BATCH rows, all threads on the whole batch; returns their seconds,
    rows and the whole batch's output."""
    native = native_binding()
    threads = native.max_threads()
    one_rows, rows = min(BASE_BATCH, len(x_np)), len(x_np)

    def run(n, rows):
        native.set_threads(n)
        out = np.empty((rows, L, N), dtype=np.uint32)
        t0 = time.perf_counter()
        for l, p in enumerate(primes):
            out[:, l] = native.negacyclic_ntt(x_np[:rows, l], p, plan.w_np[l],
                                              int(plan.psi[l, 1]))
        return time.perf_counter() - t0, out

    run(threads, rows)  # warm
    one = min(run(1, one_rows)[0] for _ in range(3))
    socket, out = min((run(threads, rows) for _ in range(3)), key=lambda r: r[0])
    native.set_threads(threads)
    return {"one_s": one, "one_rows": one_rows, "socket_s": socket, "threads": threads,
            "rows": rows, "out": out}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--rep", type=int, default=REP, help="dependent transforms per timed chain")
    ap.add_argument("--cpu", action="store_true", help="run the plain twin on the CPU")
    args = ap.parse_args(argv)

    from ..ops import ntt as nttm
    from ..ops.primes import find_ntt_primes
    from ..utils.profiling import copy_bytes_per_s, ntt_roofline

    device = device_for(args.cpu)
    on_card = device == "cuda"
    dev = card(device)
    B = args.batch
    primes = tuple(find_ntt_primes(L, 1 << 21))
    plan = nttm.get_plan(primes, N, negacyclic=True)
    x_np = inputs(primes, B)
    x = torch.from_numpy(x_np.view(np.int32)).to(device)
    log(f"[bench] {dev['name']} ({dev.get('power_limit', 'cpu')}); [{B}, {L}, {N}] negacyclic")

    bytes_moved = B * L * N * 4 * 2
    rate = HBM_BYTES_PER_S if on_card else copy_bytes_per_s("cpu")
    bound_s = bytes_moved / rate
    fwd, inv = nttm.negacyclic_ntt_rev, nttm.negacyclic_intt_nat
    plain = {False: nttm.negacyclic_ntt_rev_plain, True: nttm.negacyclic_intt_nat_plain}

    def step(fn):
        return lambda v: fn(v, plan)

    want = {inverse: plain[inverse](x, plan) for inverse in (False, True)}
    row = {"metric": "ntt_neg_8192_6limb", "unit": "ntt/s", "shape": [B, L, N],
           "primes": list(primes), "card": dev, "bytes_moved": bytes_moved,
           "bound_us": bound_s * 1e6, "bound_rate_GBps": rate / 1e9}
    legs = {}
    if on_card:
        row["max_abs_err"] = 0
        for inverse, fn in ((False, fwd), (True, inv)):
            got = fn(x, plan)
            err = int((got.to(torch.int64) - want[inverse].to(torch.int64)).abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not torch.equal(got, want[inverse]):
                raise RuntimeError(f"kernel {'inverse' if inverse else 'forward'} != plain twin "
                                   f"at [{B}, {L}, {N}]")
            tag = "kernel_inv" if inverse else "kernel"
            legs[tag] = _chain_seconds(step(fn), x, args.rep, device, graph=True)
            row[f"{tag}_eager_us"] = _chain_seconds(step(fn), x, args.rep, device,
                                                    graph=False) * 1e6
    for inverse in (False, True):
        legs["plain_inv" if inverse else "plain"] = _chain_seconds(
            step(plain[inverse]), x, args.rep, device, graph=False)
    for leg, dt in legs.items():
        row[f"{leg}_us"] = dt * 1e6
        row[f"{leg}_share_of_bound"] = check_bound(leg, dt, bound_s)
    best = legs["kernel"] if on_card else legs["plain"]
    ntts_per_s = B / best
    row["us_per_transform"] = best / B * 1e6
    if on_card:
        rl = ntt_roofline(N, L, B, best, device)
        row["copy_GBps"], row["share_of_copy_floor"] = rl["copy_GBps"], rl["share_of_floor"]
        row["int_ops_per_s"] = rl["int_ops_per_s"]

    cpu = _native_legs(x_np, primes, plan)
    base = (fwd(x, plan) if on_card else want[False]).cpu().numpy()
    if not np.array_equal(base.view(np.uint32), cpu["out"]):
        raise RuntimeError("the transform differs from the native C++ output")
    ntts_1core = cpu["one_rows"] / cpu["one_s"]
    ntts_socket = cpu["rows"] / cpu["socket_s"]
    row.update(value=ntts_per_s, vs_baseline=ntts_per_s / ntts_socket,
               vs_1core=ntts_per_s / ntts_1core, cpu_ntts_1core=ntts_1core,
               cpu_ntts_socket=ntts_socket, cpu_rows_1core=cpu["one_rows"],
               cpu_rows_socket=cpu["rows"], cpu_threads=cpu["threads"], cpu_model=host_cpu())
    log(f"[bench] {'kernel' if on_card else 'plain twin'}: {best * 1e6:.2f} us / batch of {B}, "
        f"{row['us_per_transform']:.3f} us a transform, {ntts_per_s:.1f} ntt/s, "
        f"{100 * bound_s / best:.1f} % of the memory bound ({bound_s * 1e6:.2f} us); "
        f"cpu {ntts_1core:.1f} ntt/s on 1 thread ({cpu['one_rows']} rows), {ntts_socket:.1f} on "
        f"{cpu['threads']} ({cpu['rows']} rows, {row['cpu_model']})")
    return emit(row, None)


if __name__ == "__main__":
    main()
