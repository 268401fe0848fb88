"""What the entry-point scripts share: the device they run on, the card's
name and power limit, the benchmark parameters, timing and output.

Nothing here falls back: a script asked to run on the card raises where
there is no card, and runs on the CPU only when its caller says so
(``--cpu``)."""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "device_for", "native_binding", "sync", "card", "host_cpu",
           "bench_params", "timed", "event_seconds", "reset_peak", "peak_gib", "log", "emit"]

# the published memory rate of one H100 SXM (HBM3), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12


def device_for(cpu: bool) -> str:
    """"cpu" when asked for, else the card; raises where there is none."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: these scripts run on the card unless given --cpu")
    return "cuda"


def native_binding():
    """The port's ``native`` module with its library built and loaded; a
    failed build or load raises with the compiler's or the loader's message
    (``native.available()`` only says False)."""
    import ctypes

    from .. import native

    ctypes.CDLL(str(native.build()))
    return native


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card(device: str) -> dict:
    """The device a row was measured on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them, or the host's
    CPU model and thread count."""
    if torch.device(device).type == "cuda":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.rsplit(",", 1))
        return {"device": "cuda", "name": name, "power_limit": limit,
                "torch": torch.__version__, "cuda": torch.version.cuda}
    return {"device": "cpu", "name": host_cpu(), "threads": torch.get_num_threads(),
            "torch": torch.__version__}


def host_cpu() -> str:
    """The host's CPU model: /proc/cpuinfo's ``model name``, or where the
    host hides it (a virtual machine may print "unknown") its vendor,
    family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return platform.processor() or platform.machine() or "unknown"


def bench_params(L: int, N: int, n_inner: int, log_m: int, margin: int, device: str):
    """The squaring chain's parameters as ``bench_prover.py`` makes them: the
    ring of L primes with roots of order max(4M, 2N', 4N), the inner chain
    that `plan_inner_chain` gives for M+1 terms at `margin` bits."""
    from ..encoding import EncodingContext
    from ..encoding.context import default_inner_primes
    from ..encoding.noise import plan_inner_chain
    from ..rings.context import default_context
    from ..snark.api import SnarkParams

    M = 1 << log_m
    ring = default_context(L=L, N=N, order=max(1 << (log_m + 2), 2 * n_inner, 4 * N),
                           device=device)
    L_inner, floor = plan_inner_chain(n_inner, 31, M + 1, margin_bits=margin, dense=N > 1)
    ectx = EncodingContext(ring=ring, n_inner=n_inner,
                           inner_primes=default_inner_primes(n_inner, ring.primes, L_inner),
                           floor_limbs=floor)
    return SnarkParams(ring=ring, enc=ectx)


def timed(fn, device: str):
    """(fn(), seconds) on the host clock between two synchronizes."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def event_seconds(fn, device: str) -> float:
    """Seconds of fn() between two CUDA events on the card (the host clock
    after a synchronize on the CPU)."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def reset_peak(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device: str):
    """The peak allocation on the card since the last reset; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(row: dict, out: str | None) -> dict:
    """Print the row as one JSON line; append it to `out` only when given."""
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    return row
