"""Timers, traces and the NTT's roofline.

Port of ``ringsnark_tpu/utils/profiling.py``: structured wall-clock timers
(``Timings``, ``timer``), a ``torch.profiler`` trace, and ``ntt_roofline``.
A timer ends with ``torch.cuda.synchronize`` on a CUDA device, so the work
it encloses is done when it reads the clock, and with nothing on the CPU,
where every op has finished when it returns.  The roofline's memory floor
is measured on the device (a device-to-device copy), never a constant.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import time
from dataclasses import dataclass
from functools import lru_cache

import torch

__all__ = ["timer", "Timings", "Timing", "trace", "ntt_roofline", "copy_bytes_per_s", "log"]

log = logging.getLogger("ringsnark_tpu_torch")


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Timing:
    """What `timer` measured: its name and, once the block has ended, seconds."""

    name: str
    seconds: float | None = None


class Timings:
    """Accumulates named wall-clock timings; printable as a table or JSON."""

    def __init__(self):
        self.records: dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, name: str, device=None):
        """Add the block's seconds to records[name]; with a CUDA `device`,
        synchronize it before reading the clock at both ends."""
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            self.records[name] = self.records.get(name, 0.0) + (time.perf_counter() - t0)

    def as_json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.records.items()})

    def __repr__(self):
        width = max((len(k) for k in self.records), default=4)
        return "\n".join(f"{k:<{width}}  {v * 1e3:10.3f} ms" for k, v in self.records.items())


@contextlib.contextmanager
def timer(name: str, device=None):
    """Time the block (synchronizing a CUDA `device` at both ends), log it at
    INFO and yield a `Timing` whose `seconds` is set when the block ends."""
    rec = Timing(name)
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        _sync(device)
        rec.seconds = time.perf_counter() - t0
        log.info("[TIME] %s: %.3f ms", name, rec.seconds * 1e3)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host ops, and CUDA kernels
    where a card is present), written to `logdir` as a Chrome trace; yields
    the profiler (``key_averages()`` for sums by kernel)."""
    from pathlib import Path

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


@lru_cache(maxsize=None)
def copy_bytes_per_s(device: str = "cuda") -> float:
    """The device's memory rate, measured: bytes read plus bytes written per
    second by a copy within the device (CUDA events after a warm-up on a
    card, 256 MiB, five times the L2 cache; the host clock on the CPU,
    16 MiB), best of five."""
    dev = torch.device(device)
    nbytes = 1 << (28 if dev.type == "cuda" else 24)
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=dev).fill_(1)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = math.inf
    for _ in range(5):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            dst.copy_(src)
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            dst.copy_(src)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return 2 * nbytes / best


def ntt_roofline(N: int, L: int, batch: int, seconds: float, device: str = "cuda") -> dict:
    """Roofline numbers of a batched NTT run of `batch` x `L` transforms of
    size `N` that took `seconds`: the bytes it must move (each int32 residue
    read once and written once), the least time the device could take for
    them at its measured copy rate (`copy_bytes_per_s`), and the run's share
    of that floor; the butterflies and their integer operations (one Shoup
    multiply and an add, a subtract and their reductions: ~12 each)."""
    stages = int(math.log2(N))
    butterflies = batch * L * N // 2 * stages
    bytes_moved = batch * L * N * 4 * 2
    rate = copy_bytes_per_s(device)
    floor_s = bytes_moved / rate
    return {
        "butterflies": butterflies,
        "int_ops": butterflies * 12,
        "int_ops_per_s": butterflies * 12 / seconds,
        "bytes_moved": bytes_moved,
        "achieved_GBps": bytes_moved / seconds / 1e9,
        "copy_GBps": rate / 1e9,
        "floor_s": floor_s,
        "share_of_floor": floor_s / seconds,
    }
