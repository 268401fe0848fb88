"""The Hopper NTT kernels (``csrc/ntt.cu``): build, ctypes binding, tables, launch.

Port of ``ringsnark_tpu/ops/pallas_ntt.py``: `_ntt_kernel_gridfree` (all
four modes, ``ntt``) and the split large-M path `ntt_split_pallas` with its
`_outer_kernel` (``ntt_split``).  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use, from the sources in this package, into
``ringsnark_tpu_torch/_build/`` (a shared library with a plain C interface,
loaded with ctypes).  Nothing is built or loaded at import time.  ``build``
compiles every CUDA source of the package (``csrc/ntt.cu``, ``csrc/prng.cu``,
``csrc/mac.cu`` and ``csrc/witness.cu``, which share ``csrc/modarith.cuh``;
``prng.cu`` and ``mac.cu`` also ``csrc/threefry.cuh``) into that one
library, so each build of the NTT kernels also builds the draws and the
encryption of ``ops/cuda_prng.py``, the MAC of ``ops/cuda_mac.py`` and the
witness map's kernels of ``ops/cuda_witness.py``.

``ntt`` is one launch of the register-radix shared-memory kernel; its
schedule (``geometry``, ``kernel_passes``, ``swizzle``, ``outer_passes``)
lives here as well as in the source, so the CPU tests can replay it.
``ntt_split`` is the outer kernel (factored twiddles; one pass up to
R = 32, passes of at most five stages above) and the shared-memory kernel
over the ``[B, L, R, mi]`` view.

The wrappers take only int32 CUDA tensors ``[B, L, M]`` (contiguous) and
raise on anything else; a failed build or a refused or failed launch
raises too, nothing falls back.  The plain versions live in ``ops/ntt.py``
(the twins and ``ntt_split_plain``).

``launch_counts`` holds one plain integer per mode, incremented where a
wrapper launches its kernel and nowhere else: ``ntt`` counts its mode
(``cyclic_fwd`` ...), ``ntt_split`` counts ``split_<mode>`` once per call
(its inner pass, where it has one, is part of it and is not counted as
``<mode>``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .ntt import NTTPlan, _mod_powers, bitrev_indices, check_scale, get_plan, shoup_np, split_mi
from .primes import root_of_unity

__all__ = ["build", "ntt", "ntt_split", "geometry", "kernel_passes", "outer_passes",
           "launch_counts", "reset_launch_counts", "mode_name", "MODES", "SPLIT_MODES",
           "CTA_ORDERS"]

_PKG = Path(__file__).resolve().parent.parent
# every source of the library, and the header they include (hashed with them)
SOURCES = (_PKG / "csrc" / "ntt.cu", _PKG / "csrc" / "prng.cu", _PKG / "csrc" / "mac.cu",
           _PKG / "csrc" / "witness.cu")
HEADERS = (_PKG / "csrc" / "modarith.cuh", _PKG / "csrc" / "threefry.cuh")
BUILD_DIR = _PKG / "_build"

MODES = ("negacyclic_fwd", "negacyclic_inv", "cyclic_fwd", "cyclic_inv")
SPLIT_MODES = tuple(f"split_{m}" for m in MODES)
launch_counts = {m: 0 for m in MODES + SPLIT_MODES}

# CTA order of the shared-memory kernel over a [B, L, M] batch: "row" takes
# the transforms in memory order (limb fastest), "limb" all rows of limb 0
# first (the JAX package's lbm order, without its transposes).
CTA_ORDERS = ("row", "limb")
CTA_ORDER = "row"


def reset_launch_counts():
    for m in launch_counts:
        launch_counts[m] = 0


def mode_name(inverse: bool, negacyclic: bool) -> str:
    return f"{'negacyclic' if negacyclic else 'cyclic'}_{'inv' if inverse else 'fwd'}"


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build csrc/*.cu")


@dataclass(frozen=True)
class BuildResult:
    path: Path
    log: str  # nvcc/ptxas output of the build that made the library


def build() -> BuildResult:
    """Compile ``SOURCES`` into one library unless a library of these exact
    sources and headers exists.  The compiler's output is kept beside the
    library (``.log``) and returned with it either way, so a reused build
    reports the same registers and spills as a fresh one."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES + HEADERS))
    out = BUILD_DIR / f"libringsnark_kernels_{digest.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return BuildResult(out, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), *map(str, SOURCES),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    text = res.stdout + res.stderr
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(text)
    os.replace(tmp, out)
    os.replace(tmp_log, log)
    return BuildResult(out, text)


@lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build().path))
    for name, n_ptr, n_int in (("ringsnark_ntt_launch", 4, 9),
                               ("ringsnark_ntt_outer_launch", 6, 9)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _shoup(vals: np.ndarray, primes: tuple) -> np.ndarray:
    """Shoup constants per limb row of vals."""
    return shoup_np(vals, np.reshape(primes, (-1, *([1] * (np.ndim(vals) - 1)))))


def _pairs(vals: np.ndarray, primes: tuple, device: str) -> torch.Tensor:
    """[L, ...] residues as int32 (value, Shoup constant) pairs [L, ..., 2] on device."""
    vals = np.asarray(vals, dtype=np.uint64)
    a = np.stack([vals, _shoup(vals, primes)], axis=-1).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _words(a, device: str) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# the shared-memory kernel's schedule (mirrors csrc/ntt.cu; the CPU tests
# replay it)
# ---------------------------------------------------------------------------

MAX_THREADS = 512  # a CTA at M = 32768 (one a SM, 128 KiB); 256 below


@dataclass(frozen=True)
class Geometry:
    log_e: int  # log2 of the residues a thread holds per group (E = 32, or M below 32)
    threads: int  # per CTA
    tile_tf: int  # transforms per tile
    iters: int  # groups a thread takes in turn in every pass
    min_ctas: int  # CTAs a SM the registers are capped for (__launch_bounds__)
    M: int


def geometry(M: int) -> Geometry:
    """CTA shape of the shared-memory kernel (`Geo` in csrc/ntt.cu) for
    transforms of size M: 256 threads, a thread holding E = 32 residues (M
    below 32), a tile of 8192 words (several transforms up to M = 4096; 256
    transforms of M below 32) with registers capped for two CTAs a SM;
    M = 16384 a tile of one transform, two groups a thread; M = 32768 512
    threads and one CTA a SM."""
    log_m = M.bit_length() - 1
    log_e = min(5, log_m)
    threads = MAX_THREADS if log_m == 15 else 256
    iters = 2 if log_m >= 14 else 1
    tile_tf = max(1, (threads * iters << log_e) >> log_m)
    return Geometry(log_e, threads, tile_tf, iters, 1 if threads == MAX_THREADS else 2, M)


def kernel_passes(M: int, inverse: bool) -> list:
    """The passes of `ntt_kernel` in execution order, as (d, k): a group
    holds the 2^log_e residues at index distance 2^d and runs the stages on
    its register bits 0 .. k - 1 (index bits d .. d + k - 1).  Forward, the
    top pass first (the global load: stages log2 M - 1 down to log2 M - 5),
    then d = 5 (stages 9 ... 5, where M > 1024) and d = 0 (stages 4 ... 0);
    a size below 1024 has two passes, a size up to 32 one.  The inverse runs
    them in reverse, each stage in the other direction."""
    log_m = M.bit_length() - 1
    if log_m <= 5:
        passes = [(0, log_m)]
    elif log_m < 10:
        passes = [(log_m - 5, 5), (0, log_m - 5)]
    else:
        passes = [(log_m - 5, 5)] + ([(5, log_m - 10)] if log_m > 10 else []) + [(0, 5)]
    return passes[::-1] if inverse else passes


def swizzle(a):
    """Shared-memory word of tile word a (`swz` in csrc/ntt.cu): bits 2..4
    XOR bits 5..7, so that a 16-byte vector stays whole and aligned."""
    return a ^ (((a >> 5) & 7) << 2)


@dataclass(frozen=True)
class KernelTables:
    tw: torch.Tensor  # [L, M, 2] int32 (w, Shoup) pairs: entry k >= 1 the butterfly twiddle of
    #                   tree node k (inverse: its inverse; entry 1 also times M^-1, entry 0
    #                   the root's without M^-1)
    consts: torch.Tensor  # [L, 5]: p, M^-1 and its Shoup constant, 1 and its Shoup constant


def stage_twiddles(primes: tuple, M: int, negacyclic: bool, inverse: bool = False) -> np.ndarray:
    """[L, M] twiddles of the Cooley-Tukey tree, psi merged: the butterfly
    of stage m (m blocks of M/m residues, m = 1, 2, ... M/2) on block i
    multiplies by entry m + i: psi^brv(m + i) (negacyclic; psi^2 = w, brv
    over log2 M bits) or w^brv'(i) (cyclic; brv' over log2 M - 1 bits); the
    inverse's Gentleman-Sande butterflies by their inverses.  Entry 0 is 0."""
    plan = get_plan(primes, M, negacyclic)
    k = np.arange(1, M)
    br = bitrev_indices(M)
    inv = (lambda r, q: pow(int(r), int(q) - 2, int(q))) if inverse else (lambda r, q: int(r))
    if negacyclic:
        roots, exps = [inv(plan.psi[j, 1], q) for j, q in enumerate(primes)], br[k]
    else:
        i = k - (1 << (np.frexp(k.astype(np.float64))[1] - 1))
        roots, exps = [inv(w, q) for w, q in zip(plan.w_np, primes)], br[i] >> 1
    out = np.stack([_mod_powers(r, M, q)[exps] for r, q in zip(roots, primes)])
    return np.concatenate([np.zeros((len(primes), 1), np.uint32), out.astype(np.uint32)], 1)


@lru_cache(maxsize=None)
def _tables(primes: tuple, M: int, inverse: bool, negacyclic: bool, device: str):
    plan = get_plan(primes, M, negacyclic)
    L = len(primes)
    p = np.asarray(primes, dtype=np.uint64)[:, None]
    tw = stage_twiddles(primes, M, negacyclic, inverse).astype(np.uint64)
    minv = plan.minv.astype(np.uint64)  # [L, 1]
    if inverse:  # the root's b-factor unscaled (entry 0), then times M^-1 (entry 1)
        tw[:, 0] = tw[:, 1]
        tw[:, 1:2] = tw[:, 1:2] * minv % p
    one = np.ones((L, 1), np.uint64)
    consts = np.concatenate([p, minv, _shoup(minv, primes), one, _shoup(one, primes)], axis=1)
    return KernelTables(_pairs(tw, primes, device), _words(consts, device))


def _check(x: torch.Tensor, plan: NTTPlan, negacyclic: bool, name: str, inverse: bool = True,
           scale: bool = True):
    check_scale(inverse, negacyclic, scale)
    if x.device.type != "cuda":
        raise ValueError(f"cuda_ntt.{name} needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"cuda_ntt.{name} needs int32 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cuda_ntt.{name} needs a contiguous tensor")
    if negacyclic and not plan.negacyclic:
        raise ValueError("negacyclic transform with a cyclic plan")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, y, primes, M, inverse, negacyclic, rows, S=1, scale=True, order=None):
    """One launch of the shared-memory kernel over ``[rows, L, S, M]``."""
    order = CTA_ORDER if order is None else order
    if order not in CTA_ORDERS:
        raise ValueError(f"CTA order {order!r} is not one of {CTA_ORDERS}")
    tb = _tables(primes, M, inverse, negacyclic, str(x.device))
    geo = geometry(M)
    with torch.cuda.device(x.device):
        rc = _lib().ringsnark_ntt_launch(
            x.data_ptr(), y.data_ptr(), tb.tw.data_ptr(), tb.consts.data_ptr(), rows,
            len(primes), S, M.bit_length() - 1, int(inverse), int(order == "limb"), int(scale),
            geo.threads, geo.tile_tf, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"NTT kernel launch failed: cudaError {rc}")


def ntt(x: torch.Tensor, plan: NTTPlan, inverse: bool, negacyclic: bool,
        order: str | None = None, scale: bool = True) -> torch.Tensor:
    """One kernel launch over ``x``: int32 CUDA ``[..., L, M]``, contiguous,
    M <= 32768.  `order` picks the CTA order (default ``CTA_ORDER``); the
    cyclic inverse leaves out M^-1 when `scale` is off."""
    L, M = plan.L, plan.M
    _check(x, plan, negacyclic, "ntt", inverse, scale)
    if tuple(x.shape[-2:]) != (L, M) or M < 2 or M & (M - 1) or M > 32768:
        raise ValueError(f"shape {tuple(x.shape)} does not fit the plan (L={L}, M={M})")
    y = torch.empty_like(x)
    rows = x.numel() // (L * M)
    if rows == 0:
        return y
    _launch(x, y, plan.primes, M, inverse, negacyclic, rows, scale=scale, order=order)
    launch_counts[mode_name(inverse, negacyclic)] += 1
    return y


# ---------------------------------------------------------------------------
# the split transform M = R * mi
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplitKernelTables:
    col: torch.Tensor  # [L, s, Mi, 2] pairs: w^(2^i c) (inverse: w^-(2^i c))
    row: torch.Tensor  # [L, s, R/2, 2] pairs: w^(2^i Mi lo)
    sc: torch.Tensor  # [L, R, Mi, 2] psi (fwd) or psi^-k M^-1 (inv); col when cyclic
    consts: torch.Tensor  # [L, 3]: p, full-size M^-1, Shoup(M^-1)


@lru_cache(maxsize=None)
def _split_tables(primes: tuple, M: int, Mi: int, inverse: bool, negacyclic: bool,
                  device: str) -> SplitKernelTables:
    """Factored outer twiddles: the b-row twiddle of stage i at row lo, column
    c is w^(2^i (lo Mi + c)) = col[i, c] * row[i, lo]."""
    R = M // Mi
    s = R.bit_length() - 1
    col, row = [], []
    for p in primes:
        w = root_of_unity(p, M)
        pw = _mod_powers(pow(w, p - 2, p) if inverse else w, M, p).astype(np.int64)
        col.append(np.stack([pw[((1 << i) * np.arange(Mi)) % M] for i in range(s)]))
        row.append(np.stack([pw[((1 << i) * Mi * np.arange(R // 2)) % M] for i in range(s)]))
    plan = get_plan(primes, M, negacyclic)
    minv = plan.minv.astype(np.uint64)
    consts = np.concatenate([plan.p.astype(np.uint64), minv, _shoup(minv, primes)], axis=1)
    col_t = _pairs(np.stack(col), primes, device)
    if negacyclic:
        sc = plan.psi_inv_scaled if inverse else plan.psi
        sc_t = _pairs(np.asarray(sc).reshape(len(primes), R, Mi), primes, device)
    else:
        sc_t = col_t  # never read by the cyclic kernels
    return SplitKernelTables(col_t, _pairs(np.stack(row), primes, device), sc_t,
                             _words(consts, device))


MAX_OUTER_STAGES = 5  # stages of one outer pass: 32 residues a thread


def outer_passes(log_r: int, inverse: bool) -> list:
    """The outer kernel's passes over the log_r outer stages, in execution
    order, as (i0, k): stages i0 .. i0 + k - 1, k <= MAX_OUTER_STAGES, as
    even as possible (one pass up to R = 32).  The forward transform runs
    them from stage 0 up, the inverse from the last pass down."""
    n = -(-log_r // MAX_OUTER_STAGES)
    ks = [log_r // n + (j < log_r % n) for j in range(n)]
    passes = [(sum(ks[:j]), k) for j, k in enumerate(ks)]
    return passes[::-1] if inverse else passes


def _split_check(x: torch.Tensor, plan: NTTPlan, negacyclic: bool, mi: int, inverse: bool,
                 scale: bool) -> int:
    L, M = plan.L, plan.M
    _check(x, plan, negacyclic, "ntt_split", inverse, scale)
    R = M // mi
    if (tuple(x.shape[-2:]) != (L, M) or M % mi or R < 2 or R & (R - 1)
            or mi > 32768 or mi & (mi - 1)):
        raise ValueError(f"shape {tuple(x.shape)} does not fit a split of M={M} into "
                         f"R x {mi} with R a power of two >= 2")
    return R


def ntt_split(x: torch.Tensor, plan: NTTPlan, inverse: bool, negacyclic: bool,
              mi: int | None = None, scale: bool = True) -> torch.Tensor:
    """The split transform of ``x``: int32 CUDA ``[..., L, M]``, contiguous,
    M = R * mi (mi defaults to ``split_mi(M)``), R a power of two >= 2.
    Forward: the outer kernel's passes (psi twist + outer DIF stages, one
    pass up to R = 32), then the shared-memory kernel over the R rows of
    size mi; inverse: the shared-memory kernel unscaled, then the outer
    passes (DIT stages + the full-size scale, left out of the cyclic
    inverse when `scale` is off).  Counted once, as ``split_<mode>``."""
    mi = split_mi(plan.M) if mi is None else mi
    R = _split_check(x, plan, negacyclic, mi, inverse, scale)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    st = _split_tables(plan.primes, plan.M, mi, inverse, negacyclic, str(x.device))
    rows = x.numel() // (plan.L * plan.M)
    log_r = R.bit_length() - 1

    def outer(i0, k):
        def run(src, dst):
            with torch.cuda.device(x.device):
                rc = _lib().ringsnark_ntt_outer_launch(
                    src.data_ptr(), dst.data_ptr(), st.col.data_ptr(), st.row.data_ptr(),
                    st.sc.data_ptr(), st.consts.data_ptr(), rows, plan.L, log_r,
                    mi.bit_length() - 1, int(inverse), int(negacyclic), i0, k, int(scale),
                    _stream(x),
                )
            if rc != 0:
                raise RuntimeError(f"NTT outer kernel launch failed: cudaError {rc}")
        return run

    def inner(src, dst):
        _launch(src, dst, plan.primes, mi, inverse, False, rows, S=R, scale=False)

    outers = [outer(i0, k) for i0, k in outer_passes(log_r, inverse)]
    steps = [inner] + outers if inverse else outers + [inner]
    # each step reads one buffer and writes another: the last writes y, the
    # others alternate between two scratch buffers
    scratch = [torch.empty_like(x) for _ in range(min(2, len(steps) - 1))]
    src = x
    for n, step in enumerate(steps):
        dst = y if n == len(steps) - 1 else scratch[n % 2]
        step(src, dst)
        src = dst
    launch_counts["split_" + mode_name(inverse, negacyclic)] += 1
    return y
