"""The Hopper NTT kernels (``csrc/ntt.cu``): build, ctypes binding, tables, launch.

Port of ``ringsnark_tpu/ops/pallas_ntt.py``: `_ntt_kernel_gridfree` (all
four modes, ``ntt``) and the split large-M path `ntt_split_pallas` with its
`_outer_kernel` (``ntt_split``).  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use, from the source in this package, into
``ringsnark_tpu_torch/_build/`` (a shared library with a plain C interface,
loaded with ctypes).  Nothing is built or loaded at import time.

The wrappers take only int32 CUDA tensors ``[B, L, M]`` (contiguous) and
raise on anything else; a failed build or launch raises too.  The plain
versions live in ``ops/ntt.py`` (the twins and ``ntt_split_plain``).

``launch_counts`` holds one plain integer per mode, incremented where a
wrapper launches its kernel and nowhere else: ``ntt`` counts its mode
(``cyclic_fwd`` ...), ``ntt_split`` counts ``split_<mode>`` once per call
(its inner pass is part of it and is not counted as ``<mode>``).
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

from .ntt import SPLIT_MI, NTTPlan, get_plan, get_split_tables, shoup_np

__all__ = ["build", "ntt", "ntt_split", "launch_counts", "reset_launch_counts", "mode_name",
           "MODES", "SPLIT_MODES", "CTA_ORDERS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
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
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build csrc/ntt.cu")


@dataclass(frozen=True)
class BuildResult:
    path: Path
    log: str  # nvcc/ptxas output of this build ("" when reused)


def build() -> BuildResult:
    """Compile ``csrc/ntt.cu`` unless a library of this exact source exists."""
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"libringsnark_ntt_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(SOURCE),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, res.stdout + res.stderr)


@lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build().path))
    fn = lib.ringsnark_ntt_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ringsnark_ntt_outer_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _shoup(vals: np.ndarray, primes: tuple) -> np.ndarray:
    """Shoup constants per limb row of vals."""
    return shoup_np(vals, np.reshape(primes, (-1, *([1] * (np.ndim(vals) - 1)))))


@dataclass(frozen=True)
class KernelTables:
    tw: torch.Tensor  # [L, M] int32 bit patterns of uint32, entry d + k = w_{2d}^k
    tw_sh: torch.Tensor
    sc: torch.Tensor  # [L, M] psi^i (fwd) or psi^-i * M^-1 (inv); tw when cyclic
    sc_sh: torch.Tensor
    consts: torch.Tensor  # [L, 3]: p, M^-1, Shoup(M^-1)


@lru_cache(maxsize=None)
def _tables(primes: tuple, M: int, inverse: bool, negacyclic: bool, device: str):
    plan = get_plan(primes, M, negacyclic)
    L = len(primes)
    stages = plan.inv_tw if inverse else tuple(reversed(plan.fwd_tw))  # d = 1 .. M/2
    tw = np.concatenate([np.zeros((L, 1), np.uint32), *stages], axis=1)
    assert tw.shape == (L, M)
    minv = plan.minv.astype(np.uint64)  # [L, 1]
    consts = np.concatenate([plan.p.astype(np.uint64), minv, _shoup(minv, primes)], axis=1)

    def dev(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64).astype(np.uint32))
        return torch.from_numpy(a.view(np.int32)).to(device)

    if negacyclic:
        sc = plan.psi_inv_scaled if inverse else plan.psi
        sc_t, sc_sh_t = dev(sc), dev(_shoup(sc, primes))
    else:
        sc_t = sc_sh_t = dev(tw)  # never read by the cyclic kernels
    return KernelTables(dev(tw), dev(_shoup(tw, primes)), sc_t, sc_sh_t, dev(consts))


def _check(x: torch.Tensor, plan: NTTPlan, negacyclic: bool, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"cuda_ntt.{name} needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"cuda_ntt.{name} needs int32 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cuda_ntt.{name} needs a contiguous tensor")
    if negacyclic and not plan.negacyclic:
        raise ValueError("negacyclic transform with a cyclic plan")


def _launch(x, y, primes, M, inverse, negacyclic, rows, S=1, scale=True, order=None):
    """One launch of the shared-memory kernel over ``[rows, L, S, M]``."""
    order = CTA_ORDER if order is None else order
    if order not in CTA_ORDERS:
        raise ValueError(f"CTA order {order!r} is not one of {CTA_ORDERS}")
    tb = _tables(primes, M, inverse, negacyclic, str(x.device))
    with torch.cuda.device(x.device):
        rc = _lib().ringsnark_ntt_launch(
            x.data_ptr(), y.data_ptr(), tb.tw.data_ptr(), tb.tw_sh.data_ptr(),
            tb.sc.data_ptr(), tb.sc_sh.data_ptr(), tb.consts.data_ptr(),
            rows, len(primes), S, M.bit_length() - 1, int(inverse), int(negacyclic),
            int(order == "limb"), int(scale), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"NTT kernel launch failed: cudaError {rc}")


def ntt(x: torch.Tensor, plan: NTTPlan, inverse: bool, negacyclic: bool,
        order: str | None = None) -> torch.Tensor:
    """One kernel launch over ``x``: int32 CUDA ``[..., L, M]``, contiguous,
    M <= 32768.  `order` picks the CTA order (default ``CTA_ORDER``)."""
    L, M = plan.L, plan.M
    _check(x, plan, negacyclic, "ntt")
    if tuple(x.shape[-2:]) != (L, M) or M < 2 or M & (M - 1) or M > 32768:
        raise ValueError(f"shape {tuple(x.shape)} does not fit the plan (L={L}, M={M})")
    y = torch.empty_like(x)
    rows = x.numel() // (L * M)
    if rows == 0:
        return y
    _launch(x, y, plan.primes, M, inverse, negacyclic, rows, order=order)
    launch_counts[mode_name(inverse, negacyclic)] += 1
    return y


@dataclass(frozen=True)
class OuterTables:
    tw: torch.Tensor  # [L, s, R, Mi] int32 bit patterns of uint32
    tw_sh: torch.Tensor
    sc: torch.Tensor  # [L, R, Mi] psi (fwd) or psi^-k M^-1 (inv); tw when cyclic
    sc_sh: torch.Tensor
    consts: torch.Tensor  # [L, 3]: p, full-size M^-1, Shoup(M^-1)


@lru_cache(maxsize=None)
def _outer_tables(primes: tuple, M: int, Mi: int, inverse: bool, negacyclic: bool,
                  device: str) -> OuterTables:
    st = get_split_tables(primes, M, Mi, negacyclic)

    def dev(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64).astype(np.uint32))
        return torch.from_numpy(a.view(np.int32)).to(device)

    tw, tw_sh = (st.inv_tw, st.inv_tw_sh) if inverse else (st.fwd_tw, st.fwd_tw_sh)
    consts = np.stack([np.array(primes, np.uint64), np.array(st.minv, np.uint64),
                       np.array(st.minv_sh, np.uint64)], axis=1)
    if negacyclic:
        sc, sc_sh = (st.psiinv_s, st.psiinv_s_sh) if inverse else (st.psi, st.psi_sh)
        sc_t, sc_sh_t = dev(sc), dev(sc_sh)
    else:
        sc_t = sc_sh_t = dev(tw)  # never read by the cyclic kernels
    return OuterTables(dev(tw), dev(tw_sh), sc_t, sc_sh_t, dev(consts))


def ntt_split(x: torch.Tensor, plan: NTTPlan, inverse: bool, negacyclic: bool,
              mi: int = SPLIT_MI) -> torch.Tensor:
    """The split transform of ``x``: int32 CUDA ``[..., L, M]``, contiguous,
    M = R * mi with R = 2 .. 32.  Forward: outer kernel (psi twist + outer
    DIF stages), then the shared-memory kernel over the R rows of size mi;
    inverse: the shared-memory kernel unscaled, then the outer kernel (DIT
    stages + the full-size scale).  Counted once, as ``split_<mode>``."""
    L, M = plan.L, plan.M
    _check(x, plan, negacyclic, "ntt_split")
    R = M // mi
    if (tuple(x.shape[-2:]) != (L, M) or M % mi or R < 2 or R > 32 or R & (R - 1)
            or mi > 32768 or mi & (mi - 1)):
        raise ValueError(f"shape {tuple(x.shape)} does not fit a split of M={M} into "
                         f"R x {mi} with R = 2 .. 32")
    rows = x.numel() // (L * M)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    tmp = torch.empty_like(x)
    ot = _outer_tables(plan.primes, M, mi, inverse, negacyclic, str(x.device))

    def outer(src, dst):
        with torch.cuda.device(x.device):
            rc = _lib().ringsnark_ntt_outer_launch(
                src.data_ptr(), dst.data_ptr(), ot.tw.data_ptr(), ot.tw_sh.data_ptr(),
                ot.sc.data_ptr(), ot.sc_sh.data_ptr(), ot.consts.data_ptr(),
                rows, L, R.bit_length() - 1, mi.bit_length() - 1, int(inverse),
                int(negacyclic), torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"NTT outer kernel launch failed: cudaError {rc}")

    if not inverse:
        outer(x, tmp)
        _launch(tmp, y, plan.primes, mi, False, False, rows, S=R)
    else:
        _launch(x, tmp, plan.primes, mi, True, False, rows, S=R, scale=False)
        outer(tmp, y)
    launch_counts["split_" + mode_name(inverse, negacyclic)] += 1
    return y
