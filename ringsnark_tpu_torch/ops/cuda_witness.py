"""The witness map's kernels on the card (``csrc/witness.cu``): ctypes
binding, checks, launch.

* ``spmv`` (``spmv_kernel``): the constraint evaluations of up to three
  matrices in one launch, ``out_m[r, l, i] = sum_k coef_m[k, l, i or 0] *
  z[idx_m[k], l, i] mod p_l``, each from a ``relations.r1cs.CSR`` and its
  coefficients, the assignment read in place as up to three row blocks at
  a slot window, into ``[rows, L, n]`` or slot-major ``[n, L, rows]``;
  rows longer than the CSR's ``long_len`` are work items of their own in
  the same launch;
* ``mulmod`` (``mulmod_kernel``): ``y = a * b (+ c) mod p_l`` over int32
  ``[R, L, K]``, b full or constant along the slots, in place where ``out``
  is a or c.

They replace int64 torch ops of the port (``relations/r1cs.py:spmv``,
``ops/modops.py:mul_mod``/``add_mod``), the counterparts of the JAX
package's XLA code: ``CompiledR1CS.eval_matrices``' gather, Barrett
``mul_mod`` and u64 ``segment_sum`` (``ringsnark_tpu/relations/
r1cs.py:222-241``) and the pointwise product of ``_witness_map_kernel``
(``ringsnark_tpu/reductions/r1cs_to_qrp.py:444-448``); no Pallas kernel
stands behind either.  Both are bound by their bytes at the main path's
shapes; ``csrc/witness.cu``'s head gives the design (persistent CTAs, the
next tile's gathers in flight in a shared-memory ring, long rows shared by
a CTA, the slot-major store by warp tiles) and the exactness
argument (canonical words, moduli in [2, 2^31): ``moduli`` refuses any
other by name).  ``geometry`` is the launcher's tile, which
``tests/witness_replay.py`` replays in numpy.

Nothing is built or loaded at import time: the kernels are compiled into
the library of ``cuda_ntt.build`` at first use.  The wrappers take only CUDA
tensors and raise on anything else; a refused or failed launch raises;
nothing falls back.  The dispatch (plain versions on any other device) is
the callers' (``CompiledR1CS.evaluate``, ``r1cs_to_qrp._mulmod``), by
`on_card`.
``launch_counts`` holds one plain integer per kernel, incremented where a
wrapper launches it and nowhere else: ``spmv`` once a call (every matrix
of the call, long rows included), ``mulmod`` once a call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import cuda_ntt

__all__ = ["spmv", "mulmod", "moduli", "geometry", "on_card", "launch_counts",
           "reset_launch_counts", "KERNELS", "MAX_BLOCKS", "MAX_LIMBS", "MAX_MATS"]

KERNELS = ("spmv", "mulmod")
launch_counts = {k: 0 for k in KERNELS}
MAX_BLOCKS = 3  # kMaxBlocks in csrc/witness.cu: row blocks of the assignment
MAX_LIMBS = 32  # kMaxLimbs
MAX_MATS = 3  # kMaxMats: matrices a launch
THREADS = 256  # kThreads
MAX_TILE_LIMBS = 4  # kMaxTileLimbs: the limbs a tile takes at n = 1
MAX_GROUP = 32  # 1 << kLogMaxGroup: a row's threads in a tile
LONG_GROUP = 8  # 1 << kLogLongGroup: a long row's threads a slot group
STAGES = 2  # kStages: the ring's stages
_I32 = torch.int32


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(cuda_ntt.build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ringsnark_spmv.argtypes = [ptr, i32, ptr, ptr, i32, ptr, ptr, i32, i64, i64, i64, i32,
                                   ptr]
    lib.ringsnark_mulmod.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
    lib.ringsnark_spmv.restype = lib.ringsnark_mulmod.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def moduli(primes: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The limbs' primes as uint32 and mu_l = floor(2^64 / p_l) as uint64
    (host arrays the launch copies into its parameters).  Raises ValueError
    for a modulus outside [2, 2^31), whose Shoup products would not fit 32
    bits, or more than MAX_LIMBS limbs."""
    if not 1 <= len(primes) <= MAX_LIMBS:
        raise ValueError(f"cuda_witness: {len(primes)} limbs, the kernels take 1 to {MAX_LIMBS}")
    for p in primes:
        if not 2 <= int(p) < 1 << 31:
            raise ValueError(f"cuda_witness: modulus {int(p)} is outside [2, 2^31), which the "
                             "witness map's kernels take")
    return (np.ascontiguousarray(primes, dtype=np.uint32),
            np.ascontiguousarray([(1 << 64) // int(p) for p in primes], dtype=np.uint64))


def geometry(n: int, vec: int, L: int = 1,
             slot_major: bool = False) -> tuple[int, int, int, int]:
    """(log2 G, log2 TS, log2 TR, limbs) of spmv_kernel's tile for n output
    slots of L limbs at `vec` adjacent slots a thread (4 or 1): G threads a
    row (the next power of two of n / vec, at most MAX_GROUP), TS = G * vec
    slots, TR = THREADS / G rows times a thread's rows (8 at vec 4, 4 at
    vec 1), and the tile's limbs (all L at n = 1 where L <= MAX_TILE_LIMBS,
    else 1).  Slot-major at n > 1 takes the warp tiles: the vec-4 tile
    whatever `vec`, at least 8 threads (32 slots) a row."""
    warp = slot_major and n > 1
    tv = 4 if warp else vec
    log_g = 3 if warp else 0
    while (tv << log_g) < n and (1 << log_g) < MAX_GROUP:
        log_g += 1
    log_ts = log_g + (tv == 4) * 2
    log_tr = (THREADS.bit_length() - 1) - log_g + (3 if tv == 4 else 2)
    return log_g, log_ts, log_tr, L if n == 1 and L <= MAX_TILE_LIMBS else 1


def on_card(x: torch.Tensor) -> bool:
    """Whether the witness map's callers take the kernels for x: a CUDA
    tensor (the dispatch of ``CompiledR1CS.evaluate`` and
    ``r1cs_to_qrp._mulmod``)."""
    return x.device.type == "cuda"


def _check_device(x: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"cuda_witness.{name} needs a CUDA tensor, got {x.device}")


def _check(x: torch.Tensor, name: str):
    _check_device(x, name)
    if x.dtype != _I32:
        raise TypeError(f"cuda_witness.{name} needs int32, got {x.dtype}")


def _launch(kernel: str, fn: str, device: torch.device, *args):
    with torch.cuda.device(device):
        rc = getattr(_lib(), fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"witness {kernel} kernel launch failed: cudaError {rc}")
    launch_counts[kernel] += 1


def _host(a: np.ndarray) -> int:
    return a.ctypes.data


def blocks(z, L: int, lo: int, n: int) -> tuple[np.ndarray, np.ndarray, list]:
    """The launch's assignment: each non-empty block of `z` (tensors ``[rows,
    L, 1 or n_full]``, in assignment row order) as its pointer at slot `lo`
    (uint64) and (first row, row, limb and slot strides) (int64, in words; a
    width-1 block's slot stride 0), and the tensors, which must outlive the
    launch.  Every wide block must hold the window [lo, lo + n)."""
    ptrs, meta, keep, start = [], [], [], 0
    for b in z:
        if b.dim() != 3 or b.shape[1] != L:
            raise ValueError(f"cuda_witness.spmv: assignment block {tuple(b.shape)}, want "
                             f"[rows, {L}, n]")
        _check(b, "spmv (assignment)")
        if b.shape[0]:
            wide = b.shape[-1] > 1
            if wide and lo + n > b.shape[-1]:
                raise ValueError(f"cuda_witness.spmv: slots [{lo}, {lo + n}) of a block of "
                                 f"{b.shape[-1]}")
            off = lo if wide else 0
            ptrs.append(b.data_ptr() + 4 * off * b.stride(-1))
            meta += [start, b.stride(0), b.stride(1), b.stride(2) if wide else 0]
            keep.append(b)
        start += b.shape[0]
    if not ptrs:
        raise ValueError("cuda_witness.spmv: an empty assignment")
    if len(ptrs) > MAX_BLOCKS:
        raise ValueError(f"cuda_witness.spmv: {len(ptrs)} assignment blocks, at most "
                         f"{MAX_BLOCKS}")
    return np.array(ptrs, dtype=np.uint64), np.array(meta, dtype=np.int64), keep


def spmv(plans, z, primes: tuple, rows: int, lo: int, n: int,
         slot_major: bool) -> tuple[torch.Tensor, ...]:
    """The evaluations of up to MAX_MATS matrices on the card in one launch:
    `plans` pairs (csr, coeffs) of a ``relations.r1cs.CSR`` and its
    coefficients int32 ``[nnz, L, nc]`` in the CSR's order (any strides:
    ``CompiledR1CS.csr_coeffs``, a limb's view), `z` the assignment's row
    blocks (at least every CSR's ``cols`` rows in all), `rows` >= every
    ``csr.rows`` output rows, the window [lo, lo + n) of the wide blocks and
    of coefficients with nc > 1.  Returns a tensor a plan, int32 ``[rows, L,
    n]``, or ``[n, L, rows]`` where `slot_major`.  Required of the caller
    and not checked: canonical coefficients and assignment words."""
    L = len(primes)
    q, mu = moduli(tuple(primes))
    if not 1 <= len(plans) <= MAX_MATS:
        raise ValueError(f"cuda_witness.spmv: {len(plans)} matrices, one launch takes 1 to "
                         f"{MAX_MATS}")
    total = sum(b.shape[0] for b in z)
    zp, zm, keep = blocks(z, L, lo, n)
    mats, outs = np.zeros((len(plans), 13), dtype=np.int64), []
    for k, (csr, coeffs) in enumerate(plans):
        if total < csr.cols:
            raise IndexError(f"gather index out of range for {total} rows")
        if rows < csr.rows:
            raise IndexError(f"scatter index out of range for {rows} rows")
        _check(coeffs, "spmv (coefficients)")
        nc = coeffs.shape[-1]
        if (coeffs.dim() != 3 or coeffs.shape[:2] != (csr.idx.numel(), L)
                or (nc > 1 and (coeffs.stride(-1) != 1 or lo + n > nc))):
            raise ValueError(f"cuda_witness.spmv: coefficients {tuple(coeffs.shape)} for "
                             f"{csr.idx.numel()} nonzeros, L={L}, slots [{lo}, {lo + n})")
        out = torch.empty((n, L, rows) if slot_major else (rows, L, n), dtype=_I32,
                          device=coeffs.device)
        mats[k] = (0 if csr.unit else csr.ptr.data_ptr(), csr.idx.data_ptr(),
                   csr.head.data_ptr(), coeffs.data_ptr(), csr.longs.data_ptr(),
                   out.data_ptr(), csr.rows, csr.nlong, int(csr.unit), csr.long_len,
                   coeffs.stride(0), coeffs.stride(1), 1 if nc > 1 else 0)
        outs.append(out)
    _launch("spmv", "ringsnark_spmv", outs[0].device, _host(mats), len(plans), _host(zp),
            _host(zm), len(keep), _host(q), _host(mu), L, rows, n, lo, int(slot_major))
    return tuple(outs)


def _as3(x: torch.Tensor) -> torch.Tensor:
    """x viewed as [R, L, K] (its leading dimensions flattened, or one row)."""
    if x.dim() == 2:
        return x.unsqueeze(0)
    return x if x.dim() == 3 else x.view(-1, x.shape[-2], x.shape[-1])


def mulmod(a: torch.Tensor, b: torch.Tensor, primes: tuple, c: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """``a * b (+ c) mod p_l`` on the card, a: int32 ``[..., L, K]``, b and c
    broadcasting to a's shape (b full or constant along K; c full), into
    `out` (a's shape; may be a or c) or a new tensor.  Required of the
    caller and not checked: a's and b's words canonical (below p_l), c's
    too; another word gives a wrong product."""
    L = len(primes)
    q, mu = moduli(tuple(primes))
    for x, name in ((a, "a"), (b, "b")) + (((c, "c"),) if c is not None else ()):
        _check(x, f"mulmod ({name})")
    if a.dim() < 2 or a.shape[-2] != L:
        raise ValueError(f"cuda_witness.mulmod: a {tuple(a.shape)}, want [..., {L}, K]")
    shape = a.shape
    b = b.expand(shape)
    c = None if c is None else c.expand(shape)
    out = torch.empty(shape, dtype=_I32, device=a.device) if out is None else out
    _check(out, "mulmod (out)")
    if out.shape != shape:
        raise ValueError(f"cuda_witness.mulmod: out {tuple(out.shape)}, want {tuple(shape)}")
    if not a.numel():
        return out
    a3, b3, o3 = _as3(a), _as3(b), _as3(out)
    c3 = None if c is None else _as3(c)
    for x, name in ((a3, "a"), (o3, "out")) + (((c3, "c"),) if c is not None else ()):
        if x.stride(-1) != 1:
            raise ValueError(f"cuda_witness.mulmod: {name}'s slots are not contiguous")
    if b3.stride(-1) not in (0, 1):
        raise ValueError(f"cuda_witness.mulmod: b's slot stride {b3.stride(-1)}, want 0 or 1")
    sc = c3.stride() if c3 is not None else (0, 0, 1)
    R, K = a3.shape[0], a3.shape[-1]
    strides = np.array([*a3.stride()[:2], *b3.stride(), *sc[:2], *o3.stride()[:2]],
                       dtype=np.int64)
    _launch("mulmod", "ringsnark_mulmod", a.device, out.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if c is None else c.data_ptr(), R, L, K, _host(strides), _host(q), _host(mu))
    return out

