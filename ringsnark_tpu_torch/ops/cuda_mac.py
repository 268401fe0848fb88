"""The prover's multiply-accumulate on the card (``csrc/mac.cu``): ctypes
binding, constants, launch.

``mac`` and ``mac_drawn`` add the exact int64 sums ``sum_r (c[r] * pt_k[r]
mod Q_j)`` of one row sub-chunk, for both components and every plaintext
operand, into the caller's accumulators: ``encoding.mac.mac_rows`` on CUDA
tensors.  They replace the int64 torch ops of ``encoding.mac.mac_plain``,
the counterpart of the JAX package's jitted MAC (``ringsnark_tpu/snark/
seeded.py:295-389``, `_seeded_mac_kernel` and its scan body
`_mac_accs_u64`, which regenerates each slab's c1 from the key;
``ringsnark_tpu/encoding/encoding.py`` `inner_product`):

* ``mac`` (``mac_kernel``): c0 and c1 given (the resident, streamed,
  Rinocchio, sharded and frontend provers);
* ``mac_drawn`` (``mac_drawn_kernel``): c1 drawn in registers from the
  slab's key (the seeded prove), never written: ``cuda_prng.uniform``'s
  words under ``cuda_prng.uniform_columns`` and ``_enc_geometry``'s
  counters (ROADMAP trap k).

What bounds them: ``mac`` reads c0, c1 and each operand once as int32, so
its bytes at 3.35 TB/s; ``mac_drawn`` reads c0 and the operands and hashes
one threefry word a residue (41 operations on the ALU), so its bytes or
its operations, as the shape says (``chip_smoke.py``'s ``Ops``).  The
design: both kernels are persistent (as many CTAs as the card keeps
resident, read by the C launcher); a CTA walks a run of (tile, row) units,
rows fastest, a thread owning ``VEC`` adjacent columns (16-byte loads) and
the next pair of rows in registers while this pair is hashed and
multiplied; each term is reduced with the operand word's Shoup constant
(three multiplies, exact for canonical operands below 2^31: ``barrett``
refuses any other modulus), two rows' terms are added in 32 bits before
each 64-bit add, and each tile's run ends in one set of 64-bit atomics.
Both components are read once for up to ``MAX_OPERANDS`` operands; a Z_q
operand (``bgv.plain_to_inner_ntt``'s broadcast over N') is read as
``[rows, L, L']``, never made contiguous; the moduli, constants and key
columns ride in the launch's parameters (no copy from pageable host
memory, so no stream sync), and a seeded slab's key table is derived once
(``_drawn_table``).

Nothing is built or loaded at import time: the kernels are compiled into
the library of ``cuda_ntt.build`` at first use.  The wrappers take only
CUDA tensors and raise on anything else; a refused or failed launch raises;
nothing falls back.  ``launch_counts`` holds one plain integer per kernel,
incremented where a wrapper launches it and nowhere else: ``mac`` and
``mac_drawn``.  ``tests/mac_replay.py`` replays both in numpy from this
module's ``barrett`` and the launcher's walk, at any number of CTAs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils import prng
from . import cuda_ntt, cuda_prng

__all__ = ["mac", "mac_drawn", "barrett", "launch_counts", "reset_launch_counts", "KERNELS",
           "THREADS", "VEC", "MAX_OPERANDS"]

KERNELS = ("mac", "mac_drawn")
launch_counts = {k: 0 for k in KERNELS}
THREADS = 256  # kThreads in csrc/mac.cu
VEC = 4  # kVec: adjacent columns a thread
MAX_OPERANDS = 4  # kMaxOps: plaintext operands a launch
_MAX_WORDS = 1 << 32  # words a tensor of a launch: 32-bit offsets
_I32, _I64 = torch.int32, torch.int64


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(cuda_ntt.build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [ptr, ptr, i32, i32, ptr, ptr, i32, i64, i64, i64, ptr]
    lib.ringsnark_mac.argtypes = [ptr, ptr, *shape]
    lib.ringsnark_mac_drawn.argtypes = [ptr, ptr, i64, i64, *shape]
    lib.ringsnark_mac.restype = lib.ringsnark_mac_drawn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def barrett(moduli: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The moduli as uint32 and mu_j = floor(2^64 / Q_j) as uint64 (host
    arrays the launch copies into its parameters; the kernel derives each
    operand word's Shoup constant from mu_j's halves).  Raises ValueError
    for a modulus outside [2, 2^31): the term's reduction needs 2 Q_j <
    2^32 (``csrc/mac.cu``)."""
    for p in moduli:
        if not 2 <= int(p) < 1 << 31:
            raise ValueError(f"cuda_mac: modulus {int(p)} is outside [2, 2^31), which the "
                             "MAC's reduction takes")
    q = np.ascontiguousarray(moduli, dtype=np.uint32)
    mu = np.ascontiguousarray([(1 << 64) // int(p) for p in moduli], dtype=np.uint64)
    return q, mu


@lru_cache(maxsize=1024)
def _drawn_table(primes: tuple, key: tuple) -> np.ndarray:
    """The key table of the uniform mask under `key` over the inner primes
    (a seeded slab's c1 key; every sub-chunk of the slab shares it).  Raises
    ValueError for a prime whose draw takes two words (a span up to 2^16,
    JAX's multiplier non-zero): ``mac_drawn_kernel`` draws one word a value."""
    for p in primes:
        if prng.randint_multiplier(int(p)):
            raise ValueError(f"cuda_mac: modulus {int(p)} draws two words a value (a span up "
                             "to 2^16), which mac_drawn's one-word draw does not take")
    return cuda_prng._table(cuda_prng.uniform_columns(primes, key))


def _check_device(x: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"cuda_mac.{name} needs a CUDA tensor, got {x.device}")


def _check(x: torch.Tensor, name: str, dtype=_I32):
    _check_device(x, name)
    if x.dtype != dtype:
        raise TypeError(f"cuda_mac.{name} needs {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cuda_mac.{name} needs a contiguous tensor")


def _aligned(x: torch.Tensor, name: str):
    if x.data_ptr() % 16:
        raise ValueError(f"cuda_mac.{name}: rows are read in 16-byte words, the tensor is not "
                         "16-byte aligned")


def _operand(pt: torch.Tensor, want: tuple, n: int) -> tuple[torch.Tensor, bool]:
    """The operand as the kernel reads it, and whether it is a broadcast over
    N' (read as ``[rows, L, L']``: ``bgv.plain_to_inner_ntt``'s Z_q path)."""
    if pt.dim() != 4 or tuple(pt.shape[1:]) != want or not 1 <= pt.shape[0] <= n:
        raise ValueError(f"cuda_mac: operand shape {tuple(pt.shape)}, want [1..{n}, *{want}]")
    if pt.stride(-1) == 0 and pt.shape[-1] > 1:
        # the lift's broadcasting sets these words' strides: a copy of them
        # alone is 1/N' of the expanded view, which is never materialised
        words = pt[..., 0].contiguous()
        _check(words, "mac (broadcast operand)")
        return words, True
    _check(pt, "mac (operand)")
    _aligned(pt, "mac (operand)")
    return pt, False


def _prepare(ctx, level: int, c0: torch.Tensor, pts, accs):
    """The checked arguments of each launch (none for n = 0 rows): one group
    of at most MAX_OPERANDS operands each, with the group's tensors (a
    broadcast operand's words are a copy that must outlive the launch)."""
    C = ctx.L_inner - level
    want = (ctx.L, C, ctx.n_inner)
    _check(c0, "mac (c0)")
    if tuple(c0.shape[1:]) != want:
        raise ValueError(f"cuda_mac: c0 shape {tuple(c0.shape)}, want [n, *{want}]")
    _aligned(c0, "mac (c0)")
    if ctx.n_inner % VEC:
        raise ValueError(f"cuda_mac: N' = {ctx.n_inner} is not a multiple of {VEC}")
    if c0.numel() > _MAX_WORDS:
        raise ValueError(f"cuda_mac: {c0.numel()} words a launch, above the kernels' 2^32")
    if len(pts) != len(accs):
        raise ValueError(f"cuda_mac: {len(pts)} operands, {len(accs)} accumulator pairs")
    q, mu = barrett(ctx.level_primes(level))
    n = c0.shape[0]
    if not n:
        return []
    ops, kinds = [], set()
    for pt, (a0, a1) in zip(pts, accs):
        for a in (a0, a1):
            _check(a, "mac (accumulator)", _I64)
            if tuple(a.shape) != want:
                raise ValueError(f"cuda_mac: accumulator shape {tuple(a.shape)}, want {want}")
        words, bcast = _operand(pt, want, n)
        ops.append((words, a0.data_ptr(), a1.data_ptr()))
        kinds.add(bcast)
    if len(kinds) != 1:
        if kinds:
            raise ValueError("cuda_mac: broadcast and full operands in one call (one context "
                             "makes them all one kind)")
        return []
    bcast = int(kinds.pop())
    launches = []
    for g in range(0, len(ops), MAX_OPERANDS):
        group = ops[g:g + MAX_OPERANDS]
        pad = [0] * (MAX_OPERANDS - len(group))
        ptrs = np.array([w.data_ptr() for w, _, _ in group] + pad
                        + [a0 for _, a0, _ in group] + pad + [a1 for _, _, a1 in group] + pad,
                        dtype=np.uint64)
        nrows = np.array([w.shape[0] for w, _, _ in group], dtype=np.int64)
        # the group's tensors stay referenced until the launch is enqueued
        launches.append((group, ptrs, nrows, len(group), bcast, q, mu, C, n, ctx.L,
                         ctx.n_inner))
    return launches


def _launch(kernel: str, fn: str, device: torch.device, *args):
    with torch.cuda.device(device):
        rc = getattr(_lib(), fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mac {kernel} kernel launch failed: cudaError {rc}")
    launch_counts[kernel] += 1


def _host(a: np.ndarray) -> int:
    return a.ctypes.data


def mac(ctx, level: int, c0: torch.Tensor, c1: torch.Tensor, pts, accs):
    """``mac_rows`` on CUDA tensors with c1 given: adds ``sum_r c[r] *
    pt_k[r] mod Q_j`` for c = c0, c1 into ``accs[k]`` (int64 ``[L, L'_lvl,
    N']`` pairs) in place; c0, c1 int32 ``[n, L, L'_lvl, N']``, operand k
    ``[n_k, ...]`` with 1 <= n_k <= n.  Required of the caller and not
    checked: c0, c1's words in [0, 2^31) and each operand word below Q_j,
    where the reduction is exact; another word gives a wrong sum."""
    _check(c1, "mac (c1)")
    if c1.shape != c0.shape:
        raise ValueError(f"cuda_mac.mac: c1 shape {tuple(c1.shape)} != c0's {tuple(c0.shape)}")
    _aligned(c1, "mac (c1)")
    for _, ptrs, nrows, P, bcast, q, mu, C, n, L, I in _prepare(ctx, level, c0, pts, accs):
        _launch("mac", "ringsnark_mac", c0.device, c0.data_ptr(), c1.data_ptr(), _host(ptrs),
                _host(nrows), P, bcast, _host(q), _host(mu), C, n, L, I)


def mac_drawn(ctx, level: int, c0: torch.Tensor, drawn, pts, accs):
    """``mac_rows`` on CUDA tensors with c1 drawn in registers: `drawn` (an
    ``encoding.mac.Drawn``) names rows of ``bgv._sample_uniform(ctx,
    drawn.key, drawn.batch_shape)``, which must be c0's rows.  The same
    requirement on c0 and the operands as ``mac``'s; the inner primes must
    lie above 2^16 (one word a drawn value), else ValueError."""
    if level:
        raise ValueError("cuda_mac.mac_drawn: a drawn c1 is a fresh encryption's, at level 0")
    n = c0.shape[0]
    geo, _ = cuda_prng._enc_geometry(ctx, drawn.batch_shape, drawn.rows)
    if (geo.outer, geo.rows, geo.A, geo.I) != (1, n, ctx.L, ctx.n_inner):
        raise ValueError(f"cuda_mac.mac_drawn: the draw's rows {geo} are not c0's "
                         f"{tuple(c0.shape)}")
    launches = _prepare(ctx, level, c0, pts, accs)
    if not launches:
        return
    table = _drawn_table(tuple(ctx.inner_primes), tuple(drawn.key))
    for _, ptrs, nrows, P, bcast, q, mu, C, n, L, I in launches:
        _launch("mac_drawn", "ringsnark_mac_drawn", c0.device, c0.data_ptr(), _host(table),
                geo.n_axis, geo.lo, _host(ptrs), _host(nrows), P, bcast, _host(q), _host(mu),
                C, n, L, I)
