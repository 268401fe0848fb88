"""Threefry draws, the plaintext's lift and symmetric-BGV encryption on the
card (``csrc/prng.cu``): ctypes binding, key tables, launch geometry,
launch.

The kernels are the CUDA route of the port's PRNG and encryption, which
the JAX package writes with ``jax.random`` and XLA
(``ringsnark_tpu/encoding/bgv.py``: `_lift_centered`, `_sample_uniform`,
`_sample_error_ntt`, `_encrypt_from_m`):

* ``bits``, ``randint``: ``prng.bits`` and ``prng.randint`` on a CUDA device
  (one launch of ``draw_kernel``, one key column);
* ``uniform``: the uniform mask of an encryption, ``bgv._sample_uniform``
  (``draw_kernel``, one key column per inner prime);
* ``cbd_error``: the centred-binomial error, ``bgv._sample_error_coeffs``
  (``cbd_kernel``);
* ``lift``: the plaintext's centred lift into every Q_j,
  ``bgv._lift_centered`` in int32 (``lift_kernel``);
* ``lift_error``: the lift plus t * e mod Q_j for the CBD error drawn in
  the same kernel, ``bgv._lift_error_plain`` (``lift_kernel``);
* ``encrypt``: ``c0 = u - a*s mod Q_j`` with the uniform mask a drawn in
  registers, and ``c1 = a`` where the caller keeps it, from ``u`` =
  NTT(lift + t*e) (``encrypt_kernel``): ``bgv.encrypt`` on the card.

They are compiled into the library of the NTT kernels (``cuda_ntt.build``)
at first use; nothing is built or loaded at import time.  The wrappers take
only CUDA devices and int32 CUDA tensors and raise on anything else; a
refused or failed launch raises; nothing falls back.  Their plain versions
are ``prng.bits_plain``, ``prng.randint_plain``, ``bgv._uniform_plain``,
``bgv._error_coeffs_plain``, ``bgv._lift_centered``,
``bgv._lift_error_plain`` and ``bgv._encrypt_from_u``: the dispatchers
(``prng.bits``, ``prng.randint``, ``bgv._sample_uniform``,
``bgv._sample_error_coeffs``, ``bgv._lift``, ``bgv._lift_error``,
``bgv.encrypt``) take them for other devices only.

The host derives every key as before (``prng.split``, ``fold_in``) and
hands the kernels a table of key columns (``column``) in the launch's
parameters; ``geometry`` places a launch's rows in the whole draw, so a row
range is the slice of the whole draw (ROADMAP trap f).  ``tests/
prng_replay.py`` replays them in numpy.

``launch_counts`` holds one plain integer per kernel, incremented where a
wrapper launches it and nowhere else: ``uniform`` (``draw_kernel``, for
``bits``, ``randint`` and ``uniform``), ``cbd_error``, ``lift`` (both
modes), ``encrypt``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils import prng
from . import cuda_ntt

__all__ = ["Geometry", "geometry", "column", "uniform_columns", "shoup_pairs", "t_pairs",
           "lift_consts", "bits", "randint", "uniform", "cbd_error", "lift", "lift_error",
           "encrypt", "launch_counts", "reset_launch_counts", "KERNELS", "MAX_COLUMNS"]

KERNELS = ("uniform", "cbd_error", "lift", "encrypt")
launch_counts = {k: 0 for k in KERNELS}
MAX_COLUMNS = 32  # kMaxCols in csrc/prng.cu
_MASK = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(cuda_ntt.build().path))
    ptr, i32, u32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    geo = [i64] * 5  # n_axis, lo, rows, A, I
    for name, args in (
        ("ringsnark_prng_draw", [ptr, ptr, i32, i64, *geo, ptr]),
        ("ringsnark_prng_cbd", [ptr, ptr, i32, u32, u32, i32, u32, *geo, ptr]),
        ("ringsnark_prng_lift", [ptr, ptr, ptr, i32, i32, i32, u32, u32, i32, u32, *geo, ptr]),
        ("ringsnark_prng_encrypt", [ptr] * 5 + [i32, i32, *geo, ptr]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# the host's half: where a launch sits in its draw, and its keys
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Geometry:
    """A launch's place in its whole draw, viewed as ``[outer, n_axis, A,
    I]``: rows ``[lo, lo + rows)`` of axis ``n_axis``; word (o, r, a, i) has
    the counter ``o * n_axis * A * I + ((lo + r) * A + a) * I + i``."""

    outer: int
    n_axis: int
    lo: int
    rows: int
    A: int
    I: int  # noqa: E741 (the innermost extent, as in csrc/prng.cu)

    def args(self):
        return (self.n_axis, self.lo, self.rows, self.A, self.I)


def geometry(shape, rows=None, axis: int = 0) -> Geometry:
    """The geometry of the rows ``[lo, hi)`` (all by default) along `axis` of
    a draw of `shape` (``prng.bits``'s ``rows``/``axis``): the axes before
    `axis` are ``outer``, its last axis is ``I``, those between are ``A``."""
    shape = tuple(int(n) for n in shape)
    lo, hi = (0, shape[axis]) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= shape[axis]:
        raise ValueError(f"rows {rows} are not a range of axis {axis} of {shape}")
    after = shape[axis + 1:]
    return Geometry(math.prod(shape[:axis]), shape[axis], lo, hi - lo, math.prod(after[:-1]),
                    after[-1] if after else 1)


def _sub_shape(shape, geo: Geometry, axis: int) -> tuple:
    """The shape of the launch's rows: `shape` with `axis` cut to them."""
    shape = tuple(int(n) for n in shape)
    return (*shape[:axis], geo.rows, *shape[axis + 1:])


def column(k: prng.Key, span: int = 0, minval: int = 0) -> tuple:
    """One key column of the kernels' table (``Column`` in csrc/prng.cu):
    the words of ``prng.bits(k, ...)`` for span 0, else the values of
    ``prng.randint(k, ..., minval + span, minval=minval)``: the keys of the
    low and high words (``split(k)``'s second and first), the span, JAX's
    multiplier, mu = min(floor(2^32 / span), 2^32 - 1) and minval as uint32."""
    if not span:
        return (k[0], k[1], 0, 0, 0, 0, 0, 0)
    k_hi, k_lo = prng.split(k)
    return (*k_lo, *k_hi, span, prng.randint_multiplier(span), min((1 << 32) // span, _MASK),
            minval & _MASK)


def uniform_columns(primes, key: prng.Key) -> list:
    """The columns of an encryption's uniform mask under `key` (its k_a)
    over the context's inner primes: prime j draws ``randint(split(key,
    L')[j], ..., Q_j)``."""
    return [column(k, int(Q)) for k, Q in zip(prng.split(key, len(primes)), primes)]


def _table(columns) -> np.ndarray:
    if not 1 <= len(columns) <= MAX_COLUMNS:
        raise ValueError(f"{len(columns)} key columns: a launch takes 1 to {MAX_COLUMNS}")
    return np.ascontiguousarray(np.array(columns, dtype=np.uint64).astype(np.uint32))


def shoup_pairs(vals: torch.Tensor, moduli) -> torch.Tensor:
    """Residues ``vals`` (< q < 2^31, any device) beside their Shoup
    constants floor(v * 2^32 / q), as int32 words ``[..., 2]`` (the
    constants' uint32 bits); `moduli` broadcasts against `vals`."""
    v = vals.to(_I64)
    sh = torch.div(v << 32, moduli, rounding_mode="floor")
    return torch.stack([v, sh - ((sh >> 31) << 32)], dim=-1).to(_I32)


@lru_cache(maxsize=None)
def t_pairs(ctx) -> torch.Tensor:
    """t_l mod Q_j with its Shoup constant, int32 ``[L, L', 2]`` on the
    context's device (made once a context)."""
    return shoup_pairs(ctx.t_mod_Q[..., 0], ctx.inner_consts(0)[None, :, 0])


@lru_cache(maxsize=None)
def lift_consts(ctx) -> torch.Tensor:
    """The lift kernel's operand, int32 ``[L, L', 4]`` on the context's
    device: (Q_j - t_l mod 2^32, Q_j, t_l mod Q_j, its Shoup constant) as
    uint32 words (made once a context; a level takes the first L'_lvl
    columns; the kernel takes t_l = Q_j - (Q_j - t_l) from column 0)."""
    L, Lp = ctx.L, ctx.L_inner
    t = torch.as_tensor(ctx.t_np.astype(np.int64), device=ctx.device)[:, None].expand(L, Lp)
    q = ctx.inner_consts(0)[:, 0][None, :].expand(L, Lp)
    qt = (q - t) & _MASK
    qt = qt - ((qt >> 31) << 32)  # the uint32 word's int32 bits
    return torch.cat([torch.stack([qt, q], dim=-1).to(_I32), t_pairs(ctx)], dim=-1).contiguous()


@lru_cache(maxsize=None)
def _error_lift_ok(ctx) -> bool:
    """The lift is a canonical residue, as the kernel's add mod Q_j needs,
    where every t_l <= 2 Q_j (``csrc/prng.cu:lift_word``; an odd t_l, as
    every context's is, is then below 2 Q_j)."""
    return all(t <= 2 * q for t in ctx.ring.primes for q in ctx.inner_primes)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _check_device(device, name: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"cuda_prng.{name} needs a CUDA device, got {device}")
    return device


def _check(x: torch.Tensor, name: str):
    _check_device(x.device, name)
    if x.dtype != _I32:
        raise TypeError(f"cuda_prng.{name} needs int32 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"cuda_prng.{name} needs a contiguous tensor")


def _launch(kernel: str, fn: str, device: torch.device, *args):
    with torch.cuda.device(device):
        rc = getattr(_lib(), fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prng {kernel} kernel launch failed: cudaError {rc}")
    launch_counts[kernel] += 1


def _draw(columns, geo: Geometry, device) -> torch.Tensor:
    """One launch of draw_kernel: int32 ``[outer, rows, A, C, I]``."""
    table = _table(columns)
    out = torch.empty((geo.outer, geo.rows, geo.A, len(columns), geo.I), dtype=_I32,
                      device=device)
    if out.numel():
        _launch("uniform", "ringsnark_prng_draw", device, out.data_ptr(), table.ctypes.data,
                len(columns), geo.outer, *geo.args())
    return out


def bits(k: prng.Key, shape, device, rows=None, axis: int = 0) -> torch.Tensor:
    """``prng.bits`` on a CUDA device: int64 values in [0, 2^32)."""
    device = _check_device(device, "bits")
    geo = geometry(shape, rows, axis)
    out = _draw([column(k)], geo, device).reshape(_sub_shape(shape, geo, axis))
    return out.to(_I64) & _MASK


def randint(k: prng.Key, shape, maxval: int, device, rows=None, axis: int = 0,
            minval: int = 0) -> torch.Tensor:
    """``prng.randint`` on a CUDA device: int64 values in [minval, maxval)."""
    device = _check_device(device, "randint")
    geo = geometry(shape, rows, axis)
    out = _draw([column(k, int(maxval) - int(minval), int(minval))], geo, device)
    out = out.reshape(_sub_shape(shape, geo, axis)).to(_I64)
    # the kernel writes uint32 words: values from 2^31 on are unsigned
    return out & _MASK if maxval > 1 << 31 else out


def _enc_geometry(ctx, batch_shape, rows) -> tuple[Geometry, tuple]:
    """The geometry of an encryption's per-prime draw ``(*batch, L, N')``
    (rows along the batch's axis 0; a batch of () is one row) and the shape
    of its rows, ``[*, L, N']``."""
    shape = (*(tuple(batch_shape) or (1,)), ctx.L, ctx.n_inner)
    geo = geometry(shape, rows, 0)
    sub = _sub_shape(shape, geo, 0)
    return geo, (sub if batch_shape else sub[1:])


def uniform(ctx, key: prng.Key, batch_shape, rows=None) -> torch.Tensor:
    """``bgv._sample_uniform`` on the card: int32 ``[*, L, L', N']``."""
    device = _check_device(ctx.device, "uniform")
    geo, sub = _enc_geometry(ctx, batch_shape, rows)
    out = _draw(uniform_columns(ctx.inner_primes, key), geo, device)
    return out.reshape(*sub[:-1], ctx.L_inner, ctx.n_inner)


def cbd_error(ctx, key: prng.Key, batch_shape, rows, k: int) -> torch.Tensor:
    """``bgv._sample_error_coeffs`` on the card: the centred-binomial error
    with parameter `k` from the words ``bits(key, (2, n_words, *batch, L,
    N'))``, as int32 residues ``[*, L, L', N']``."""
    device = _check_device(ctx.device, "cbd_error")
    n_words = -(-k // 32)
    geo, sub = _enc_geometry(ctx, batch_shape, rows)
    moduli = np.ascontiguousarray(ctx.inner_primes, dtype=np.uint32)
    if len(moduli) > MAX_COLUMNS:
        raise ValueError(f"{len(moduli)} inner primes: a launch takes at most {MAX_COLUMNS}")
    out = torch.empty((geo.rows, geo.A, len(moduli), geo.I), dtype=_I32, device=device)
    if out.numel():
        last_mask = (1 << (k - 32 * (n_words - 1))) - 1
        _launch("cbd_error", "ringsnark_prng_cbd", device, out.data_ptr(), moduli.ctypes.data,
                len(moduli), key[0], key[1], n_words, last_mask, *geo.args())
    return out.reshape(*sub[:-1], ctx.L_inner, ctx.n_inner)


def _lift(ctx, pt: torch.Tensor, level: int, width: int, error) -> torch.Tensor:
    """One launch of lift_kernel: pt int32 ``[*, L, I]`` or, where its last
    extent is 1 and `width` is not, the scalar ``[*, L, 1]`` (coefficient 0);
    `error` None or (key, n_words, last_mask, geometry of the draw)."""
    device = pt.device
    pt = pt.contiguous()  # a row range of a batch is already contiguous
    _check(pt, "lift (pt)")
    C = ctx.L_inner - level
    if pt.dim() < 2 or pt.shape[-2] != ctx.L or pt.shape[-1] not in (1, width) or \
            width & (width - 1) or not 0 <= level < ctx.L_inner:
        raise ValueError(f"cuda_prng.lift: plaintext shape {tuple(pt.shape)} at level {level}, "
                         f"want [*, {ctx.L}, {width} or 1], a power of two")
    rows = math.prod(pt.shape[:-2])
    words = rows * ctx.L * C * width
    if words >= 1 << 32:
        raise ValueError(f"cuda_prng.lift: {words} output words ({rows} rows, L={ctx.L}, "
                         f"{C} columns, width {width}); a launch writes fewer than 2^32 "
                         f"(32-bit offsets)")
    k = lift_consts(ctx)
    out = torch.empty((*pt.shape[:-1], C, width), dtype=_I32, device=device)
    if out.numel():
        key, n_words, last_mask, geo = error or ((0, 0), 0, 0, geometry((rows, ctx.L, width)))
        if geo.rows != rows:
            raise ValueError(f"cuda_prng.lift: {rows} plaintext rows, the draw's are {geo.rows}")
        _launch("lift", "ringsnark_prng_lift", device, out.data_ptr(), pt.data_ptr(),
                k.data_ptr(), C, ctx.L_inner, int(pt.shape[-1] != width), key[0], key[1],
                n_words, last_mask, *geo.args())
    return out


def lift(ctx, pt: torch.Tensor, level: int = 0) -> torch.Tensor:
    """``bgv._lift_centered`` on the card, as int32: plaintext coefficients
    mod t_l ``[*, L, I]`` (I = N', or 1 for the Z_q slots) -> ``[*, L,
    L'_lvl, I]``."""
    return _lift(ctx, pt, level, pt.shape[-1], None)


def lift_error(ctx, pt: torch.Tensor, k_e: prng.Key, batch_shape, rows, k: int) -> torch.Tensor:
    """``bgv._lift_error_plain`` on the card: the lift at level 0 plus
    t_l * e mod Q_j for the centred-binomial error with parameter `k` that
    ``cbd_error(ctx, k_e, batch_shape, rows, k)`` writes, drawn in the
    kernel.  pt ``[*, L, N']``, or the Z_q slots ``[*, L, 1]``
    (coefficient 0, zero beyond) -> ``[*, L, L', N']``."""
    if not _error_lift_ok(ctx):
        raise ValueError("cuda_prng.lift_error: a plain modulus t_l above 2 Q_j: the lift is "
                         "not a residue mod Q_j there")
    n_words = -(-k // 32)
    geo, sub = _enc_geometry(ctx, batch_shape, rows)
    if tuple(pt.shape[:-1]) != tuple(sub[:-1]):
        raise ValueError(f"cuda_prng.lift_error: plaintext shape {tuple(pt.shape)}, the draw's "
                         f"rows are {sub}")
    last_mask = (1 << (k - 32 * (n_words - 1))) - 1
    return _lift(ctx, pt, 0, ctx.n_inner, (k_e, n_words, last_mask, geo))


def encrypt(ctx, sk, u: torch.Tensor, k_a: prng.Key, batch_shape, rows=None,
            c0_out=None) -> tuple:
    """``(c0, c1)`` of ``bgv.encrypt`` on the card from ``u`` = NTT(lift +
    t*e) (int32 ``[*, L, L', N']``, inner-NTT form): c1 is the uniform mask
    of `k_a` (``uniform(ctx, k_a, batch_shape, rows)``, drawn in registers)
    and c0 = u - c1*s mod Q_j.  With `c0_out` (a contiguous int32 tensor of
    u's shape: the seeded CRS's rows) c0 is written there and c1 is neither
    written nor returned: ``(c0_out, None)``."""
    device = _check_device(ctx.device, "encrypt")
    geo, sub = _enc_geometry(ctx, batch_shape, rows)
    want = (*sub[:-1], ctx.L_inner, ctx.n_inner)
    _check(u, "encrypt (u)")
    if tuple(u.shape) != want:
        raise ValueError(f"cuda_prng.encrypt (u): shape {tuple(u.shape)}, the draw's is {want}")
    c0, c1 = (torch.empty_like(u), torch.empty_like(u)) if c0_out is None else (c0_out, None)
    _check(c0, "encrypt (c0_out)")
    if c0.shape != u.shape:
        raise ValueError(f"cuda_prng.encrypt (c0_out): shape {tuple(c0.shape)}, want {want}")
    if u.numel():
        table = _table(uniform_columns(ctx.inner_primes, k_a))
        _launch("encrypt", "ringsnark_prng_encrypt", device, c0.data_ptr(),
                None if c1 is None else c1.data_ptr(), u.data_ptr(), sk.s_pairs.data_ptr(),
                table.ctypes.data, ctx.L_inner, ctx.L, *geo.args())
    return c0, c1
