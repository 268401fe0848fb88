"""A counter-based PRNG with ``jax.random``'s bits: threefry2x32.

The JAX package encrypts with ``jax.random`` keys (the default
``threefry2x32`` implementation, with ``jax_threefry_partitionable=True``);
the seeded CRS keeps only ``c0`` and regenerates ``c1`` from
``fold_in(key, slab)``.  This module reproduces those semantics exactly
(jax 0.9.0, ``jax/_src/prng.py`` and ``jax/_src/random.py``), so one key
gives the same ciphertexts in both packages:

* ``key(seed)``: the raw key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``split(key, num)``: key j is ``threefry2x32(key, (0, j))`` (the fold-like
  split of partitionable mode);
* ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
* ``bits(key, shape)``: element j (flat, row-major) is ``y0 ^ y1`` of
  ``threefry2x32(key, (j >> 32, j & 0xFFFFFFFF))``;
* ``randint(key, shape, maxval, minval=0)``: 32-bit ``randint`` on
  ``[minval, maxval)``, unsigned or signed: two ``bits`` draws from
  ``split(key)`` combined mod the span as JAX does, then ``minval`` added.

A key is a pair of Python ints below 2^32 (its ``key_data``).  Key
derivation runs on the host in Python ints.  On a CUDA device ``bits`` and
``randint`` launch the threefry kernel (``ops/cuda_prng.py``,
``csrc/prng.cu``); elsewhere they run their plain versions, ``bits_plain``
and ``randint_plain``: int64 torch ops masked to 32 bits (torch's uint32
lacks add, shifts and ``%``), which run on any device.

Because element j of a draw depends only on the key and j, a draw can be
made in pieces: ``rows=(lo, hi)`` returns only the index range ``[lo, hi)``
along ``axis`` of the full ``shape``, bit-identical to that slice of the
whole draw.  Callers use it to bound their temporaries.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Key", "key", "split", "fold_in", "threefry2x32", "bits", "randint", "bits_plain",
           "randint_plain", "randint_multiplier"]

Key = tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under the
    key (k0, k1).  Operands are Python ints or int64 tensors holding values
    in [0, 2^32); tensors broadcast.  Returns (y0, y1) of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """The raw threefry key of a non-negative integer seed below 2^64, as
    ``jax.random.PRNGKey(seed)`` makes it."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not in [0, 2^64)")
    return (seed >> 32) & _MASK, seed & _MASK


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` in partitionable mode."""
    return [threefry2x32(k[0], k[1], j >> 32, j & _MASK) for j in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` (data taken as uint32)."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def _counters(shape, rows, axis: int, device) -> torch.Tensor:
    """Flat row-major indices of the sub-block ``[lo, hi)`` along `axis` of
    an array of `shape`, as int64 of the sub-block's shape."""
    shape = tuple(int(n) for n in shape)
    lo, hi = (0, shape[axis]) if rows is None else (int(rows[0]), int(rows[1]))
    assert 0 <= lo <= hi <= shape[axis], (rows, shape, axis)
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    c = torch.arange(lo * inner, hi * inner, dtype=torch.int64, device=device)
    if outer > 1:
        step = shape[axis] * inner
        c = (torch.arange(outer, dtype=torch.int64, device=device) * step)[:, None] + c
    return c.reshape(*shape[:axis], hi - lo, *shape[axis + 1:])


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def bits(k: Key, shape, device, rows=None, axis: int = 0) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2^32).

    ``rows=(lo, hi)`` draws only indices ``[lo, hi)`` along `axis` (the
    same bits as that slice of the full draw).  A CUDA device launches the
    kernel; any other runs `bits_plain`."""
    if _on_card(device):
        from ..ops import cuda_prng

        return cuda_prng.bits(k, shape, device, rows, axis)
    return bits_plain(k, shape, device, rows, axis)


def bits_plain(k: Key, shape, device, rows=None, axis: int = 0) -> torch.Tensor:
    """`bits` as int64 torch ops on `device` (the kernel's plain version)."""
    c = _counters(shape, rows, axis, device)
    hi = (c >> 32) if math.prod(shape) > _MASK else 0
    y0, y1 = threefry2x32(k[0], k[1], hi, c & _MASK)
    return y0 ^ y1


def randint_multiplier(span: int) -> int:
    """"2^32 mod span" as JAX forms it, in uint32: (2^16 mod span)^2 wraps to
    0 for spans above 2^16, so there the high word drops out entirely and
    is not drawn (every inner prime Q_j is such a span)."""
    return (((1 << 16) % span) ** 2 & _MASK) % span


def _span(maxval: int, minval: int) -> int:
    span = int(maxval) - int(minval)
    if not 0 < span <= 1 << 31 or not -(1 << 31) <= minval or maxval > 1 << 32:
        raise ValueError(f"[{minval}, {maxval}) is not a 32-bit range of span (0, 2^31]")
    return span


def randint(k: Key, shape, maxval: int, device, rows=None, axis: int = 0,
            minval: int = 0) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` with a 32-bit dtype
    (uint32 for ``minval >= 0``, int32 below), as int64 values.

    JAX draws two 32-bit words per value, from the two halves of
    ``split(k)``, and reduces ``hi * 2^32 + lo`` mod the span
    ``maxval - minval`` with uint32 arithmetic (products and sums wrap at
    2^32), then adds ``minval``; this does the same.  A CUDA device
    launches the kernel; any other runs `randint_plain`."""
    _span(maxval, minval)
    if _on_card(device):
        from ..ops import cuda_prng

        return cuda_prng.randint(k, shape, maxval, device, rows, axis, minval)
    return randint_plain(k, shape, maxval, device, rows, axis, minval)


def randint_plain(k: Key, shape, maxval: int, device, rows=None, axis: int = 0,
                  minval: int = 0) -> torch.Tensor:
    """`randint` as int64 torch ops on `device` (the kernel's plain version)."""
    span = _span(maxval, minval)
    k_hi, k_lo = split(k)
    mult = randint_multiplier(span)
    off = torch.remainder(bits_plain(k_lo, shape, device, rows, axis), span)
    if mult:
        hi = (torch.remainder(bits_plain(k_hi, shape, device, rows, axis), span) * mult) & _MASK
        off = torch.remainder((hi + off) & _MASK, span)
    return off + int(minval) if minval else off
