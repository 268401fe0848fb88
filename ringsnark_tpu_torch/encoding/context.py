"""Encoding context: inner BGV parameters shared by all outer limbs.

Port of ``ringsnark_tpu/encoding/context.py``.  The outer ring's primes are
the plain moduli t_i (double batching: they are ≡ 1 mod 2N'); the inner
ciphertext primes Q_j form the modswitch chain.  Tensors live on
``ring.device``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

from ..ops import primes as _primes
from ..ops import ntt as _ntt
from ..ops.cuda_prng import shoup_pairs
from ..rings.context import RingContext

__all__ = [
    "EncodingContext",
    "SecretKey",
    "keygen",
    "max_inner_modulus_bits",
    "default_inner_primes",
]

# Homomorphic-encryption-standard max log2(Q) for 128-bit security with
# ternary secret (the table SEAL's CoeffModulus::BFVDefault enforces).
_HE_STD_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}


def max_inner_modulus_bits(n_inner: int) -> int:
    return _HE_STD_128[n_inner]


def default_inner_primes(
    n_inner: int, outer_primes: tuple[int, ...], count: int | None = None
) -> tuple[int, ...]:
    """Inner ciphertext primes: < 2^31, ≡ 1 mod 2N', distinct from the outer
    primes, descending, within the 128-bit-security budget.  A degree
    outside the security table (test scale) takes `count` primes unchecked;
    `EncodingContext` checks the budget where the table has one."""
    if count is None or n_inner in _HE_STD_128:
        budget_bits = max_inner_modulus_bits(n_inner)
        count = count if count is not None else budget_bits // 31
        assert count * 31 <= budget_bits, (
            f"{count} x 31-bit limbs exceed the {budget_bits}-bit budget for N'={n_inner}"
        )
    found: list[int] = []
    below = 1 << 31
    while len(found) < count:
        cand = _primes.find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = cand
        if cand not in outer_primes:
            found.append(cand)
    return tuple(found)


@dataclass(frozen=True)
class EncodingContext:
    """Static parameters of the batched BGV encoding scheme."""

    ring: RingContext  # outer ring; ring.primes are the plain moduli t_i
    n_inner: int  # N' — inner polynomial degree
    inner_primes: tuple[int, ...]  # Q_j — ciphertext modulus chain
    error_stddev: float = 3.2
    # modswitch floor: never drop below this many remaining limbs (see
    # encoding/noise.plan_inner_chain)
    floor_limbs: int = 2

    def __post_init__(self):
        assert self.n_inner >= self.ring.N
        if self.n_inner in _HE_STD_128:  # sub-1024 degrees are test-scale only
            assert 31 * len(self.inner_primes) <= max_inner_modulus_bits(
                self.n_inner
            ), "ciphertext modulus exceeds the 128-bit security budget"
        for p in self.ring.primes:
            assert (p - 1) % (2 * self.n_inner) == 0, (
                f"outer prime {p} is not a batching-friendly plain modulus for "
                f"N'={self.n_inner} (double-batching rule)"
            )
        for Q in self.inner_primes:
            assert (Q - 1) % (2 * self.n_inner) == 0
            assert Q not in self.ring.primes

    @property
    def device(self) -> str:
        return self.ring.device

    @property
    def L(self) -> int:  # outer limbs
        return self.ring.L

    @property
    def L_inner(self) -> int:
        return len(self.inner_primes)

    @property
    def num_levels(self) -> int:
        """Usable modswitch levels: level k keeps inner_primes[: L_inner-k]."""
        return self.L_inner

    def level_primes(self, level: int) -> tuple[int, ...]:
        assert 0 <= level < self.L_inner
        return self.inner_primes[: self.L_inner - level]

    def Q_total(self, level: int = 0) -> int:
        """The ciphertext modulus at `level`: the product of its primes."""
        return math.prod(self.level_primes(level))

    def inner_plan(self, level: int = 0) -> _ntt.NTTPlan:
        """Negacyclic plan over the remaining inner primes at `level`."""
        return _ntt.get_plan(self.level_primes(level), self.n_inner, negacyclic=True)

    @cached_property
    def plain_plan(self) -> _ntt.NTTPlan:
        """Negacyclic plan over the outer primes (plain moduli) at N'."""
        return _ntt.get_plan(self.ring.primes, self.n_inner, negacyclic=True)

    @cached_property
    def t_np(self) -> np.ndarray:  # [L]
        return np.array(self.ring.primes, dtype=np.uint32)

    @cached_property
    def Q_np(self) -> np.ndarray:  # [L']
        return np.array(self.inner_primes, dtype=np.uint32)

    @cached_property
    def t_consts(self) -> torch.Tensor:
        """The plain moduli t_i as int64 ``[L, 1, 1]`` on the device."""
        return torch.as_tensor(self.t_np.astype(np.int64)[:, None, None], device=self.device)

    @cached_property
    def t_mod_Q(self) -> torch.Tensor:
        """t_i mod Q_j as int64[L, L', 1] (broadcast over N')."""
        t = self.t_np[:, None].astype(np.int64)
        Q = self.Q_np[None, :].astype(np.int64)
        return torch.as_tensor((t % Q)[:, :, None], device=self.device)

    @lru_cache(maxsize=None)
    def correction_factor(self, level: int) -> tuple[int, ...]:
        """Per outer limb: prod of dropped Q_j^{-1} mod t_i (BGV modswitch
        scales the plaintext by it; decode undoes it)."""
        out = []
        for t in self.ring.primes:
            f = 1
            for j in range(self.L_inner - level, self.L_inner):
                f = f * pow(self.inner_primes[j], -1, t) % t
            out.append(f)
        return tuple(out)

    @lru_cache(maxsize=None)
    def inner_consts(self, level: int = 0) -> torch.Tensor:
        """The inner primes at `level` as int64 ``[L'_lvl, 1]`` on the device."""
        return torch.tensor(self.level_primes(level), dtype=torch.int64,
                            device=self.device)[:, None]

    def size_in_bits(self, batch: int, level: int = 0) -> int:
        """Ciphertext size (2 polys), mirroring `seal_ring.tcc:305-315`."""
        return batch * self.L * 2 * (self.L_inner - level) * 31 * self.n_inner


@dataclass(frozen=True)
class SecretKey:
    """Per-outer-limb ternary BGV secret keys, stored in inner-NTT form.

    s_ntt: int32[L, L', N'] on the device; s_coeffs: int8[L, N'] numpy.
    """

    ctx: EncodingContext
    s_ntt: torch.Tensor
    s_coeffs: np.ndarray

    @cached_property
    def s_pairs(self) -> torch.Tensor:
        """s_ntt beside its Shoup constants floor(s * 2^32 / Q_j), int32
        ``[L, L', N', 2]`` (the encryption kernel's operand; made once a key)."""
        return shoup_pairs(self.s_ntt, self.ctx.inner_consts(0))


def keygen(ctx: EncodingContext, rng: np.random.Generator):
    """(public_key=None, secret_key) — symmetric encryption only.  The same
    numpy draw as the JAX package, so one seed gives one key in both."""
    s = rng.integers(-1, 2, size=(ctx.L, ctx.n_inner)).astype(np.int8)
    Q = ctx.Q_np.astype(np.int64)
    res = s[:, None, :].astype(np.int64) % Q[None, :, None]
    s_ntt = _ntt.negacyclic_ntt_rev(ctx.ring.tensor(res), ctx.inner_plan(0))
    return None, SecretKey(ctx=ctx, s_ntt=s_ntt, s_coeffs=s)
