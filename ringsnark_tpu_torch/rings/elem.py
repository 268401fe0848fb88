"""Ring elements in slot form.

Port of ``ringsnark_tpu/rings/elem.py``.  Shape convention:
``res: int32[*batch, L, n]`` with ``n ∈ {1, N}``; a trailing axis of size 1
is a ring constant broadcast over every slot.  Arithmetic is elementwise in
slot form (int64 products, see ops/modops.py).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..ops.modops import add_mod, sub_mod, neg_mod, mul_mod, inv_mod, pow_mod
from ..ops.ntt import negacyclic_ntt_rev, negacyclic_intt_nat
from .context import RingContext

__all__ = ["RingElem"]


class RingElem:
    """An element (or batch of elements) of R = Z_q[X]/(X^N+1) or Z_q."""

    __slots__ = ("ctx", "res")

    def __init__(self, ctx: RingContext, res: torch.Tensor):
        self.ctx = ctx
        self.res = res  # int32[*batch, L, n] on ctx.device

    # ---- constructors -----------------------------------------------------

    @classmethod
    def scalar(cls, ctx: RingContext, value: int) -> "RingElem":
        return cls(ctx, ctx.tensor(ctx.to_rns(int(value))[:, None]))

    @classmethod
    def zero(cls, ctx: RingContext) -> "RingElem":
        return cls.scalar(ctx, 0)

    @classmethod
    def one(cls, ctx: RingContext) -> "RingElem":
        return cls.scalar(ctx, 1)

    @classmethod
    def from_slots(cls, ctx: RingContext, slots) -> "RingElem":
        """Build from slot values [..., L, n], n in {1, N}: a numpy array of
        unsigned 32-bit values or an int32 tensor holding them.  Values are
        reduced mod each limb's prime (the JAX package stores them as given,
        its uint32 arithmetic reducing at the first multiply; int32 residues
        must be canonical), so a value up to 2^32 - 1 may be passed."""
        if not isinstance(slots, torch.Tensor):
            slots = ctx.tensor(slots)
        assert slots.shape[-2] == ctx.L and slots.shape[-1] in (1, ctx.N)
        return cls(ctx, ctx.canonical(slots))

    @classmethod
    def from_coeffs(cls, ctx: RingContext, coeffs) -> "RingElem":
        """Build from coefficient form [..., L, N] (applies forward NTT).
        Like `from_slots`, the words (up to 2^32 - 1) are reduced mod each
        limb's prime first: the JAX package's first uint32 Barrett multiply
        reduces them, and the kernels take canonical residues."""
        coeffs = coeffs if isinstance(coeffs, torch.Tensor) else ctx.tensor(coeffs)
        coeffs = ctx.canonical(coeffs)
        if ctx.N == 1:
            return cls(ctx, coeffs)
        return cls(ctx, negacyclic_ntt_rev(coeffs, ctx.ntt_plan))

    @classmethod
    def from_int_coeffs(cls, ctx: RingContext, int_coeffs: Iterable[int]) -> "RingElem":
        """Build from a list of integer coefficients (reduced on the host,
        one upload, one forward NTT)."""
        cs = [int(c) for c in int_coeffs]
        assert len(cs) <= ctx.N
        arr = np.zeros((ctx.L, ctx.N), dtype=np.uint32)
        for l, p in enumerate(ctx.primes):
            arr[l, : len(cs)] = [c % p for c in cs]
        return cls.from_coeffs(ctx, arr)

    # ---- sampling (host-side numpy RNG, the same calls in the same order
    # as the JAX package, so the same seed gives the same secrets) ---------

    @classmethod
    def random_element(cls, ctx: RingContext, rng: np.random.Generator) -> "RingElem":
        res = np.stack(
            [rng.integers(0, p, ctx.N, dtype=np.uint64) for p in ctx.primes]
        ).astype(np.uint32)
        return cls(ctx, ctx.tensor(res))

    @classmethod
    def random_invertible_element(
        cls, ctx: RingContext, rng: np.random.Generator
    ) -> "RingElem":
        # uniform over invertible elements == independent uniform nonzero slots
        res = np.stack(
            [rng.integers(1, p, ctx.N, dtype=np.uint64) for p in ctx.primes]
        ).astype(np.uint32)
        return cls(ctx, ctx.tensor(res))

    @classmethod
    def random_nonzero_element(cls, ctx: RingContext, rng: np.random.Generator) -> "RingElem":
        """`random_element` draws until one is not zero (the same draws)."""
        while True:
            e = cls.random_element(ctx, rng)
            if not e.is_zero():
                return e

    @classmethod
    def random_exceptional_element(
        cls, ctx: RingContext, rng: np.random.Generator, domain=None
    ) -> "RingElem":
        """A random scalar suitable as the secret evaluation point (with a
        domain: ``domain.random_exceptional``; without: uniform in [2, q_1))."""
        if domain is not None:
            return domain.random_exceptional(rng)
        return cls.scalar(ctx, int(rng.integers(2, ctx.primes[0])))

    # ---- shape / variant queries ------------------------------------------

    @property
    def is_scalar(self) -> bool:
        return self.res.shape[-1] == 1

    @property
    def is_poly(self) -> bool:
        return self.res.shape[-1] != 1

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.res.shape[:-2])

    def broadcast_to_poly(self) -> "RingElem":
        if self.res.shape[-1] == self.ctx.N:
            return self
        return RingElem(self.ctx, self.res.expand(*self.res.shape[:-1], self.ctx.N))

    # ---- arithmetic --------------------------------------------------------

    def _coerce(self, other) -> "RingElem":
        if isinstance(other, RingElem):
            assert other.ctx == self.ctx
            return other
        if isinstance(other, (int, np.integer)):
            return RingElem.scalar(self.ctx, int(other))
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return RingElem(self.ctx, add_mod(self.res, o.res, self.ctx.p))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return RingElem(self.ctx, sub_mod(self.res, o.res, self.ctx.p))

    def __rsub__(self, other):
        o = self._coerce(other)
        return RingElem(self.ctx, sub_mod(o.res, self.res, self.ctx.p))

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return RingElem(self.ctx, mul_mod(self.res, o.res, self.ctx.p))

    __rmul__ = __mul__

    def __neg__(self):
        return RingElem(self.ctx, neg_mod(self.res, self.ctx.p))

    def __truediv__(self, other):
        o = self._coerce(other)
        return self * o.inverse()

    def inverse(self) -> "RingElem":
        """Per-slot modular inverse.  Caller must ensure invertibility."""
        return RingElem(self.ctx, inv_mod(self.res, self.ctx.p))

    def pow(self, e: int) -> "RingElem":
        ebits = max(int(e).bit_length(), 1)
        return RingElem(self.ctx, pow_mod(self.res, int(e), self.ctx.p, ebits=ebits))

    # ---- predicates (host-side) -------------------------------------------

    def numpy(self) -> np.ndarray:
        """Residues as uint32 numpy (host copy)."""
        return self.res.cpu().numpy().view(np.uint32)

    def is_zero(self) -> bool:
        return not bool(self.res.any())

    def is_invertible(self) -> bool:
        return bool(self.res.all())

    def __eq__(self, other):
        if isinstance(other, (int, np.integer)):
            other = RingElem.scalar(self.ctx, int(other))
        if not isinstance(other, RingElem):
            return NotImplemented
        if self.ctx != other.ctx:
            return False
        a, b = torch.broadcast_tensors(self.res, other.res)
        return bool(torch.equal(a, b))

    def __hash__(self):
        return hash((self.ctx, self.numpy().tobytes()))

    # ---- conversions -------------------------------------------------------

    def to_coeffs(self) -> torch.Tensor:
        """Coefficient form, int32[..., L, N]."""
        if self.ctx.N == 1:
            return self.broadcast_to_poly().res
        return negacyclic_intt_nat(self.broadcast_to_poly().res, self.ctx.ntt_plan)

    def to_int(self) -> int:
        """CRT-composed integer value — scalar (n==1, no batch) elements only."""
        r = self.numpy()
        assert r.shape == (self.ctx.L, 1)
        return self.ctx.from_rns(r[:, 0])

    # ---- batching ----------------------------------------------------------

    @staticmethod
    def stack(elems: list["RingElem"]) -> "RingElem":
        """Stack a list into a batch, promoting scalars to a common slot axis."""
        assert elems
        ctx = elems[0].ctx
        n = max(e.res.shape[-1] for e in elems)
        return RingElem(
            ctx, torch.stack([e.res.expand(*e.res.shape[:-1], n) for e in elems])
        )

    def __getitem__(self, idx) -> "RingElem":
        return RingElem(self.ctx, self.res[idx])

    def __len__(self):
        assert self.batch_shape, "not a batch"
        return self.res.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        if self.res.shape[-1] == 1 and self.res.ndim == 2:
            return f"RingElem({self.to_int()})"
        return f"RingElem(shape={tuple(self.res.shape)}, L={self.ctx.L}, N={self.ctx.N})"
