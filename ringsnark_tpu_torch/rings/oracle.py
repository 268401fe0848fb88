"""Pure-Python oracle ring for testing generic algorithms.

Copy of ``ringsnark_tpu/rings/oracle.py`` (which imports numpy only), the
analog of the C++ reference's `PrimitiveWrapper<double>` fake backend
(`ringsnark/util/test_utils.hpp:7-68`): a minimal exact implementation of
the ring interface in Python integers, used to test the generic algorithms
(interpolation, domains, reductions) apart from the tensor path, and as
ground truth in cross-checks.
"""

from __future__ import annotations

import numpy as np

__all__ = ["OracleElem", "OracleContext"]


class OracleContext:
    """Z_q for q = prod(primes) — exact Python-int arithmetic."""

    def __init__(self, primes):
        self.primes = tuple(primes)
        self.q = 1
        for p in self.primes:
            self.q *= p
        self.N = 1
        self.L = len(self.primes)

    def __hash__(self):
        return hash(self.primes)

    def __eq__(self, other):
        return isinstance(other, OracleContext) and self.primes == other.primes


class OracleElem:
    __slots__ = ("ctx", "v")

    def __init__(self, ctx: OracleContext, v: int):
        self.ctx = ctx
        self.v = v % ctx.q

    @classmethod
    def scalar(cls, ctx, v):
        return cls(ctx, int(v))

    zero = classmethod(lambda cls, ctx: cls(ctx, 0))
    one = classmethod(lambda cls, ctx: cls(ctx, 1))

    @classmethod
    def random_element(cls, ctx, rng: np.random.Generator):
        return cls(ctx, int(rng.integers(0, min(ctx.q, 2**63))))

    @classmethod
    def random_invertible_element(cls, ctx, rng):
        while True:
            e = cls.random_element(ctx, rng)
            if e.is_invertible():
                return e

    random_nonzero_element = random_invertible_element

    @classmethod
    def random_exceptional_element(cls, ctx, rng, domain=None):
        if domain is not None:
            return domain.random_exceptional(rng)
        return cls(ctx, int(rng.integers(2, ctx.primes[0])))

    def _c(self, o):
        if isinstance(o, OracleElem):
            return o
        if isinstance(o, (int, np.integer)):
            return OracleElem(self.ctx, int(o))
        return NotImplemented

    def __add__(self, o):
        o = self._c(o)
        return OracleElem(self.ctx, self.v + o.v)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._c(o)
        return OracleElem(self.ctx, self.v - o.v)

    def __rsub__(self, o):
        return self._c(o) - self

    def __mul__(self, o):
        o = self._c(o)
        return OracleElem(self.ctx, self.v * o.v)

    __rmul__ = __mul__

    def __neg__(self):
        return OracleElem(self.ctx, -self.v)

    def __truediv__(self, o):
        return self * self._c(o).inverse()

    def inverse(self):
        # CRT-wise inverse (q is composite; invertible iff coprime to q)
        return OracleElem(self.ctx, pow(self.v, -1, self.ctx.q))

    def pow(self, e: int):
        return OracleElem(self.ctx, pow(self.v, e, self.ctx.q))

    def is_zero(self):
        return self.v == 0

    def is_invertible(self):
        return all(self.v % p for p in self.ctx.primes)

    def __eq__(self, o):
        o = self._c(o)
        return o is not NotImplemented and self.v == o.v

    def __hash__(self):
        return hash((self.ctx.primes, self.v))

    def to_int(self):
        return self.v

    def __repr__(self):
        return f"OracleElem({self.v})"
