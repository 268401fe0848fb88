"""Evaluation domains for the QRP.

Port of ``ringsnark_tpu/utils/domain.py``:

* `RootsDomain` (the proving path's): per-limb power-of-two roots of unity
  with bit-reversed point labeling (matching ops/ntt.py).  Lagrange
  evaluation is O(M) in closed form, the vanishing polynomial is X^M - 1,
  and interpolation is a cyclic inverse NTT.
* `IntegerDomain` (the C++ reference's): the consecutive integers
  {0..m-1} with the reference's O(m^2) algorithms, for cross-checks on any
  ring-element type (RingElem, OracleElem).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ntt as _ntt
from ..ops.modops import mul_mod, inv_mod, sub_mod
from ..rings.context import RingContext
from ..rings.elem import RingElem
from . import poly as _poly

__all__ = ["RootsDomain", "IntegerDomain", "get_evaluation_domain"]


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


class RootsDomain:
    """Domain = the size-M subgroup of 2^k-th roots of unity, per limb.

    Point j is the ring constant with limb-l residue w_l^bitrev(j).  It is an
    exceptional set, and prod_j (x - x_j) = x^M - 1.
    """

    kind = "roots"

    def __init__(self, ctx: RingContext, min_size: int):
        assert min_size >= 1
        self.ctx = ctx
        self.m = _next_pow2(min_size)
        for p in ctx.primes:
            assert (p - 1) % (2 * self.m) == 0, (
                f"prime {p} cannot host a size-{self.m} roots domain (+ coset)"
            )
        self.plan = _ntt.get_plan(ctx.primes, self.m) if self.m > 1 else None
        if self.m == 1:
            self.points_np = np.ones((ctx.L, 1), dtype=np.uint32)
        else:
            self.points_np = self.plan.eval_points_np  # [L, M]

    def __hash__(self):
        return hash((self.ctx, self.m, "roots"))

    def __eq__(self, other):
        return isinstance(other, RootsDomain) and self.ctx == other.ctx and self.m == other.m

    # ---- reference interface (evaluation_domain.hpp:35-111) ---------------

    def get_domain_element(self, idx: int) -> RingElem:
        return RingElem(self.ctx, self.ctx.tensor(self.points_np[:, idx : idx + 1]))

    def elements(self) -> list:
        return [self.get_domain_element(i) for i in range(self.m)]

    def compute_vanishing_polynomial(self, t: RingElem) -> RingElem:
        """Z(t) = t^M - 1."""
        return t.pow(self.m) - 1

    def vanishing_polynomial(self) -> list:
        """Coefficients of Z = X^M - 1 (length M+1)."""
        ctx = self.ctx
        zero = RingElem.zero(ctx)
        return [RingElem.scalar(ctx, -1)] + [zero] * (self.m - 1) + [RingElem.one(ctx)]

    def add_poly_Z(self, coeff: RingElem, H: list) -> list:
        """H += coeff * Z (`evaluation_domain.tcc:63-76`), Z = X^M - 1."""
        while len(H) < self.m + 1:
            H.append(RingElem.zero(self.ctx))
        H[0] = H[0] - coeff
        H[self.m] = H[self.m] + coeff
        return H

    def divide_by_Z(self, P: list) -> list:
        """Exact quotient P / (X^M - 1) for deg(P) <= 2M-2, in O(M):
        q_j = sum_{k>=1} P[j + kM]."""
        M = self.m
        zero = RingElem.zero(self.ctx)
        q = [zero] * max(len(P) - M, 1)
        for j in range(len(q) - 1, -1, -1):
            acc = P[j + M] if j + M < len(P) else zero
            if j + 2 * M < len(P):  # deg(P) > 2M-2: fold higher terms
                acc = acc + q[j + M]
            q[j] = acc
        return q

    def evaluate_all_lagrange_polynomials(self, t: RingElem) -> RingElem:
        """L_j(t) = (t^M - 1) * x_j / (M * (t - x_j)), batched: [M, L, 1].

        Requires t^M != 1 mod every limb (guaranteed by `random_exceptional`).
        """
        ctx = self.ctx
        pts = ctx.tensor(self.points_np.T[:, :, None])  # [M, L, 1]
        zt = self.compute_vanishing_polynomial(t).res  # [L, 1]
        minv = ctx.tensor(self.plan.minv if self.plan is not None else np.ones((ctx.L, 1)))
        denom_inv = inv_mod(sub_mod(t.res, pts, ctx.p), ctx.p)
        num = mul_mod(mul_mod(zt, pts, ctx.p), minv, ctx.p)
        return RingElem(ctx, mul_mod(num, denom_inv, ctx.p))

    def interpolate_arr(self, evals: torch.Tensor) -> torch.Tensor:
        """[..., L, M] domain-indexed evaluations -> coefficients."""
        if self.m == 1:
            return evals
        return _ntt.cyclic_intt_nat(evals, self.plan)

    def evaluate_arr(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[..., L, M] coefficients -> domain-indexed evaluations."""
        if self.m == 1:
            return coeffs
        return _ntt.cyclic_ntt_rev(coeffs, self.plan)

    def random_exceptional(self, rng: np.random.Generator) -> RingElem:
        """Random scalar s with s and s^M - 1 invertible mod every limb
        (the same numpy draws as the JAX package)."""
        res = np.empty(self.ctx.L, dtype=np.uint32)
        for l, p in enumerate(self.ctx.primes):
            while True:
                v = int(rng.integers(1, p))
                if pow(v, self.m, p) != 1:
                    res[l] = v
                    break
        return RingElem(self.ctx, self.ctx.tensor(res[:, None]))


class IntegerDomain:
    """The C++ reference's domain {0, 1, ..., m-1} (`evaluation_domain.tcc`).

    Works with any ring-element type of the generic interface (RingElem,
    OracleElem).  Every method is the reference's O(m^2) algorithm through
    utils.poly: for cross-checks and tiny circuits only.
    """

    kind = "integer"

    def __init__(self, ctx, min_size: int, elem_cls=None):
        self.ctx = ctx
        self.m = min_size
        self.elem_cls = elem_cls or RingElem
        assert self.m < min(ctx.primes), "domain exceeds exceptional set"
        self.values = [self.elem_cls.scalar(ctx, i) for i in range(self.m)]

    def get_domain_element(self, idx: int):
        return self.values[idx]

    def elements(self) -> list:
        return list(self.values)

    def evaluate_all_lagrange_polynomials(self, t) -> list:
        """O(m^2) product formula (`evaluation_domain.tcc:21-41`)."""
        one = self.elem_cls.one(self.ctx)
        lagrange = []
        for j in range(self.m):
            num, den = one, one
            for i in range(self.m):
                if i != j:
                    num = num * (t - self.values[i])
                    den = den * (self.values[j] - self.values[i])
            lagrange.append(num / den)
        return lagrange

    def compute_vanishing_polynomial(self, t):
        res = t - self.values[0]
        for i in range(1, self.m):
            res = res * (t - self.values[i])
        return res

    def vanishing_polynomial(self) -> list:
        one = self.elem_cls.one(self.ctx)
        z = [-self.values[0], one]
        for i in range(1, self.m):
            z = _poly.multiply(z, [-self.values[i], one])
        return z

    def add_poly_Z(self, coeff, H: list) -> list:
        Z = self.vanishing_polynomial()
        for i in range(min(len(H), len(Z))):
            H[i] = H[i] + coeff * Z[i]
        while len(H) < len(Z):
            H.append(coeff * Z[len(H)])
        return H

    def divide_by_Z(self, P: list) -> list:
        return _poly.divide(P, self.vanishing_polynomial())

    def random_exceptional(self, rng: np.random.Generator):
        """Uniform integer in (m, q1) (`seal_ring.hpp:72-88`)."""
        v = int(rng.integers(self.m + 1, self.ctx.primes[0]))
        return self.elem_cls.scalar(self.ctx, v)


def get_evaluation_domain(ctx, min_size: int, kind: str = "roots", elem_cls=None):
    """The reference's `get_evaluation_domain` (`evaluation_domain.tcc:86-92`)."""
    if kind == "roots":
        return RootsDomain(ctx, min_size)
    if kind == "integer":
        return IntegerDomain(ctx, min_size, elem_cls=elem_cls)
    raise ValueError(kind)
