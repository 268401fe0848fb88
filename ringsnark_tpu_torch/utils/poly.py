"""Generic dense polynomial utilities over any ring-element type.

Copy of ``ringsnark_tpu/utils/poly.py`` (pure Python): host-side,
list-based, the semantic mirror of the C++ reference's
`ringsnark/util/polynomials.hpp:17-41` (+.tcc): Numerical-Recipes Lagrange
`interpolate`, Horner `eval`, schoolbook `multiply`/`add`, long-division
`divide`.  Used by the reference-compatible IntegerDomain and as the slow
oracle in tests; the proving path replaces all of these with NTTs
(ops/ntt.py + utils/domain.RootsDomain).
"""

from __future__ import annotations

__all__ = ["interpolate", "eval_poly", "multiply", "add", "divide", "is_zero_poly"]


def interpolate(xs: list, ys: list) -> list:
    """Coefficients of the unique degree-<n interpolant through (xs, ys).

    Master-polynomial algorithm (`polynomials.tcc:10-43`); requires the
    pairwise differences of xs (and values of the derivative of the master
    polynomial) to be invertible — i.e. xs is an exceptional set.
    """
    assert len(xs) == len(ys)
    n = len(xs)
    one = _one_of(xs[0])
    zero = one - one
    coeffs = [zero] * n
    s = [zero] * n
    s[n - 1] = -xs[0]
    for i in range(1, n):
        for j in range(n - i - 1, n - 1):
            s[j] = s[j] - xs[i] * s[j + 1]
        s[n - 1] = s[n - 1] - xs[i]
    for j in range(n):
        phi = _scalar_of(one, n)
        for k in range(n - 1, 0, -1):
            phi = phi * xs[j] + s[k] * _scalar_of(one, k)
        ff = ys[j] / phi
        b = one
        for k in range(n - 1, -1, -1):
            coeffs[k] = coeffs[k] + b * ff
            b = b * xs[j] + s[k]
    return coeffs


def eval_poly(coeffs: list, x):
    """Horner evaluation (`polynomials.tcc:46-53`)."""
    res = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        res = res * x + c
    return res


def is_zero_poly(coeffs: list) -> bool:
    return all(c.is_zero() for c in coeffs)


def multiply(x: list, y: list) -> list:
    """Schoolbook product (`polynomials.tcc:62-66` via boost)."""
    one = _one_of(x[0])
    zero = one - one
    out = [zero] * (len(x) + len(y) - 1)
    for i, xi in enumerate(x):
        for j, yj in enumerate(y):
            out[i + j] = out[i + j] + xi * yj
    return out


def add(x: list, y: list) -> list:
    if len(x) < len(y):
        x, y = y, x
    out = list(x)
    for i, yi in enumerate(y):
        out[i] = out[i] + yi
    return out


def divide(numerator: list, denominator: list) -> list:
    """Quotient of polynomial long division (normalizes/strips like boost).

    The denominator's leading coefficient must be invertible (it is monic in
    every use here: the vanishing polynomial).
    """
    num = _strip(list(numerator))
    den = _strip(list(denominator))
    one = _one_of(den[0])
    zero = one - one
    dn = len(den) - 1
    lead_inv = den[-1].inverse()
    q = [zero] * max(len(num) - dn, 1)
    rem = list(num)
    for k in range(len(num) - dn - 1, -1, -1):
        q[k] = rem[k + dn] * lead_inv
        if not q[k].is_zero():
            for j in range(dn + 1):
                rem[k + j] = rem[k + j] - q[k] * den[j]
    return _strip(q)


def _strip(cs: list) -> list:
    while len(cs) > 1 and cs[-1].is_zero():
        cs.pop()
    return cs


def _one_of(x):
    return type(x).one(x.ctx)


def _scalar_of(one, k: int):
    return type(one).scalar(one.ctx, k)
