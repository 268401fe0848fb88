"""Formal variables, linear terms and linear combinations.

The port's own copy of ``ringsnark_tpu/relations/variable.py`` (pure
Python): the host-side symbolic layer after the reference's
`variable/linear_term/linear_combination` (`variable.hpp:48-233`).  Index 0
is the constant 1 (`variable.tcc:251`); term lists are kept sorted by index
with merged duplicates (`variable.tcc:267-300, 452-474`).

Coefficients are Python ints (the symbolic layer is ring-agnostic until
compiled) or `RingElem`s.  A `RingElem` coefficient lives on its context's
device: comparing two of them or asking `is_zero` reads the device.
"""

from __future__ import annotations

from typing import Iterable, Union

__all__ = ["Variable", "LinearTerm", "LinearCombination", "ONE_INDEX"]

ONE_INDEX = 0  # variable index 0 ≡ the constant 1

Coeff = Union[int, object]  # int | RingElem


def _coeff_mul(a: Coeff, b: Coeff):
    if isinstance(a, int) and isinstance(b, int):
        return a * b
    if isinstance(a, int):
        return b * a
    return a * b


def _coeff_add(a: Coeff, b: Coeff):
    if isinstance(a, int) and isinstance(b, int):
        return a + b
    if isinstance(a, int):
        return b + a
    return a + b


def _coeff_is_zero(a: Coeff) -> bool:
    if isinstance(a, int):
        return a == 0
    return a.is_zero()


class Variable:
    """x_{index}; index 0 is the constant 1."""

    __slots__ = ("index",)

    def __init__(self, index: int = 0):
        self.index = index

    def __mul__(self, coeff: Coeff) -> "LinearTerm":
        return LinearTerm(self.index, coeff)

    __rmul__ = __mul__

    def __add__(self, other) -> "LinearCombination":
        return LinearCombination(self) + other

    __radd__ = __add__

    def __sub__(self, other) -> "LinearCombination":
        return LinearCombination(self) - other

    def __rsub__(self, other) -> "LinearCombination":
        return LinearCombination(other) - LinearCombination(self)

    def __neg__(self) -> "LinearTerm":
        return LinearTerm(self.index, -1)

    def __eq__(self, other):
        return isinstance(other, Variable) and self.index == other.index

    def __hash__(self):
        return hash(("var", self.index))

    def __repr__(self):
        return "1" if self.index == ONE_INDEX else f"x_{self.index}"


class LinearTerm:
    """coeff * x_{index}."""

    __slots__ = ("index", "coeff")

    def __init__(self, index: int, coeff: Coeff = 1):
        self.index = index
        self.coeff = coeff

    def __mul__(self, c: Coeff) -> "LinearTerm":
        return LinearTerm(self.index, _coeff_mul(self.coeff, c))

    __rmul__ = __mul__

    def __neg__(self) -> "LinearTerm":
        return LinearTerm(self.index, _coeff_mul(self.coeff, -1))

    def __add__(self, other) -> "LinearCombination":
        return LinearCombination(self) + other

    __radd__ = __add__

    def __sub__(self, other) -> "LinearCombination":
        return LinearCombination(self) - other

    def __repr__(self):
        return f"({self.coeff!r})*x_{self.index}"


def _as_terms(x) -> list[LinearTerm]:
    """Coerce int | ring elem | Variable | LinearTerm | LinearCombination."""
    if isinstance(x, LinearCombination):
        return list(x.terms)
    if isinstance(x, LinearTerm):
        return [x]
    if isinstance(x, Variable):
        return [LinearTerm(x.index, 1)]
    # constant: int or ring element
    return [LinearTerm(ONE_INDEX, x)]


class LinearCombination:
    """sum_i coeff_i * x_i, terms sorted by index, duplicates merged."""

    __slots__ = ("terms",)

    def __init__(self, x=None):
        if x is None:
            self.terms: list[LinearTerm] = []
        else:
            self.terms = _as_terms(x)

    @classmethod
    def from_terms(cls, terms: Iterable[LinearTerm]) -> "LinearCombination":
        """Sort + merge duplicates (reference ctor, variable.tcc:452-474)."""
        lc = cls()
        ts = sorted(terms, key=lambda t: t.index)
        for t in ts:
            if lc.terms and lc.terms[-1].index == t.index:
                lc.terms[-1] = LinearTerm(
                    t.index, _coeff_add(lc.terms[-1].coeff, t.coeff)
                )
            else:
                lc.terms.append(LinearTerm(t.index, t.coeff))
        return lc

    def __add__(self, other) -> "LinearCombination":
        """Sorted merge-add (variable.tcc:267-300)."""
        a, b = self.terms, _as_terms(other)
        out: list[LinearTerm] = []
        i = j = 0
        while i < len(a) and j < len(b):
            if a[i].index < b[j].index:
                out.append(a[i])
                i += 1
            elif a[i].index > b[j].index:
                out.append(b[j])
                j += 1
            else:
                out.append(LinearTerm(a[i].index, _coeff_add(a[i].coeff, b[j].coeff)))
                i += 1
                j += 1
        out.extend(a[i:])
        out.extend(b[j:])
        res = LinearCombination()
        res.terms = out
        return res

    __radd__ = __add__

    def __sub__(self, other) -> "LinearCombination":
        return self + (-LinearCombination(other))

    def __rsub__(self, other) -> "LinearCombination":
        return LinearCombination(other) + (-self)

    def __neg__(self) -> "LinearCombination":
        return self * -1

    def __mul__(self, c: Coeff) -> "LinearCombination":
        res = LinearCombination()
        res.terms = [t * c for t in self.terms]
        return res

    __rmul__ = __mul__

    def evaluate(self, assignment: list, one):
        """Evaluate given the assignment (without the leading constant).

        `one` is the ring's multiplicative identity (determines the ring).
        Mirrors `variable.tcc:246-254`: index k>0 reads assignment[k-1].
        """
        acc = one - one  # zero of the right ring
        for t in self.terms:
            base = one if t.index == ONE_INDEX else assignment[t.index - 1]
            acc = acc + base * t.coeff
        return acc

    def is_valid(self, num_variables: int) -> bool:
        for i in range(1, len(self.terms)):
            if self.terms[i - 1].index >= self.terms[i].index:
                return False
        return not self.terms or self.terms[-1].index < num_variables

    def __eq__(self, other):
        if not isinstance(other, LinearCombination):
            other = LinearCombination(other)
        return [(t.index, t.coeff) for t in self.terms] == [
            (t.index, t.coeff) for t in other.terms
        ]

    def __repr__(self):
        return " + ".join(map(repr, self.terms)) or "0"
