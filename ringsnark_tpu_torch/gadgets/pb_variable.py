"""Protoboard-bound variables and linear combinations.

Port of ``ringsnark_tpu/gadgets/pb_variable.py`` (pure Python), after the
reference's `gadgetlib/pb_variable.hpp:24-164` (+.tcc):
`pb_variable::allocate`, `pb_variable_array` bulk allocate/fill,
`pb_linear_combination{,_array}` with protoboard-cached evaluation, and the
helpers `pb_sum`, `pb_packing_sum`, `pb_coeff_sum` (`pb_variable.tcc:261-302`).
"""

from __future__ import annotations

from ..relations.variable import Variable, LinearCombination

__all__ = [
    "PBVariable",
    "PBVariableArray",
    "PBLinearCombination",
    "PBLinearCombinationArray",
    "pb_sum",
    "pb_packing_sum",
    "pb_coeff_sum",
]


class PBVariable(Variable):
    """A variable with protoboard allocation (`pb_variable.tcc:24-35`)."""

    def allocate(self, pb, annotation: str = ""):
        self.index = pb.allocate_var_index(annotation)
        return self


class PBVariableArray(list):
    """list of PBVariable with bulk allocate/fill (`pb_variable.tcc:37-111`)."""

    def allocate(self, pb, n: int, annotation_prefix: str = ""):
        self.clear()
        for i in range(n):
            v = PBVariable()
            v.allocate(pb, f"{annotation_prefix}_{i}")
            self.append(v)
        return self

    def fill_with_ring_elems(self, pb, values):
        assert len(values) == len(self)
        for v, val in zip(self, values):
            pb.set_val(v, val)

    def get_vals(self, pb):
        return [pb.val(v) for v in self]


class PBLinearCombination(LinearCombination):
    """LC with a protoboard-cached value (`pb_variable.tcc:113-259`)."""

    def __init__(self, x=None):
        super().__init__(x)
        self.index = -1
        self.is_variable = isinstance(x, Variable)
        if self.is_variable:
            self.index = x.index

    def assign(self, pb, lc: LinearCombination):
        assert not self.is_variable
        self.terms = list(lc.terms)
        self.index = pb.allocate_lc_index()

    def evaluate(self, pb):
        if self.is_variable:
            return
        val = super().evaluate(pb.values_list(), pb.one_value())
        pb.set_lc_val(self, val)


class PBLinearCombinationArray(list):
    def evaluate(self, pb):
        for lc in self:
            lc.evaluate(pb)


def pb_sum(vars_or_lcs) -> LinearCombination:
    """sum_i x_i (`pb_variable.tcc:261-270`)."""
    acc = LinearCombination()
    for v in vars_or_lcs:
        acc = acc + v
    return acc


def pb_packing_sum(bits) -> LinearCombination:
    """sum_i 2^i * b_i (`pb_variable.tcc:272-283`)."""
    acc = LinearCombination()
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    return acc


def pb_coeff_sum(vars_or_lcs, coeffs) -> LinearCombination:
    """sum_i coeff_i * x_i (`pb_variable.tcc:285-302`)."""
    assert len(vars_or_lcs) == len(coeffs)
    acc = LinearCombination()
    for v, c in zip(vars_or_lcs, coeffs):
        acc = acc + v * c
    return acc
