"""Concrete gadgets (port of ``ringsnark_tpu/gadgets/basic_gadgets.py``).

The reference ships only the abstract base (`gadget.hpp:15-23`); its
bit-decomposition circuit exists inline in
`examples/example_plaintext_check_SEAL.cpp:47-54`.  Here they are reusable.
"""

from __future__ import annotations

import numpy as np

from ..relations.r1cs import R1CSConstraint
from ..relations.variable import LinearCombination
from ..rings.elem import RingElem
from .gadget import Gadget
from .pb_variable import PBVariable, PBVariableArray, pb_packing_sum

__all__ = ["BitDecompositionGadget", "InnerProductGadget"]


class BitDecompositionGadget(Gadget):
    """Slotwise bit-decomposition: x = sum_i 2^i b_i with b_i(1-b_i) = 0.

    The "plaintext check" of verifiable FHE (reference
    `example_plaintext_check_SEAL.cpp:47-54`): each slot of every bit
    variable holds one bit of the corresponding slot value of `x`.
    Emits logT+1 constraints.
    """

    def __init__(self, pb, x: PBVariable, log_t: int, annotation_prefix: str = "bitdec"):
        super().__init__(pb, annotation_prefix)
        self.x = x
        self.log_t = log_t
        self.bits = PBVariableArray()
        self.bits.allocate(pb, log_t, f"{annotation_prefix}_bit")

    def generate_r1cs_constraints(self):
        for i, b in enumerate(self.bits):
            self.pb.add_r1cs_constraint(
                R1CSConstraint(b, 1 - b, LinearCombination(0)),
                f"{self.annotation_prefix}_booleanity_{i}",
            )
        self.pb.add_r1cs_constraint(
            R1CSConstraint(self.x, 1, pb_packing_sum(self.bits)),
            f"{self.annotation_prefix}_packing",
        )

    def generate_r1cs_witness(self):
        ctx = self.pb.ctx
        x = self.pb.val(self.x).broadcast_to_poly()
        slots = x.numpy()  # [L, N] residues (one host read)
        # the integer each slot holds, by CRT over the limbs (a value of
        # log_t = 32 bits exceeds one 31-bit limb)
        vals = np.array([ctx.from_rns(slots[:, j]) for j in range(ctx.N)], dtype=object)
        assert (vals < (1 << self.log_t)).all(), "value too large for bit width"
        vals = vals.astype(np.uint64)
        for i, b in enumerate(self.bits):
            bits_i = ((vals >> np.uint64(i)) & np.uint64(1)).astype(np.uint32)
            res = np.broadcast_to(bits_i, (ctx.L, ctx.N)).copy()
            self.pb.set_val(b, RingElem.from_slots(ctx, res))


class InnerProductGadget(Gadget):
    """result = sum_i x_i * y_i via running partial sums.

    Emits n constraints: s_0 = x_0*y_0; s_k - s_{k-1} = x_k*y_k.
    """

    def __init__(self, pb, xs, ys, result: PBVariable, annotation_prefix: str = "ip"):
        super().__init__(pb, annotation_prefix)
        assert len(xs) == len(ys) and xs
        self.xs, self.ys, self.result = xs, ys, result
        self.partials = PBVariableArray()
        self.partials.allocate(pb, len(xs) - 1, f"{annotation_prefix}_partial")

    def generate_r1cs_constraints(self):
        n = len(self.xs)
        for k in range(n):
            prev = LinearCombination(0) if k == 0 else LinearCombination(self.partials[k - 1])
            target = self.result if k == n - 1 else self.partials[k]
            self.pb.add_r1cs_constraint(
                R1CSConstraint(self.xs[k], self.ys[k], target - prev),
                f"{self.annotation_prefix}_{k}",
            )

    def generate_r1cs_witness(self):
        acc = None
        n = len(self.xs)
        for k in range(n):
            prod = self.pb.val(self.xs[k]) * self.pb.val(self.ys[k])
            acc = prod if acc is None else acc + prod
            if k < n - 1:
                self.pb.set_val(self.partials[k], acc)
        self.pb.set_val(self.result, acc)
