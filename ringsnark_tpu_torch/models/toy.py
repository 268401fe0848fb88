"""Toy 2-constraint circuit (examples/example_SEAL{,_int}.cpp); port of
``ringsnark_tpu/models/toy.py``.

x5 = x2*x3; x4 = (x0+x1)*x5; x5 private, the rest public.  With
``replicate=k`` the circuit is instantiated per slot over k scalar copies —
the `example_SEAL_int.cpp:53-58` batched-vs-scalar trade-off demo.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import PBVariableArray, Protoboard
from ..relations.r1cs import R1CSConstraint
from ..rings.context import RingContext
from ..rings.elem import RingElem

__all__ = ["build_toy_circuit"]


def build_toy_circuit(
    ctx: RingContext, rng: np.random.Generator, replicate: int = 1
) -> Protoboard:
    n = 6
    pb = Protoboard(ctx)
    vars = PBVariableArray()
    vars.allocate(pb, n * replicate, "x")
    pb.set_input_sizes((n - 1) * replicate)

    # variable layout matches example_SEAL_int: block j holds copies of x_j
    def v(j, i):
        return vars[j * replicate + i]

    for i in range(replicate):
        pb.add_r1cs_constraint(R1CSConstraint(v(2, i), v(3, i), v(5, i)))
        pb.add_r1cs_constraint(
            R1CSConstraint(v(0, i) + v(1, i), v(5, i), v(4, i))
        )

    for i in range(replicate):
        vals = [RingElem.random_element(ctx, rng) for _ in range(4)]
        v5 = vals[2] * vals[3]
        v4 = (vals[0] + vals[1]) * v5
        for j, val in enumerate(vals):
            pb.set_val(v(j, i), val)
        pb.set_val(v(4, i), v4)
        pb.set_val(v(5, i), v5)
    return pb
