"""Verifiable encrypted logistic-regression inference
(benchmarks/bench_logistic_regression_inference.cpp:64-131); port of
``ringsnark_tpu/models/logreg.py``.

A num_features-dimensional encrypted dot product over ciphertext components
(4 products + running sums per feature) followed by a degree-2 sigmoid
approximation (squaring of the 3-component dot-product result):
~4*num_features + 7 constraints.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import PBVariable, PBVariableArray, Protoboard
from ..relations.r1cs import R1CSConstraint
from ..relations.variable import LinearCombination
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .fhe import OuterBGV

__all__ = ["build_logreg_inference"]


def build_logreg_inference(
    ctx: RingContext,
    rng: np.random.Generator,
    num_features: int = 256,
    log_t: int = 16,
) -> Protoboard:
    pb = Protoboard(ctx)

    in1 = [PBVariableArray().allocate(pb, 2, f"in1_{i}") for i in range(num_features)]
    in2 = [PBVariableArray().allocate(pb, 2, f"in2_{i}") for i in range(num_features)]
    out = PBVariableArray().allocate(pb, 5, "out")
    pb.set_input_sizes(2 * 2 * num_features + 5)

    prods_00 = PBVariableArray().allocate(pb, num_features, "p00")
    prods_01 = PBVariableArray().allocate(pb, num_features, "p01")
    prods_10 = PBVariableArray().allocate(pb, num_features, "p10")
    prods_11 = PBVariableArray().allocate(pb, num_features, "p11")

    sums = [LinearCombination(), LinearCombination(), LinearCombination()]
    for i in range(num_features):
        pb.add_r1cs_constraint(R1CSConstraint(in1[i][0], in2[i][0], prods_00[i]))
        sums[0] = sums[0] + prods_00[i]
        pb.add_r1cs_constraint(R1CSConstraint(in1[i][0], in2[i][1], prods_01[i]))
        pb.add_r1cs_constraint(R1CSConstraint(in1[i][1], in2[i][0], prods_10[i]))
        sums[1] = sums[1] + prods_01[i] + prods_10[i]
        pb.add_r1cs_constraint(R1CSConstraint(in1[i][1], in2[i][1], prods_11[i]))
        sums[2] = sums[2] + prods_11[i]

    s02 = PBVariable().allocate(pb, "s02")
    s11 = PBVariable().allocate(pb, "s11")

    pb.add_r1cs_constraint(R1CSConstraint(sums[0], sums[0], out[0]))
    pb.add_r1cs_constraint(R1CSConstraint(sums[0] * 2, sums[1], out[1]))
    pb.add_r1cs_constraint(R1CSConstraint(sums[0], sums[2], s02))
    pb.add_r1cs_constraint(R1CSConstraint(sums[1], sums[1], s11))
    pb.add_r1cs_constraint(
        R1CSConstraint(LinearCombination(1), s02 * 2 + s11, out[2])
    )
    pb.add_r1cs_constraint(R1CSConstraint(sums[1], sums[2], out[3]))
    pb.add_r1cs_constraint(R1CSConstraint(sums[2], sums[2], out[4]))

    # values: encrypted features and weights (bench_..._inference.cpp:40-62)
    fhe = OuterBGV(ctx, log_t, rng)
    zero_tail = [0] * (ctx.N - 1)
    acc = [RingElem.zero(ctx)] * 3
    for i in range(num_features):
        ct1 = fhe.encrypt([i % (1 << log_t)] + zero_tail)
        ct2 = fhe.encrypt([(2 * i + 1) % (1 << log_t)] + zero_tail)
        pb.set_val(in1[i][0], ct1[0])
        pb.set_val(in1[i][1], ct1[1])
        pb.set_val(in2[i][0], ct2[0])
        pb.set_val(in2[i][1], ct2[1])
        p00 = ct1[0] * ct2[0]
        p01 = ct1[0] * ct2[1]
        p10 = ct1[1] * ct2[0]
        p11 = ct1[1] * ct2[1]
        pb.set_val(prods_00[i], p00)
        pb.set_val(prods_01[i], p01)
        pb.set_val(prods_10[i], p10)
        pb.set_val(prods_11[i], p11)
        acc = [acc[0] + p00, acc[1] + p01 + p10, acc[2] + p11]

    pb.set_val(out[0], acc[0] * acc[0])
    pb.set_val(out[1], (acc[0] + acc[0]) * acc[1])
    v_s02 = acc[0] * acc[2]
    v_s11 = acc[1] * acc[1]
    pb.set_val(s02, v_s02)
    pb.set_val(s11, v_s11)
    pb.set_val(out[2], v_s02 + v_s02 + v_s11)
    pb.set_val(out[3], acc[1] * acc[2])
    pb.set_val(out[4], acc[2] * acc[2])
    return pb
