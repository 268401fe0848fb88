"""Verifiable BGV ciphertext-ciphertext multiplication
(benchmarks/bench_mul_SEAL.cpp:30-90); port of ``ringsnark_tpu/models/ct_mul.py``.

Proves (z0, z1, z2) = (x0, x1) * (y0, y1) over ciphertext component polys:
4 constraints over 8 wires [x0, x1, y0, y1, tmp, z0, z1, z2], with real
ciphertexts from the outer BGV scheme as values.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import PBVariableArray, Protoboard
from ..relations.r1cs import R1CSConstraint
from ..rings.context import RingContext
from .fhe import OuterBGV

__all__ = ["build_ct_mul"]


def build_ct_mul(
    ctx: RingContext, rng: np.random.Generator, log_t: int = 16
) -> Protoboard:
    pb = Protoboard(ctx)
    vars = PBVariableArray()
    vars.allocate(pb, 8, "x")
    pb.set_input_sizes(8)
    x0, x1, y0, y1, tmp, z0, z1, z2 = vars

    pb.add_r1cs_constraint(R1CSConstraint(x0, y0, z0))
    pb.add_r1cs_constraint(R1CSConstraint(x1, y0, tmp))
    pb.add_r1cs_constraint(R1CSConstraint(x0, y1, z1 - tmp))
    pb.add_r1cs_constraint(R1CSConstraint(x1, y1, z2))

    fhe = OuterBGV(ctx, log_t, rng)
    m1 = [6] + [0] * (ctx.N - 1)
    m2 = [7] + [0] * (ctx.N - 1)
    ct1 = fhe.encrypt(m1)
    ct2 = fhe.encrypt(m2)
    zz = OuterBGV.multiply(ct1, ct2)

    pb.set_val(x0, ct1[0])
    pb.set_val(x1, ct1[1])
    pb.set_val(y0, ct2[0])
    pb.set_val(y1, ct2[1])
    pb.set_val(z0, zz[0])
    pb.set_val(z1, zz[1])
    pb.set_val(z2, zz[2])
    pb.set_val(tmp, ct1[1] * ct2[0])
    return pb
