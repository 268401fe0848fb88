"""In-circuit NTT check (benchmarks/bench_ntt_SEAL.cpp:39-77); port of
``ringsnark_tpu/models/incircuit_ntt.py``.

One constraint over N+1 wires asserting that X_hat is the NTT of the scalar
wires x_0..x_{N-1}: sum_i c_i * x_i = X_hat, where c_i is the ring constant
whose slot j equals pt_j^i (pt_j = the negacyclic evaluation point of slot j,
psi * omega^bitrev(j)).  By our slot semantics sum_i x_i pt_j^i is exactly
slot j of `RingElem.from_coeffs(x)`, so the circuit is satisfied by
construction — the same structure the reference builds from SEAL root powers.

The one constraint is built by N - 1 merges of a growing linear combination
with dense coefficients: O(N^2) Python steps and N - 1 small multiplies on
the device.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import PBVariableArray, Protoboard
from ..relations.r1cs import R1CSConstraint
from ..relations.variable import LinearCombination
from ..rings.context import RingContext
from ..rings.elem import RingElem

__all__ = ["build_incircuit_ntt", "negacyclic_eval_points"]


def negacyclic_eval_points(ctx: RingContext) -> np.ndarray:
    """[L, N] uint32: slot j's evaluation point psi * omega^bitrev(j)."""
    plan = ctx.ntt_plan
    psi1 = np.asarray(plan.psi)[:, 1].astype(np.uint64)  # psi^1
    pts = plan.eval_points_np.astype(np.uint64)  # omega^bitrev(j)
    p = np.array(ctx.primes, dtype=np.uint64)[:, None]
    return ((pts * psi1[:, None]) % p).astype(np.uint32)


def build_incircuit_ntt(ctx: RingContext, rng: np.random.Generator) -> Protoboard:
    N = ctx.N
    pb = Protoboard(ctx)
    vars = PBVariableArray()
    vars.allocate(pb, N + 1, "x")
    pb.set_input_sizes(N + 1)

    rs = RingElem.from_slots(ctx, negacyclic_eval_points(ctx))
    row = rs
    lc = LinearCombination(vars[0])
    for i in range(1, N):
        lc = lc + vars[i] * row
        row = row * rs
    pb.add_r1cs_constraint(R1CSConstraint(lc, 1, vars[N]))

    # witness: random small coefficients, X_hat = NTT(x)
    coeffs = rng.integers(0, 1 << 16, size=N, dtype=np.uint64)
    for i in range(N):
        pb.set_val(vars[i], RingElem.scalar(ctx, int(coeffs[i])))
    xhat = RingElem.from_int_coeffs(ctx, [int(c) for c in coeffs])
    pb.set_val(vars[N], xhat)
    return pb
