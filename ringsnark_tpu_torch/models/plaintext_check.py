"""vFHE plaintext check: slotwise bit-decomposition circuit (port of
``ringsnark_tpu/models/plaintext_check.py``).

Mirrors `examples/example_plaintext_check_SEAL.cpp:47-54` /
`benchmarks/bench_plaintext_check_SEAL.cpp`: logT booleanity constraints
b_i(1-b_i)=0 plus the recomposition x = sum 2^i b_i; the plaintext is public,
its bits are private wires.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import BitDecompositionGadget, PBVariable, Protoboard
from ..rings.context import RingContext
from ..rings.elem import RingElem

__all__ = ["build_plaintext_check"]


def build_plaintext_check(
    ctx: RingContext, rng: np.random.Generator, log_t: int = 16
) -> Protoboard:
    pb = Protoboard(ctx)
    x = PBVariable().allocate(pb, "x")
    pb.set_input_sizes(1)
    g = BitDecompositionGadget(pb, x, log_t)
    g.generate_r1cs_constraints()

    # plaintext slot values < 2^logT, equal across limbs
    slots = rng.integers(0, 1 << log_t, size=ctx.N, dtype=np.uint64)
    arr = np.broadcast_to(slots.astype(np.uint32), (ctx.L, ctx.N)).copy()
    pb.set_val(x, RingElem.from_slots(ctx, arr))
    g.generate_r1cs_witness()
    return pb
