"""Synthetic large-scale R1CS instances built directly as arrays.

Port of ``ringsnark_tpu/models/synthetic.py``: the squaring chain
x_{i+1} * x_{i+1} = x_{i+2}, whose num_variables = M + 1 keeps the groth16
CRS at ~3(M+1) encodings, and the chain of independent multiplication gates
x_{3i} * x_{3i+1} = x_{3i+2}.  The same numpy draws as the JAX package, so
one seed gives one circuit in both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.modops import mul_mod
from ..relations.r1cs import CompiledR1CS
from ..rings.context import RingContext
from ..rings.elem import RingElem

__all__ = ["build_synthetic_mul_chain", "build_synthetic_square_chain"]

# Assignments larger than this are computed on the device, in row chunks of
# about this many bytes.
_HOST_BYTES = 64 << 20


def build_synthetic_mul_chain(
    ctx: RingContext,
    num_constraints: int,
    rng: np.random.Generator,
    num_public_gates: int = 1,
):
    """Returns (compiled_r1cs, primary RingElem batch, auxiliary RingElem batch).

    Variables (1-based): gate i uses a_i = x_{3i+1}, b_i = x_{3i+2},
    c_i = x_{3i+3}.  Primary variables must be an index prefix, so public
    gates come first and all their wires are public.
    """
    m = num_constraints
    nv = 3 * m
    rows = torch.arange(m, dtype=torch.int64, device=ctx.device)
    ones = torch.ones((m, ctx.L, 1), dtype=torch.int32, device=ctx.device)

    # assignment: random a, b; c = a*b  (slot-form arrays [m, L, n])
    n = ctx.N
    a_vals, b_vals = (
        ctx.tensor(np.stack(
            [rng.integers(0, p, (m, n), dtype=np.uint64) for p in ctx.primes], axis=1
        ))
        for _ in range(2)
    )
    # interleave into the variable order x_1..x_{3m}
    assign = torch.stack([a_vals, b_vals, mul_mod(a_vals, b_vals, ctx.p)], dim=1)
    assign = assign.reshape(nv, ctx.L, n)

    primary_size = 3 * num_public_gates
    comp = CompiledR1CS(
        ctx=ctx,
        num_constraints=m,
        num_variables=nv,
        primary_input_size=primary_size,
        rows=(rows, rows, rows),
        cols=(3 * rows + 1, 3 * rows + 2, 3 * rows + 3),
        coeffs=(ones, ones, ones),
    )
    return comp, RingElem(ctx, assign[:primary_size]), RingElem(ctx, assign[primary_size:])


def _device_square_chain(ctx: RingContext, x0: np.ndarray, nv: int) -> torch.Tensor:
    """[nv, L, n] squaring-chain assignment computed on ``ctx.device``.

    Row i is x0^(2^i) slot-wise: exponents are reduced mod (p-1) on the host
    (Fermat) and applied as a masked product over the squared bases
    x0^(2^b).  Exact for a zero slot only when the reduced exponent is never
    0, i.e. when p-1 is not a power of two (asserted).
    """
    for q in ctx.primes:
        assert (q - 1) & (q - 2), (
            f"limb {q}: q-1 is a power of two (Fermat prime); the reduced "
            "exponent 2^i mod (q-1) can hit 0 and break zero slots"
        )
    L, n = x0.shape
    exps = np.zeros((nv, L), dtype=np.int64)
    for l, q in enumerate(ctx.primes):
        e = 1
        for i in range(nv):
            exps[i, l] = e
            e = (e * 2) % (q - 1)
    nbits = max(int(q).bit_length() for q in ctx.primes)

    bases = [ctx.tensor(x0)]  # x0^(2^b): [L, n] each
    for _ in range(1, nbits):
        bases.append(mul_mod(bases[-1], bases[-1], ctx.p))
    exps_t = torch.from_numpy(exps).to(ctx.device)

    out = torch.empty((nv, L, n), dtype=torch.int32, device=ctx.device)
    rows = max(1, min(nv, _HOST_BYTES // max(1, L * n * 4)))
    for lo in range(0, nv, rows):
        e = exps_t[lo:lo + rows, :, None]  # [r, L, 1]
        acc = None
        for b in range(nbits):
            term = torch.where(((e >> b) & 1).bool(), bases[b], 1)
            acc = term.to(torch.int32) if acc is None else mul_mod(acc, term, ctx.p)
        out[lo:lo + rows] = acc
    return out


def build_synthetic_square_chain(
    ctx: RingContext,
    num_constraints: int,
    rng: np.random.Generator,
    num_public: int = 1,
):
    """Returns (compiled_r1cs, primary, auxiliary) for the squaring chain
    x_{i+1} * x_{i+1} = x_{i+2} (constraint i, 0-based; variables 1-based)."""
    m = num_constraints
    nv = m + 1
    rows = torch.arange(m, dtype=torch.int64, device=ctx.device)
    cols_a = rows + 1
    cols_c = rows + 2
    ones = torch.ones((m, ctx.L, 1), dtype=torch.int32, device=ctx.device)

    n = ctx.N
    x0 = np.stack(
        [rng.integers(0, p, n, dtype=np.uint64) for p in ctx.primes]
    ).astype(np.uint32)
    if nv * ctx.L * n * 4 > _HOST_BYTES:
        assign = _device_square_chain(ctx, x0, nv)
    else:
        host = np.empty((nv, ctx.L, n), dtype=np.uint32)
        host[0] = x0
        primes = np.asarray(ctx.primes, dtype=np.uint64).reshape(ctx.L, 1)
        x = x0.astype(np.uint64)
        for i in range(1, nv):
            x = (x * x) % primes
            host[i] = x.astype(np.uint32)
        assign = ctx.tensor(host)
    comp = CompiledR1CS(
        ctx=ctx,
        num_constraints=m,
        num_variables=nv,
        primary_input_size=num_public,
        rows=(rows, rows, rows),
        cols=(cols_a, cols_a, cols_c),
        coeffs=(ones, ones, ones),
    )
    primary = RingElem(ctx, assign[:num_public])
    auxiliary = RingElem(ctx, assign[num_public:])
    return comp, primary, auxiliary
