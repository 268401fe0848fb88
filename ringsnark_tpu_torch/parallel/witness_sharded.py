"""Coefficient-sharded witness map: the prover's size-M/2M NTTs over 'coeff'.

Port of ``ringsnark_tpu/parallel/witness_sharded.py``.  The witness map
(``reductions/r1cs_to_qrp._witness_map_kernel``) is interpolations
(size-M inverse NTTs) plus the size-2M product whose upper half is H; here
they run through ``ntt_sharded.make_sharded_ntt`` over the mesh's 'coeff'
dimension.  Each rank transforms its block of coefficients and the blocks
are gathered over 'coeff' (where the JAX package's GSPMD reshards
implicitly), so every rank returns the whole map.  The constraint
evaluations and every elementwise step are those of the single-device map;
the sharded transforms are bit-identical to the single-device ones, so the
map, and the proof, are too.  The batches are slot-major, ``[n, L, M]``, as
in the single-device map, and the product is its `_mulmod` (on the card
``mulmod_kernel``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import ntt as _ntt
from ..reductions.r1cs_to_qrp import WitnessTransforms, _mulmod, witness_map_kernel_chunked
from ..utils.domain import RootsDomain
from .mesh import axis_group, axis_rank, axis_size
from .ntt_sharded import make_sharded_ntt

__all__ = ["make_witness_map_sharded"]


def _gather_last(x: torch.Tensor, group, parts: int) -> torch.Tensor:
    """The blocks of the `parts` ranks of `group` (equal shapes), in group
    rank order, concatenated along the last axis."""
    x = x.contiguous()
    blocks = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(blocks, x, group=group)
    return torch.cat(blocks, dim=-1)


def _sharded_transforms(domain: RootsDomain, mesh, axis: str = "coeff") -> WitnessTransforms:
    """The witness map's transforms with the M/2M NTTs sharded over
    ``mesh[axis]``: each rank takes its coefficient block of the whole
    (replicated) input, transforms it, and the blocks are gathered."""
    ctx = domain.ctx
    M = domain.m
    D = axis_size(mesh, axis)
    assert M % D == 0 and M // D >= 2, (M, D)
    idx, group = axis_rank(mesh, axis), axis_group(mesh, axis)
    plan2 = _ntt.get_plan(ctx.primes, 2 * M)
    intt_M = make_sharded_ntt(domain.plan, mesh, axis, negacyclic=False, inverse=True)
    fwd_2M = make_sharded_ntt(plan2, mesh, axis, negacyclic=False, inverse=False)
    inv_2M = make_sharded_ntt(plan2, mesh, axis, negacyclic=False, inverse=True)

    def interp(_domain, evals):
        """[n, L, M] domain-order evaluations -> [n, L, M] coefficients."""
        x = evals[..., idx * (M // D):(idx + 1) * (M // D)]  # [n, L, Mc]
        return _gather_last(intt_M(x.contiguous()), group, D)

    def h_main(_ctx, aA, aB, _M):
        """The upper half of coeffs(A*B), [n, L, M]: the size-2M product of
        the zero-padded [n, L, M] coefficient batches, this rank's block of
        2M/D."""
        w = 2 * M // D
        lo, hi = idx * w, min((idx + 1) * w, M)  # the coefficients in the block

        def fwd2(a):
            x = torch.zeros((a.shape[0], ctx.L, w), dtype=torch.int32, device=a.device)
            if hi > lo:
                x[..., :hi - lo] = a[..., lo:hi]
            return fwd_2M(x)

        x = fwd2(aA)
        prod = inv_2M(_mulmod(ctx, x, fwd2(aB), out=x))
        return _gather_last(prod, group, D)[..., M:]

    return WitnessTransforms(interp, h_main)


def make_witness_map_sharded(comp, domain: RootsDomain, mesh, axis: str = "coeff"):
    """witness_map(z_full, z_io, z_mid) -> (a_io, b_io, c_io, a_mid, b_mid,
    c_mid, Z, H), the non-ZK map (d1 = d2 = d3 = 0, as the ringGroth16
    prover, `groth16.tcc:76-84`) with its M/2M transforms sharded over
    ``mesh[axis]``, in slot chunks as ``witness_map_kernel_chunked``.  Every
    rank of the mesh calls it with the whole assignment batches and gets the
    whole map.  (C of the full assignment reaches no output and is not
    interpolated.)"""
    tf = _sharded_transforms(domain, mesh, axis)
    zero = torch.zeros((comp.ctx.L, 1), dtype=torch.int32, device=comp.ctx.device)

    def witness_map(z_full, z_io, z_mid):
        return witness_map_kernel_chunked(comp, z_full, z_io, z_mid, zero, zero, zero, domain,
                                          outputs="all", tf=tf)

    return witness_map
