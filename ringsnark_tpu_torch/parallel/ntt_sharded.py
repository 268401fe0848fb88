"""Coefficient-sharded (neg)acyclic NTT over a mesh dimension.

Port of ``ringsnark_tpu/parallel/ntt_sharded.py``.  The transform's last
axis is block-sharded over the D ranks of a mesh dimension (Mc = M/D
contiguous coefficients a rank).  With DIF stage s pairing elements at
distance d = M >> (s+1), the stages with d >= Mc are block exchanges with
the partner rank (group rank XOR d/Mc), and every later stage lies inside a
block with the twiddles of a size-Mc transform, so the rest is the
single-device transform at size Mc.  The inverse (DIT) mirrors it: the
local size-Mc inverse unscaled, then log2(D) exchange stages, then the
global M^-1 or psi^-1 M^-1 scale on the rank's slice.

The exchange stages are elementwise torch (``ops/modops.py``) on the
twiddle slice at offset (idx * Mc) mod d, and the exchange is one
``batch_isend_irecv`` pair with the partner; the local transforms go
through ``ops.ntt``'s dispatch, so on the card they are the Hopper kernels
and on the CPU the plain twins.  Orders match ``ops/ntt.py`` (natural in,
bit-reversed out; bit-reversed in, natural out) block by block: the blocks
in rank order are the single-device result, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from ..ops.modops import add_mod, mul_mod, sub_mod
from ..ops.ntt import NTTPlan, cyclic_intt_nat, cyclic_ntt_rev, get_plan
from .mesh import axis_group, axis_rank, axis_size

__all__ = ["make_sharded_ntt", "sharded_ntt"]


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to global rank `peer` of `group` and receive its block."""
    x = x.contiguous()
    other = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer, group),
                                   dist.P2POp(dist.irecv, other, peer, group)])
    for r in reqs:
        r.wait()
    return other


@dataclass(frozen=True)
class _RankTables:
    p: torch.Tensor  # [L, 1] int64
    tw: tuple  # per exchange stage, in execution order: [L, Mc] int64
    psi: torch.Tensor | None  # [L, Mc] the forward twist on the rank's slice
    scale: torch.Tensor  # [L, Mc] psi^-1 M^-1, or [L, 1] M^-1 (inverse)


@lru_cache(maxsize=None)
def _rank_tables(primes: tuple, M: int, D: int, idx: int, negacyclic: bool, inverse: bool,
                 device: str) -> _RankTables:
    plan = get_plan(primes, M, negacyclic)
    Mc = M // D
    k = D.bit_length() - 1
    logM = M.bit_length() - 1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64), device=device)

    def tw_slice(tw, d):  # the rank's [L, Mc] slice of a stage table [L, d]
        off = (idx * Mc) % d
        return t(tw[:, off:off + Mc])

    if inverse:
        tws = tuple(tw_slice(plan.inv_tw[s], 1 << s) for s in range(logM - k, logM))
    else:
        tws = tuple(tw_slice(plan.fwd_tw[s], M >> (s + 1)) for s in range(k))
    own = slice(idx * Mc, (idx + 1) * Mc)
    return _RankTables(
        p=t(plan.p), tw=tws,
        psi=t(plan.psi[:, own]) if negacyclic and not inverse else None,
        scale=t(plan.psi_inv_scaled[:, own]) if negacyclic else t(plan.minv))


def make_sharded_ntt(plan: NTTPlan, mesh, axis: str = "coeff", negacyclic: bool = True,
                     inverse: bool = False):
    """The transform of `plan` as a function of this rank's block
    ``[..., L, M/D]`` of data whose last axis is split over ``mesh[axis]``
    (D ranks); it returns the rank's block of the result.  Every rank of the
    axis group calls it together.  Batch axes may be split over other mesh
    dimensions: each rank transforms the rows it holds."""
    D = axis_size(mesh, axis)
    M = plan.M
    assert M % D == 0 and M // D >= 2, (D, M)
    if negacyclic:
        assert plan.negacyclic, "plan built without negacyclic=True"
    Mc = M // D
    local_plan = get_plan(plan.primes, Mc, negacyclic=False)
    idx = axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    k = D.bit_length() - 1
    # partner distance in ranks of each exchange stage, in execution order
    dists = [D >> (s + 1) for s in range(k)]
    if inverse:
        dists = dists[::-1]
    peers = [dist.get_global_rank(group, idx ^ pd) for pd in dists]

    def call(x: torch.Tensor) -> torch.Tensor:
        assert tuple(x.shape[-2:]) == (plan.L, Mc), (tuple(x.shape), plan.L, Mc)
        tb = _rank_tables(plan.primes, M, D, idx, negacyclic, inverse, str(x.device))
        p = tb.p
        if inverse:
            x = cyclic_intt_nat(x, local_plan, scale=False)
        elif negacyclic:
            x = mul_mod(x, tb.psi, p)
        for pd, peer, tw in zip(dists, peers, tb.tw):
            other = _exchange(x, peer, group)
            hi = (idx // pd) % 2 == 1
            if inverse:
                # lo: a + b*tw (b received); hi: a - b*tw (a received)
                x = (sub_mod(other, mul_mod(x, tw, p), p) if hi
                     else add_mod(x, mul_mod(other, tw, p), p))
            else:
                # lo: a + b; hi: (a - b) * tw (a received)
                x = (mul_mod(sub_mod(other, x, p), tw, p) if hi
                     else add_mod(x, other, p))
        if inverse:
            return mul_mod(x, tb.scale, p)
        return cyclic_ntt_rev(x, local_plan)

    return call


def sharded_ntt(x, plan: NTTPlan, mesh, axis: str = "coeff", negacyclic: bool = True,
                inverse: bool = False):
    """One-shot convenience wrapper around :func:`make_sharded_ntt`."""
    return make_sharded_ntt(plan, mesh, axis, negacyclic, inverse)(x)
