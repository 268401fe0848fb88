"""The prover's multiply-accumulate: ``acc_k += sum_r (c[r] * pt_k[r] mod Q_j)``
over one row sub-chunk, for c = c0 and c1, in exact int64.

Every inner product of the provers goes through `mac_rows`
(``encoding.mac_accumulate``: the resident provers and their sharded and
frontend callers; ``seeded._mac_accs``; ``streamed._encode_mac``): the
counterpart of the JAX package's MAC (``ringsnark_tpu/snark/seeded.py``
`_seeded_mac_kernel`, `_mac_accs_u64`; ``encoding/encoding.py``
`inner_product`).  Each product is reduced mod Q_j before the int64 sum
(a term is < 2^31 and a batch has < 2^32 rows), so any partition of the
rows, and any order, gives the same bits: the sums are what
``parallel/sharded.py`` and ``stream_sharded.py`` add across ranks.

The dispatch is by the tensors' device: CUDA tensors go to the kernels of
``ops/cuda_mac.py`` (``mac``, or ``mac_drawn`` where c1 is `Drawn`) or the
call raises; any other device runs `mac_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from ..ops import cuda_mac
from ..utils import prng
from . import bgv
from .context import EncodingContext

__all__ = ["Drawn", "mac_rows", "mac_plain"]

_I64 = torch.int64


@dataclass(frozen=True)
class Drawn:
    """c1 of a seeded batch, never stored: rows `rows` of the uniform mask
    ``bgv._sample_uniform(ctx, key, batch_shape)`` (a fresh encryption's, so
    a MAC over it runs at level 0)."""

    key: prng.Key
    batch_shape: tuple
    rows: tuple


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def mac_rows(ctx: EncodingContext, level: int, c0: torch.Tensor, c1, pts, accs):
    """Add ``sum_r (c[r] * pt_k[r] mod Q_j)`` for c = c0, c1 into ``accs[k]``
    (int64 ``[L, L'_lvl, N']`` pairs) in place, at `level`.  c0: int32 ``[n,
    L, L'_lvl, N']``; c1: the same, or `Drawn`; `pts`: inner-NTT operands
    ``[n_k, L, L'_lvl, N']`` (``bgv.plain_to_inner_ntt``; a Z_q operand is
    broadcast over N'), 1 <= n_k <= n: rows past n_k pair with zero."""
    if _on_card(c0):
        if isinstance(c1, Drawn):
            cuda_mac.mac_drawn(ctx, level, c0, c1, pts, accs)
        else:
            cuda_mac.mac(ctx, level, c0, c1, pts, accs)
        return
    mac_plain(ctx, level, c0, c1, pts, accs)


def mac_plain(ctx: EncodingContext, level: int, c0: torch.Tensor, c1, pts, accs):
    """`mac_rows` as int64 torch ops on any device (the kernels' plain
    version): each product reduced by ``torch.remainder``, then summed."""
    if isinstance(c1, Drawn):
        if level:
            raise ValueError("mac_plain: a drawn c1 is a fresh encryption's, at level 0")
        c1 = bgv._uniform_plain(ctx, c1.key, c1.batch_shape, c1.rows)
    Q = ctx.inner_consts(level)
    for pt, (a0, a1) in zip(pts, accs):
        n = pt.shape[0]
        pt = pt.to(_I64)
        a0 += torch.remainder(c0[:n].to(_I64) * pt, Q).sum(0)
        a1 += torch.remainder(c1[:n].to(_I64) * pt, Q).sum(0)
