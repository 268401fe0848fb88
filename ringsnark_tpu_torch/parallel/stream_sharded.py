"""Data-sharded streamed-prover chunk: encrypt and MAC one chunk's rows over 'data'.

Port of ``ringsnark_tpu/parallel/stream_sharded.py``.  The streamed
provers (``snark/streamed.py``) walk the CRS in chunks; this is one chunk
with its rows split over the D ranks of the mesh's 'data' dimension.  Rank
d encrypts rows [d * local, (d + 1) * local) slab by slab, slab i under
``fold_in(key, d * ns_local + i)`` (the slab is the PRNG's unit, so these
are exactly the slabs of the unsharded ``encode_seeded``), multiplies them
into the exact int64 sums as ``streamed._encode_mac`` does on one device
(its c1 used as drawn), and the sums are ``all_reduce``d over 'data'.  They
are exact and order-independent, so the result, reduced mod Q_j, is
bit-identical to the single-device chunk.  One [L, L', N'] int64 pair per
plaintext batch crosses the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..encoding.context import EncodingContext, SecretKey
from ..encoding.encoding import finish_inner_product
from ..snark.streamed import StreamRecord, _encode_mac
from .mesh import axis_group, axis_rank, axis_size

__all__ = ["stream_chunk_ip_sharded"]


def stream_chunk_ip_sharded(mesh, ectx: EncodingContext, sk: SecretKey, rows, pts: list, key,
                            slab: int) -> list:
    """Encode-and-MAC one streamed chunk with its rows split over 'data'.

    rows: [chunk, L, n] CRS ring rows (slots; chunk % (D * slab) == 0);
    pts: [chunk, L, n] plaintext batches; key: the chunk's threefry key.
    Every rank of the 'data' group calls it with the whole chunk and gets
    the level-0 partial-sum Encodings, equal bit for bit to
    ``seeded.seeded_inner_product(encode_seeded(ectx, sk, rows, key, slab),
    pts, use_modswitch=False)``."""
    D = axis_size(mesh, "data")
    d = axis_rank(mesh, "data")
    chunk = rows.shape[0]
    assert chunk % (D * slab) == 0, (chunk, D, slab)
    local = chunk // D
    own = slice(d * local, (d + 1) * local)
    rows_loc = rows[own]
    acc_shape = (ectx.L, ectx.L_inner, ectx.n_inner)
    accs = [tuple(torch.zeros(acc_shape, dtype=torch.int64, device=rows.device)
                  for _ in range(2)) for _ in pts]
    _encode_mac(ectx, sk, lambda a, b: rows_loc[a:b], local, [pt[own] for pt in pts], 0, key,
                slab, accs, StreamRecord(sync=False), "sharded", slab0=d * (local // slab))
    group = axis_group(mesh, "data")
    for a in accs:
        for part in a:
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
    return [finish_inner_product(ectx, a, 0, use_modswitch=False) for a in accs]
