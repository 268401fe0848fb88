"""numpy replay of `ringsnark_tpu_torch/csrc/witness.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrapper's own geometry (`cuda_witness.tile`, `moduli`) and
the launcher's plan:

* `spmv`: the CTAs over (limb, row tile, slot tile), each thread's four
  outputs slot fastest in the tile; a row's first term from the CSR's
  row-indexed head (an empty row's is zero), then its nonzeros [ptr[r] + 1,
  ptr[r + 1]) (row r is nonzero r alone where the CSR is `unit`), skipped
  where the row is longer than seg_len (the merge writes it), or a
  segment's range into the scratch; the coefficients read at their own
  strides; every term z * c mod p with c's Shoup constant made from mu's
  halves (`mac_replay.shoup_of`, `mac_replay.mul_mod`, whose asserts check
  the kernel's 32-bit wraps), summed with add_mod (checked below 2^32); the assignment word from
  the last block starting at or below the column, at its strides; the
  slot-major store through the shared tile (written [slot][row], row pitch
  TR + 1, read row fastest), every output written once; then the merge of
  the long rows' segments.
* `mulmod`: the launcher's choice of four words a thread or one, each
  word of b given its Shoup constant from mu's halves (`mac_replay.shoup_of`)
  and reduced by `mac_replay.mul_mod`, c added with add_mod.

`lib()` gives an object with the library's two C functions over host
memory (the tensors' pointers read with `np.ctypeslib`), so the wrappers and
every prover run through it on the CPU.
"""

import ctypes

import numpy as np

import mac_replay
from ringsnark_tpu_torch.ops import cuda_witness

TILE = cuda_witness.TILE  # kTile: outputs a CTA, four a thread


def term(z, w, p, mu):
    """`term`: z * w mod p with w's Shoup constant from mu's halves
    (`mac_replay.shoup_of`, `mac_replay.mul_mod`: z < 2^31, w < p)."""
    return mac_replay.mul_mod(z, w, mac_replay.shoup_of(w, mu), p)


def add_mod(a, b, p):
    s = a + b
    assert (a < p).all() and (b < p).all() and (s < np.uint64(1 << 32)).all()
    return np.where(s >= p, s - p, s)


def tile(n: int) -> tuple:
    """(log2 TS, TR): the launcher's tile for n output slots (the wrapper's
    `cuda_witness.tile`)."""
    ts, tr = cuda_witness.tile(n)
    return ts.bit_length() - 1, tr


def _words(ptr: int, count: int, ctype=ctypes.c_uint32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


def _gather(ptr: int, offsets: np.ndarray) -> np.ndarray:
    """The uint32 words at `offsets` (words) from `ptr`."""
    if not offsets.size:
        return np.zeros(0, np.uint64)
    assert offsets.min() >= 0
    return _words(ptr, int(offsets.max()) + 1)[offsets].astype(np.uint64)


def z_words(blocks, c, l, i):
    """`z_word`: the assignment's words (c, l, i) (arrays), each read from
    the last block that starts at or below its row."""
    out = np.zeros(c.shape, np.uint64)
    which = np.zeros(c.shape, np.int64)
    for b, blk in enumerate(blocks[1:], 1):
        which = np.where(c >= blk[1], b, which)
    for b, (ptr, start, row, limb, slot) in enumerate(blocks):
        m = which == b
        off = (c[m] - start) * row + l[m] * limb + i[m] * slot
        out[m] = _gather(ptr, off)
    return out


def spmv_tiles(rows, n, L):
    """The CTAs of a launch over `rows` output rows: (limb, r0, i0) in
    blockIdx order, and the tile's (log2 TS, TR)."""
    log_ts, tr = tile(n)
    slot_tiles, row_tiles = -(-n // (1 << log_ts)), -(-rows // tr)
    ctas = [(b // slot_tiles // row_tiles, (b // slot_tiles) % row_tiles * tr,
             b % slot_tiles << log_ts) for b in range(L * row_tiles * slot_tiles)]
    return ctas, log_ts, tr


def spmv_launch(bounds, idx, head, coef, blocks, primes, mu, csr_rows, rows, n, L, seg_len,
                unit: bool, kseg: bool, slot_major: bool, out: np.ndarray):
    """One launch of spmv_kernel<slot_major, kseg> into `out` (a flat uint64
    array of the output's words).  bounds: ptr [csr_rows + 1] (None where
    `unit`: row r is nonzero r), or the segments [S, 2]; a row's first term
    from its `head` and the coefficient at its first nonzero (the segments
    have none); coef: [nnz, L, the window's slots or 1].  Returns how many
    times each output word was written."""
    ctas, log_ts, tr = spmv_tiles(rows, n, L)
    written = np.zeros(out.shape, np.int64)
    e = np.arange(TILE)  # thread t's outputs j: e = t + 256 j
    wide = coef.shape[2] > 1
    for l, r0, i0 in ctas:
        p = np.uint64(primes[l])
        r, i = r0 + (e >> log_ts), i0 + (e & ((1 << log_ts) - 1))
        live = (r < csr_rows) & (i < n)
        rr = np.where(live, r, 0)
        acc = np.zeros(TILE, np.uint64)
        if not csr_rows:
            k0 = k1 = np.zeros(TILE, np.int64)
        elif kseg:
            k0, k1 = np.where(live, bounds[rr, 0], 0), np.where(live, bounds[rr, 1], 0)
        else:  # the head's term (zero for an empty row), then the row past it
            k0 = np.where(live, rr if unit else bounds[rr], 0)
            k1 = np.where(live, rr + 1 if unit else bounds[np.minimum(rr + 1, csr_rows)], 0)
            m = live & (k1 > k0)
            zw = z_words(blocks, head[rr[m]].astype(np.int64), np.full(m.sum(), l), i[m])
            acc[m] = term(zw, coef[k0[m], l, i[m] if wide else 0], np.uint64(p), mu[l])
            k1 = np.where(k1 - k0 > seg_len, k0, k1)  # the merge writes a long row
            k0 = k0 + 1
        for step in range(int(np.maximum(k1 - k0, 0).max(initial=0))):  # the rest, together
            m = k0 + step < k1
            k = (k0 + step)[m]
            zw = z_words(blocks, idx[k].astype(np.int64), np.full(k.shape, l), i[m])
            acc[m] = add_mod(acc[m], term(zw, coef[k, l, i[m] if wide else 0], p, mu[l]), p)
        if slot_major:
            smem = np.zeros((1 << log_ts) * (tr + 1), np.uint64)
            smem[(e & ((1 << log_ts) - 1)) * (tr + 1) + (e >> log_ts)] = acc
            lr, li = e & (tr - 1), e // tr
            rs, is_ = r0 + lr, i0 + li
            ok = (rs < rows) & (is_ < n)
            dst = (is_[ok] * L + l) * rows + rs[ok]
            out[dst] = smem[li[ok] * (tr + 1) + lr[ok]]
        else:
            ok = (r < rows) & (i < n)
            dst = (r[ok] * L + l) * n + i[ok]
            out[dst] = acc[ok]
        np.add.at(written, dst, 1)
    return written


def merge(seg_of, rows_of, scratch, primes, L, n, rows, slot_major, out):
    """spmv_merge_kernel: long row j adds its segments' partial sums."""
    for j, r in enumerate(rows_of):
        for l in range(L):
            p = np.uint64(primes[l])
            acc = np.zeros(n, np.uint64)
            for g in range(seg_of[j], seg_of[j + 1]):
                acc = add_mod(acc, scratch[(g * L + l) * n:(g * L + l) * n + n], p)
            i = np.arange(n)
            out[(i * L + l) * rows + r if slot_major else (r * L + l) * n + i] = acc


def mulmod(a, b, c, q, mu, vec: bool):
    """mulmod_kernel over [R, L, K] uint64 arrays (b broadcast to a's shape):
    the launcher's four-word or one-word threads give the same words; each
    of b's words gets its Shoup constant once a word (a thread's four share
    one where b is constant along the slots)."""
    R, L, K = a.shape
    y = np.empty_like(a)
    for l in range(L):
        w = b[:, l]
        w_sh = mac_replay.shoup_of(w, mu[l])
        t = mac_replay.mul_mod(a[:, l].ravel(), w.ravel(), w_sh.ravel(), q[l]).reshape(R, K)
        y[:, l] = t if c is None else add_mod(t, c[:, l], q[l])
    return y


def _view(ptr: int, shape, strides) -> np.ndarray:
    """A [R, L, K] uint32 view of host memory at word strides (0 allowed)."""
    span = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    base = _words(ptr, span)
    return np.lib.stride_tricks.as_strided(base, shape=shape,
                                           strides=tuple(4 * st for st in strides))


class _Lib:
    """`ringsnark_spmv` and `ringsnark_mulmod` over host memory."""

    def __init__(self):
        self.calls = []

    def ringsnark_spmv(self, ptr, idx, head, coef, coef_strides, coef_lo, zptrs, zmeta, nblocks,
                       primes, mu, L, csr_rows, rows, n, slot_major, unit, seg_len, seg, seg_of,
                       rows_of, nseg, nlong, scratch, out, stream):
        assert 1 <= nblocks <= 3 and n >= 1 and rows >= csr_rows >= 0
        primes = _words(primes, L).astype(np.uint64)
        mu = _words(mu, L, ctypes.c_uint64)
        assert all(2 <= int(p) < 1 << 31 and int(m) == (1 << 64) // int(p)
                   for p, m in zip(primes, mu))
        zp = _words(zptrs, nblocks, ctypes.c_uint64)
        zm = _words(zmeta, 4 * nblocks, ctypes.c_int64).reshape(nblocks, 4)
        assert zm[0, 0] == 0 and (np.diff(zm[:, 0]) >= 0).all()
        blocks = [(int(zp[b]), *map(int, zm[b])) for b in range(nblocks)]
        bounds = None if unit else _words(ptr, csr_rows + 1, ctypes.c_int32).astype(np.int64)
        nnz = csr_rows if unit else int(bounds[-1])
        ix = _words(idx, nnz, ctypes.c_int64) if nnz else np.zeros(0, np.int64)
        hd = ix if unit else (_words(head, csr_rows, ctypes.c_int64) if csr_rows
                              else np.zeros(0, np.int64))
        ck, cl, ci = (int(x) for x in _words(coef_strides, 3, ctypes.c_int64))
        assert ci in (0, 1)
        width = n if ci else 1  # the coefficients' slots a call reads, from coef_lo
        cw = (_view(coef + 4 * coef_lo * ci, (nnz, L, width), (ck, cl, ci)).astype(np.uint64)
              if nnz else np.zeros((0, L, width), np.uint64))
        o = np.zeros(rows * L * n, np.uint64)
        if nlong:
            assert not unit
            sg = _words(seg, 2 * nseg, ctypes.c_int32).reshape(nseg, 2).astype(np.int64)
            sc = np.zeros(nseg * L * n, np.uint64)
            spmv_launch(sg, ix, None, cw, blocks, primes, mu, nseg, nseg, n, L, seg_len, False,
                        True, False, sc)
        written = spmv_launch(bounds, ix, hd, cw, blocks, primes, mu, csr_rows, rows, n, L,
                              seg_len, bool(unit), False, bool(slot_major), o)
        assert (written == 1).all(), "every output word written once"
        if nlong:
            so = _words(seg_of, nlong + 1, ctypes.c_int32)
            ro = _words(rows_of, nlong, ctypes.c_int32)
            merge(so, ro, sc, primes, L, n, rows, bool(slot_major), o)
        _words(out, rows * L * n)[:] = o.astype(np.uint32)
        self.calls.append(("spmv", csr_rows, rows, n, bool(slot_major), nlong, bool(unit)))
        return 0

    def ringsnark_mulmod(self, y, a, b, c, R, L, K, strides, primes, mu, stream):
        st = _words(strides, 9, ctypes.c_int64).astype(np.int64)
        assert st[4] in (0, 1)
        q = _words(primes, L).astype(np.uint64)
        m = _words(mu, L, ctypes.c_uint64)
        assert all(int(x) == (1 << 64) // int(p) for p, x in zip(q, m))
        shape = (R, L, K)
        av = _view(a, shape, (st[0], st[1], 1)).astype(np.uint64)
        bv = _view(b, shape, (st[2], st[3], st[4])).astype(np.uint64)
        cv = None if not c else _view(c, shape, (st[5], st[6], 1)).astype(np.uint64)
        vec = K % 4 == 0 and all(st[k] % 4 == 0 for k in (0, 1, 5, 6, 7, 8)) and (
            st[4] == 0 or (st[2] % 4 == 0 and st[3] % 4 == 0 and b % 16 == 0)) and \
            all(x % 16 == 0 for x in (y, a, c or 0))
        out = mulmod(av, bv, cv, q, m, vec)
        yv = _view(y, shape, (st[7], st[8], 1))
        yv[...] = out.astype(np.uint32)
        self.calls.append(("mulmod", R, L, K, vec, c is not None))
        return 0


def lib() -> _Lib:
    return _Lib()
