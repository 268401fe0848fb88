"""numpy replay of `ringsnark_tpu_torch/csrc/mac.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrapper's own launch plan (`cuda_mac.plan`) and Barrett
constants (`cuda_mac.barrett`): the column groups of VEC columns that the
grid's threads take, each checked to be taken once; the rows of each
split; every term as the 64-bit product reduced by the multiply-high with
mu_j = floor(2^64 / Q_j) (the high word formed from 32-bit halves, as
`__umul64hi` is) and one conditional subtract in 32 bits; the partial sums
of a split added to the accumulators as the atomics do; the drawn c1 from
`prng_replay.draw_value` at the kernel's counters.

`lib()` gives an object with the library's two C functions over host
memory (the tensors' pointers read with `np.ctypeslib`), so the wrapper and
every prover run through it on the CPU.
"""

import ctypes

import numpy as np

import prng_replay

MASK = np.uint64(0xFFFFFFFF)
THREADS, VEC, MAX_OPS = 256, 4, 4  # kThreads, kVec, kMaxOps in csrc/mac.cu


def umul64hi(x, mu):
    """The high 64 bits of x * mu (uint64 arrays), from 32-bit halves."""
    xh, xl = x >> np.uint64(32), x & MASK
    mh, ml = mu >> np.uint64(32), mu & MASK
    lh, hl = xl * mh, xh * ml
    mid = ((xl * ml) >> np.uint64(32)) + (lh & MASK) + (hl & MASK)
    return xh * mh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (mid >> np.uint64(32))


def mul_mod_exact(a, b, q, mu):
    """`mul_mod_exact`: a * b mod q for words a, b < 2^32 (uint64 arrays)."""
    x = a * b
    r = (x - umul64hi(x, mu) * q) & MASK
    assert (r < 2 * q).all(), "the multiply-high leaves one subtract"
    return np.where(r >= q, r - q, r)


def columns(width: int) -> np.ndarray:
    """The first column of every thread's group (grid.x blocks of THREADS
    threads, VEC columns each), each column of [0, width) taken once."""
    blocks = -(-width // (VEC * THREADS))
    g = (np.arange(blocks)[:, None] * THREADS + np.arange(THREADS)).ravel()
    g = g[g < width // VEC]
    f = g * VEC
    cols = (f[:, None] + np.arange(VEC)).ravel()
    assert np.array_equal(np.sort(cols), np.arange(width)), "a column is taken once"
    return f


def mac(c0, c1, pts, bcast: bool, accs, q, mu, rows_per_split: int, drawn=None):
    """One launch: c0 (and c1, or `drawn` = (key columns, n_axis, lo)) uint64
    words [n, L, C, I]; `pts` [n_k, L, C, I] words, or [n_k, L, C] where
    `bcast`; `accs` int64 [L, C, I] pairs, added to in place."""
    n, L, C, I = c0.shape
    width = L * C * I
    f = columns(width)
    cols = (f[:, None] + np.arange(VEC)).ravel()
    j = (cols // I) % C
    l = (cols // (I * C)).astype(np.uint64)  # noqa: E741 (the kernel's names)
    i = (cols % I).astype(np.uint64)
    qj, muj = q.astype(np.uint64)[j], mu.astype(np.uint64)[j]
    c0f, c1f = c0.reshape(n, width)[:, cols], None if c1 is None else c1.reshape(n, width)[:, cols]
    for r0 in range(0, n, rows_per_split):
        r1 = min(n, r0 + rows_per_split)
        if drawn is None:
            b = c1f[r0:r1]
        else:
            table, n_axis, lo = drawn
            assert lo + n <= n_axis
            r = np.arange(r0, r1, dtype=np.uint64)[:, None]
            ctr = np.uint64(lo * L * I) + (r * np.uint64(L) + l) * np.uint64(I) + i
            b = np.zeros(ctr.shape, np.uint64)
            for jj in range(C):
                sel = j == jj
                assert table[jj][4] == q[jj], "the draw's span is Q_j"
                b[:, sel] = prng_replay.draw_value(table[jj], ctr[:, sel])
        for pt, (a0, a1) in zip(pts, accs):
            k1 = min(r1, pt.shape[0])
            if r0 >= k1:
                continue  # no row of this split meets the operand: no atomics
            if bcast:
                w = pt.reshape(pt.shape[0], L * C)[r0:k1][:, cols // I]
            else:
                w = pt.reshape(pt.shape[0], width)[r0:k1][:, cols]
            rows = k1 - r0
            s0 = mul_mod_exact(c0f[r0:k1], w, qj, muj).sum(0, dtype=np.uint64)
            s1 = mul_mod_exact(b[:rows], w, qj, muj).sum(0, dtype=np.uint64)
            for acc, s in ((a0, s0), (a1, s1)):
                flat = acc.reshape(-1).view(np.uint64)
                flat[cols] += s


def _words(ptr: int, count: int, ctype=ctypes.c_uint32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


class _Lib:
    """`ringsnark_mac` and `ringsnark_mac_drawn` over host memory."""

    def __init__(self):
        self.calls = []

    def _run(self, c0, c1, drawn, ptrs, rows, P, bcast, q, mu, C, n, L, I, rps):
        assert 1 <= P <= MAX_OPS and I % VEC == 0 and n >= 1
        ptrs = _words(ptrs, 3 * MAX_OPS, ctypes.c_uint64)
        rows = _words(rows, P, ctypes.c_int64)
        q = _words(q, C).astype(np.uint64)
        mu = _words(mu, C, ctypes.c_uint64)
        assert all(int(m) == (1 << 64) // int(p) for p, m in zip(q, mu))
        assert -(-n // rps) <= 65535 and all(1 <= r <= n for r in rows)
        shape = (n, L, C, I)
        words = (lambda p: _words(p, n * L * C * I).astype(np.uint64).reshape(shape))
        pts = [_words(int(ptrs[k]), int(rows[k]) * L * C * (1 if bcast else I))
               .astype(np.uint64).reshape(int(rows[k]), L, C, *(() if bcast else (I,)))
               for k in range(P)]
        accs = [tuple(_words(int(ptrs[m * MAX_OPS + k]), L * C * I, ctypes.c_int64)
                      .reshape(L, C, I) for m in (1, 2)) for k in range(P)]
        mac(words(c0), None if c1 is None else words(c1), pts, bool(bcast), accs, q, mu, rps,
            drawn)
        self.calls.append((P, bool(bcast), drawn is not None, n, rps))
        return 0

    def ringsnark_mac(self, c0, c1, ptrs, rows, P, bcast, q, mu, C, n, L, I, rps, stream):
        return self._run(c0, c1, None, ptrs, rows, P, bcast, q, mu, C, n, L, I, rps)

    def ringsnark_mac_drawn(self, c0, table, n_axis, lo, ptrs, rows, P, bcast, q, mu, C, n, L,
                            I, rps, stream):
        t = _words(table, 8 * C).reshape(C, 8).astype(np.uint64)
        return self._run(c0, None, (t, n_axis, lo), ptrs, rows, P, bcast, q, mu, C, n, L, I,
                         rps)


def lib() -> _Lib:
    return _Lib()
