"""numpy replay of `ringsnark_tpu_torch/csrc/mac.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrapper's own constants (`cuda_mac.barrett`) and the
launcher's persistent walk at a given number of resident CTAs (`walk`):
each CTA's runs of (tile, row) units, rows fastest, every unit taken once;
the columns of a tile's threads, VEC to a thread, every (row, column)
taken once; every term reduced with the operand word's Shoup constant made
from mu's 32-bit halves (`shoup_of`) and one multiply-high (`mul_mod`), the
kernel's 32-bit wraps checked against the bounds its comment proves; the
rows of a run in pairs, a pair's two terms added in 32 bits (checked below
2^32) and then into 64 bits; each run's sums added to the accumulators as
the atomics do, skipping an operand that no row of the run meets; the
drawn c1 one threefry word a value reduced mod Q_j (`prng_replay.mod_span`;
the launcher takes no column whose draw needs a high word or an offset) at
counters kept as 32-bit halves, the row step's carry tested once a row.

`lib(ctas)` gives an object with the library's two C functions over host
memory (the tensors' pointers read with `np.ctypeslib`), so the wrapper and
every prover run through it on the CPU.
"""

import ctypes

import numpy as np

import prng_replay

MASK = np.uint64(0xFFFFFFFF)
THREADS, VEC, MAX_OPS = 256, 4, 4  # kThreads, kVec, kMaxOps in csrc/mac.cu
TILE = THREADS * VEC  # kTile: columns a tile
_32 = np.uint64(32)


def shoup_of(w, mu):
    """`shoup_of`: floor(w * mu / 2^32) mod 2^32 from mu's halves (uint64
    arrays; w < q)."""
    mu_hi, mu_lo = mu >> _32, mu & MASK
    return (w * mu_hi + ((w * mu_lo) >> _32)) & MASK


def mul_mod(a, w, w_sh, q):
    """`mul_mod`: a * w mod q for a < 2^31, w < q, w_sh = shoup_of(w)."""
    assert (a < np.uint64(1 << 31)).all() and (w < q).all(), "the kernel's operands"
    t = (a * w_sh) >> _32
    r = (a * w - t * q) & MASK  # the kernel's wrapped 32-bit a * w - t * q
    assert (r < 2 * q).all(), "t is floor(a w / q) or one less"
    return np.where(r >= q, r - q, r)


def walk(n: int, width: int, ctas: int) -> list:
    """The launcher's walk with `ctas` resident CTAs: the (tile, first row,
    rows) runs of every CTA in CTA order.  Units are tiles * n, unit = tile
    * n + r; min(units, ctas) CTAs, CTA b taking units [b * units // grid,
    (b + 1) * units // grid)."""
    units = -(-width // TILE) * n
    grid = max(1, min(units, ctas))
    runs, seen = [], 0
    for b in range(grid):
        unit, end = units * b // grid, units * (b + 1) // grid
        assert unit == seen, "the CTAs' runs tile the units"
        while unit < end:
            tile, r = divmod(unit, n)
            rows = min(n - r, end - unit)
            runs.append((tile, r, rows))
            unit += rows
        seen = end
    assert seen == units
    return runs


def _drawn_words(drawn, cols, r0: int, rows: int, L: int, C: int, I: int, q):  # noqa: E741
    """c1 of rows [r0, r0 + rows) at columns `cols` (groups of VEC): the
    counter of a thread's first column at row r0 in 64 bits once, then its
    32-bit halves, the low word stepped by L * I a row with one carry test;
    the VEC words of a group at low + v (no carry: a line starts at a
    multiple of I)."""
    table, n_axis, lo = drawn
    assert lo + r0 + rows <= n_axis and I & (I - 1) == 0
    f = cols[::VEC]
    i, lj = f % I, f // I
    start = (np.uint64((lo + r0) * L * I) + (lj // C).astype(np.uint64) * np.uint64(I)
             + i.astype(np.uint64))
    step = np.uint64(L * I)
    low = (start & MASK) + step * np.arange(rows, dtype=np.uint64)[:, None]
    low &= MASK
    carry = np.cumsum(low[1:] < step, axis=0, dtype=np.uint64)
    high = (start >> _32) + np.concatenate([np.zeros((1, len(f)), np.uint64), carry])
    assert np.array_equal((high << _32) | low,
                          start + step * np.arange(rows, dtype=np.uint64)[:, None])
    assert ((low & np.uint64(I - 1)) + np.uint64(VEC) <= np.uint64(I)).all()
    ctr = ((high << _32) | low)[:, :, None] + np.arange(VEC, dtype=np.uint64)
    ctr = ctr.reshape(rows, len(cols))
    j = (cols // I) % C
    b = np.zeros(ctr.shape, np.uint64)
    for jj in range(C):
        sel = j == jj
        lo0, lo1, _, _, span, _, mu, _ = (np.uint64(v) for v in table[jj])
        assert span == q[jj], "the draw's span is Q_j"
        b[:, sel] = prng_replay.mod_span(prng_replay.threefry_word(lo0, lo1, ctr[:, sel]), span,
                                         mu)
    return b


def _pair_sums(t):
    """The rows' terms added a pair at a time in 32 bits, then in 64."""
    if len(t) % 2:
        t = np.concatenate([t, np.zeros((1, t.shape[1]), np.uint64)])
    pairs = t[0::2] + t[1::2]
    assert (pairs <= MASK).all(), "two canonical terms sum below 2^32"
    return pairs.sum(0, dtype=np.uint64)


def mac(c0, c1, pts, bcast: bool, accs, q, mu, ctas: int, drawn=None):
    """One launch over `ctas` resident CTAs: c0 (and c1, or `drawn` = (key
    columns, n_axis, lo)) uint64 words [n, L, C, I]; `pts` [n_k, L, C, I]
    words, or [n_k, L, C] where `bcast`; `accs` int64 [L, C, I] pairs,
    added to in place."""
    n, L, C, I = c0.shape  # noqa: E741 (the kernel's names)
    width = L * C * I
    groups = width // VEC
    q, mu = q.astype(np.uint64), mu.astype(np.uint64)
    c0f = c0.reshape(n, width)
    c1f = None if c1 is None else c1.reshape(n, width)
    taken = np.zeros((n, width), np.int64)
    for tile, r0, rows in walk(n, width, ctas):
        g = tile * THREADS + np.arange(THREADS)
        f = g[g < groups] * VEC
        cols = (f[:, None] + np.arange(VEC)).ravel()
        taken[r0:r0 + rows, cols] += 1
        j = (cols // I) % C
        qj, muj = q[j], mu[j]
        a = c0f[r0:r0 + rows][:, cols]
        b = (c1f[r0:r0 + rows][:, cols] if drawn is None
             else _drawn_words(drawn, cols, r0, rows, L, C, I, q))
        for pt, (a0, a1) in zip(pts, accs):
            live = min(rows, pt.shape[0] - r0)
            if live <= 0:
                continue  # no row of this run meets the operand: no atomics
            w = np.zeros((rows, len(cols)), np.uint64)  # rows past the operand's are zero
            if bcast:
                w[:live] = pt.reshape(pt.shape[0], L * C)[r0:r0 + live][:, cols // I]
            else:
                w[:live] = pt.reshape(pt.shape[0], width)[r0:r0 + live][:, cols]
            w_sh = shoup_of(w, muj)
            for acc, c in ((a0, a), (a1, b)):
                flat = acc.reshape(-1).view(np.uint64)
                flat[cols] += _pair_sums(mul_mod(c, w, w_sh, qj))
    assert (taken == 1).all(), "every (row, column) is taken once"


def _words(ptr: int, count: int, ctype=ctypes.c_uint32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


class _Lib:
    """`ringsnark_mac` and `ringsnark_mac_drawn` over host memory, with
    `ctas` resident CTAs."""

    def __init__(self, ctas: int):
        self.ctas = ctas
        self.calls = []

    def _run(self, c0, c1, drawn, ptrs, rows, P, bcast, q, mu, C, n, L, I):  # noqa: E741
        assert 1 <= P <= MAX_OPS and I % VEC == 0 and n >= 1
        assert n * L * C * I <= 1 << 32, "32-bit offsets"
        ptrs = _words(ptrs, 3 * MAX_OPS, ctypes.c_uint64)
        rows = _words(rows, P, ctypes.c_int64)
        q = _words(q, C).astype(np.uint64)
        mu = _words(mu, C, ctypes.c_uint64)
        assert all(2 <= int(p) < 1 << 31 and int(m) == (1 << 64) // int(p)
                   for p, m in zip(q, mu))
        assert all(1 <= r <= n for r in rows)
        shape = (n, L, C, I)
        words = (lambda p: _words(p, n * L * C * I).astype(np.uint64).reshape(shape))
        pts = [_words(int(ptrs[k]), int(rows[k]) * L * C * (1 if bcast else I))
               .astype(np.uint64).reshape(int(rows[k]), L, C, *(() if bcast else (I,)))
               for k in range(P)]
        accs = [tuple(_words(int(ptrs[m * MAX_OPS + k]), L * C * I, ctypes.c_int64)
                      .reshape(L, C, I) for m in (1, 2)) for k in range(P)]
        mac(words(c0), None if c1 is None else words(c1), pts, bool(bcast), accs, q, mu,
            self.ctas, drawn)
        self.calls.append((P, bool(bcast), drawn is not None, n))
        return 0

    def ringsnark_mac(self, c0, c1, ptrs, rows, P, bcast, q, mu, C, n, L, I, stream):  # noqa: E741
        return self._run(c0, c1, None, ptrs, rows, P, bcast, q, mu, C, n, L, I)

    def ringsnark_mac_drawn(self, c0, table, n_axis, lo, ptrs, rows, P, bcast, q, mu, C, n, L,
                            I, stream):  # noqa: E741
        t = _words(table, 8 * C).reshape(C, 8).astype(np.uint64)
        # the launcher takes one word a value: multiplier 0 and minval 0
        assert not t[:, 5].any() and not t[:, 7].any()
        return self._run(c0, None, (t, n_axis, lo), ptrs, rows, P, bcast, q, mu, C, n, L, I)


def lib(ctas: int = 5) -> _Lib:
    return _Lib(ctas)
