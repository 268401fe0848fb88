"""numpy replay of `ringsnark_tpu_torch/csrc/prng.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrappers' own launch geometry (`cuda_prng.geometry`) and key
tables (`cuda_prng.column`, `uniform_columns`, `shoup_pairs`, `t_pairs`):
the lines of a launch and their split into (o, r, a, c), the words a
thread writes, each word's 64-bit counter, threefry2x32 as the kernel
unrolls it in uint32 arithmetic (uint64 with a 32-bit mask), the reduction
mod the span by a multiply-high with mu, the CBD popcounts, and the
encryption's Shoup products.
"""

import numpy as np

from ntt_replay import add, shoup, sub

MASK = np.uint64(0xFFFFFFFF)
THREADS, PER = 256, 4  # kThreads, kPer in csrc/prng.cu
EVEN, ODD = (13, 15, 26, 6), (17, 29, 16, 24)


def words_of_a_line(I: int) -> np.ndarray:
    """The words of a line in the order the grid's threads take them
    (block x, word k of a thread, thread); each of [0, I) exactly once."""
    bx = np.arange(-(-I // (THREADS * PER)))[:, None, None]
    i = bx * THREADS * PER + np.arange(PER)[None, :, None] * THREADS + np.arange(THREADS)
    i = i[i < I].ravel()
    assert np.array_equal(np.sort(i), np.arange(I)), "a line's words are written once each"
    return i.astype(np.uint64)


def threefry_word(k0, k1, ctr):
    """y0 ^ y1 of threefry2x32((k0, k1), (ctr >> 32, ctr mod 2^32))."""
    k0, k1 = np.uint64(k0), np.uint64(k1)
    k2 = k0 ^ k1 ^ np.uint64(0x1BD11BDA)
    x0 = ((ctr >> np.uint64(32)) + k0) & MASK
    x1 = ((ctr & MASK) + k1) & MASK
    inject = ((k1, k2, 1), (k2, k0, 2), (k0, k1, 3), (k1, k2, 4), (k2, k0, 5))
    for g, (a, b, n) in enumerate(inject):
        for r in EVEN if g % 2 == 0 else ODD:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & MASK
            x1 ^= x0
        x0 = (x0 + a) & MASK
        x1 = (x1 + b + np.uint64(n)) & MASK
    return x0 ^ x1


def mod_span(w, span, mu):
    r = (w - ((w * mu) >> np.uint64(32)) * span) & MASK
    assert (r < 2 * span).all(), "the multiply-high leaves one subtract"
    return np.where(r >= span, r - span, r)


def draw_value(col, ctr):
    lo0, lo1, hi0, hi1, span, mult, mu, minval = (np.uint64(v) for v in col)
    lo = threefry_word(lo0, lo1, ctr)
    if span == 0:
        return lo
    off = mod_span(lo, span, mu)
    if mult:
        hi = mod_span(threefry_word(hi0, hi1, ctr), span, mu)
        off = mod_span((hi * mult + off) & MASK, span, mu)
    return (off + minval) & MASK


def _lines(geo, C: int, over_outer: bool, over_cols: bool):
    """(c, a, r, o) of every line of a launch, in line order."""
    n = (geo.outer if over_outer else 1) * geo.rows * geo.A * (C if over_cols else 1)
    line = np.arange(n, dtype=np.uint64)
    c = line % np.uint64(C) if over_cols else np.zeros_like(line)
    t = line // np.uint64(C) if over_cols else line
    a, t = t % np.uint64(geo.A), t // np.uint64(geo.A)
    r, o = t % np.uint64(geo.rows), t // np.uint64(geo.rows)
    assert over_outer or not o.any()
    return c, a, r, o


def _counters(geo, a, r, o):
    """[lines, I] counters, the words in the order the threads write them."""
    step = np.uint64(geo.n_axis * geo.A * geo.I)
    base = np.uint64(geo.lo * geo.A * geo.I)
    first = o * step + base + (r * np.uint64(geo.A) + a) * np.uint64(geo.I)
    i = words_of_a_line(geo.I)
    return first[:, None] + i[None, :], i


def draw(columns, geo) -> np.ndarray:
    """`draw_kernel`: uint32 words [outer, rows, A, C, I]."""
    C = len(columns)
    c, a, r, o = _lines(geo, C, True, True)
    ctr, i = _counters(geo, a, r, o)
    out = np.zeros((len(c), geo.I), np.uint64)
    for j, col in enumerate(columns):
        sel = c == j
        out[np.ix_(sel, i.astype(np.int64))] = draw_value(col, ctr[sel])
    return out.reshape(geo.outer, geo.rows, geo.A, C, geo.I)


def cbd(moduli, key, k: int, geo) -> np.ndarray:
    """`cbd_kernel`: uint32 residues [rows, A, C, I] of the error with
    parameter k; the word (side, w) is outer block side * n_words + w."""
    n_words = -(-k // 32)
    last_mask = np.uint64((1 << (k - 32 * (n_words - 1))) - 1)
    _, a, r, o = _lines(geo, len(moduli), False, False)
    ctr, i = _counters(geo, a, r, o)
    step = np.uint64(geo.n_axis * geo.A * geo.I)
    e = np.zeros(ctr.shape, np.int64)
    for w in range(n_words):
        mask = last_mask if w == n_words - 1 else MASK
        for side, sign in ((w, 1), (n_words + w, -1)):
            u = threefry_word(key[0], key[1], np.uint64(side) * step + ctr) & mask
            e += sign * np.bitwise_count(u).astype(np.int64)
    out = np.zeros((len(e), len(moduli), geo.I), np.uint64)
    for j, q in enumerate(moduli):
        out[:, j, i.astype(np.int64)] = np.where(e < 0, e + q, e)
    return out.reshape(geo.rows, geo.A, len(moduli), geo.I)


def encrypt(columns, geo, L: int, m, e, s_pairs, tq_pairs):
    """`encrypt_kernel`: (c0, c1) uint32 [rows, A, C, I] from m, e
    ([rows, A, C, I] residues), s pairs [L, C, I, 2] and t pairs [L, C, 2]
    (uint64 words)."""
    C = len(columns)
    c, a, r, o = _lines(geo, C, False, True)
    ctr, i = _counters(geo, a, r, o)
    ii = i.astype(np.int64)
    limb = ((a % np.uint64(L)) * np.uint64(C) + c).astype(np.int64)
    m = m.reshape(-1, geo.I)[:, ii]
    e = e.reshape(-1, geo.I)[:, ii]
    s = s_pairs.reshape(L * C, geo.I, 2)[limb][:, ii]
    tq = tq_pairs.reshape(L * C, 2)[limb][:, None, :]
    c0 = np.zeros((len(c), geo.I), np.uint64)
    c1 = np.zeros_like(c0)
    for j, col in enumerate(columns):
        sel = c == j
        Q = np.uint64(col[4])
        av = draw_value(col, ctr[sel])
        c1[np.ix_(sel, ii)] = av
        c0[np.ix_(sel, ii)] = add(sub(m[sel], shoup(av, s[sel], Q), Q),
                                  shoup(e[sel], tq[sel], Q), Q)
    shape = (geo.rows, geo.A, C, geo.I)
    return c0.reshape(shape), c1.reshape(shape)
