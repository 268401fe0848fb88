"""numpy replay of `ringsnark_tpu_torch/csrc/prng.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrappers' own launch geometry (`cuda_prng.geometry`) and key
tables (`cuda_prng.column`, `uniform_columns`, `shoup_pairs`, `t_pairs`):
the lines of a launch and their split into (o, r, a, c), the words a
thread writes, each word's 64-bit counter, threefry2x32 as the kernel
unrolls it in uint32 arithmetic (uint64 with a 32-bit mask), the reduction
mod the span by a multiply-high with mu, the CBD popcounts, the lift
(`lift_consts`: Q - t, Q, t mod Q and its Shoup constant) with the line and
t/2 a thread's where a CTA's block is one line, its first step a multiply-add
by v > t/2, the second in signed 32-bit words without the error, and with it
the error's sign taken once, t |e| mod Q by Shoup and one conditional
subtract, and the encryption kernel's walk over a given number of
resident CTAs (`enc_walk`): each CTA's run of (tile, row) units, a
thread's words kEncThreads apart with their s pairs, the row counter's low
word advanced with one carry test a row, and its Shoup products.

`lib(ctas)` gives an object with the library's C functions
`ringsnark_prng_lift` and `ringsnark_prng_encrypt` over host memory (the
tensors' pointers read with `np.ctypeslib`; the encryption as if `ctas`
CTAs were resident), so the wrappers and every prover run through them on
the CPU.
"""

import ctypes

import numpy as np

from ntt_replay import add, shoup, sub

MASK = np.uint64(0xFFFFFFFF)
THREADS, PER = 256, 4  # kThreads, kPer in csrc/prng.cu
LIFT_LOG = 10  # kLiftLog: a CTA's kThreads * kPer coefficients
ENC_THREADS, ENC_WORDS = 256, 8  # kEncThreads, kEncWords
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
    _, a, r, o = _lines(geo, len(moduli), False, False)
    ctr, i = _counters(geo, a, r, o)
    e = _cbd_words(key, k, ctr, np.uint64(geo.n_axis * geo.A * geo.I))
    out = np.zeros((len(e), len(moduli), geo.I), np.uint64)
    for j, q in enumerate(moduli):
        out[:, j, i.astype(np.int64)] = np.where(e < 0, e + q, e)
    return out.reshape(geo.rows, geo.A, len(moduli), geo.I)


def _cbd_words(key, k: int, ctr, step):
    """The CBD error at the counters `ctr` of side 0, word 0 (int64): words
    (side, w) at ctr + (side * n_words + w) * step, the last masked."""
    n_words = -(-k // 32)
    last_mask = np.uint64((1 << (k - 32 * (n_words - 1))) - 1)
    e = np.zeros(ctr.shape, np.int64)
    for w in range(n_words):
        mask = last_mask if w == n_words - 1 else MASK
        for side, sign in ((w, 1), (n_words + w, -1)):
            u = threefry_word(key[0], key[1], np.uint64(side) * step + ctr) & mask
            e += sign * np.bitwise_count(u).astype(np.int64)
    return e


def lift_word(v, big, consts, error=None):
    """`lift_word`: v's word in the column `consts` ([..., 4]: Q - t as a
    32-bit word, Q, t mod Q, its Shoup constant) with big = v > t/2 (0 or
    1); `error` = (neg, sgn, mag), the error's sign taken once."""
    q = consts[..., 1]
    x = (v + big * consts[..., 0]) & MASK  # imad(big, Q - t, v)
    if error is None:  # the second step in signed 32-bit words
        xs = np.where(x >= 1 << 31, x.astype(np.int64) - (1 << 32), x.astype(np.int64))
        return np.where(xs >= q.astype(np.int64), x - q, x) & MASK
    neg, sgn, mag = error
    assert (x < q).all(), "t < 2 Q: the first step gives v's residue"
    te = shoup(mag, consts[..., 2:], q)  # t |e| mod Q
    y = (x + neg * q + sgn * te) & MASK
    assert (y < 2 * q).all(), "one conditional subtract"
    return np.where(y >= q, y - q, y)


def lift(pt, consts, C: int, geo, scalar: bool, cbd=None) -> np.ndarray:
    """`lift_kernel`: uint32 words [rows, A, C, I] from pt ([rows, A, I], or
    [rows, A] where `scalar`) and consts [A, Cs, 4] (uint64 words); `cbd` =
    (key, k) adds t * e for the error at the draw's counters (`geo` the
    error's geometry, else the launch's).  The grid's coefficients by
    (block, j, thread); where a line holds a CTA's block (I >= 2^LIFT_LOG)
    the line, t/2 and the error's high counter words are the thread's (taken
    from its coefficient j = 0, and checked to be every j's), else each
    coefficient's own."""
    A, I = geo.A, geo.I
    assert I & (I - 1) == 0 and consts.shape[1] >= C
    log_i = I.bit_length() - 1
    n = geo.rows * A * I
    assert n * C < 1 << 32, "32-bit offsets"
    block = THREADS * PER
    b = np.arange(-(-n // block), dtype=np.uint64)[:, None, None] * np.uint64(block)
    local = (np.arange(PER)[None, :, None] * THREADS + np.arange(THREADS)).astype(np.uint64)
    valid = np.broadcast_to(local < np.uint64(n) - b, (len(b), PER, THREADS))
    x = b + local  # [blocks, kPer, kThreads]
    one_line = log_i >= LIFT_LOG
    if one_line:  # the thread's line, from its coefficient j = 0
        line = np.broadcast_to(x[:, :1] >> np.uint64(log_i), x.shape)
        assert np.array_equal(line, x >> np.uint64(log_i)), "a CTA's block is one line's"
    else:
        line = x >> np.uint64(log_i)
    x, line = x[valid], line[valid]
    assert np.array_equal(np.sort(x), np.arange(n, dtype=np.uint64)), "each coefficient once"
    i = x & np.uint64(I - 1)
    pt = pt.reshape(-1)
    v = np.where(i == 0, pt[line.astype(np.int64)], 0) if scalar else pt[x.astype(np.int64)]
    k4 = consts[(line % np.uint64(A)).astype(np.int64)]  # [n, Cs, 4]: the thread's row
    half = ((k4[:, 0, 1] - k4[:, 0, 0]) & MASK) >> np.uint64(1)  # t/2: Q - (Q - t)
    big = ((half - v) & MASK) >> np.uint64(31)
    assert np.array_equal(big.astype(bool), v > half)
    error = None
    if cbd is not None:
        key, k = cbd
        step = np.uint64(geo.n_axis * A * I)
        ctr = np.uint64(geo.lo * A * I) + x
        if one_line and k <= 32:  # the one-word draw: a side's high word the thread's
            x0 = x - (x & np.uint64(block - 1)) + (x & np.uint64(THREADS - 1))
            j = (x & np.uint64(block - 1)) >> np.uint64(THREADS.bit_length() - 1)
            for side in (0, 1):
                c0 = np.uint64(geo.lo * A * I) + np.uint64(side) * step + x0
                lo = (c0 & MASK) + j * np.uint64(THREADS)
                assert (lo <= MASK).all(), "no counter of a block carries"
                assert np.array_equal(((c0 >> np.uint64(32)) << np.uint64(32)) | lo,
                                      ctr + np.uint64(side) * step)
        e = _cbd_words(key, k, ctr, step)
        neg = (e < 0).astype(np.uint64)
        sgn = (1 - 2 * neg.astype(np.int64)).astype(np.uint64) & MASK  # +-1 as a 32-bit word
        mag = (e.astype(np.uint64) * sgn) & MASK
        assert np.array_equal(mag, np.abs(e).astype(np.uint64))
        error = (neg, sgn, mag)
    out = np.full((geo.rows * A * C * I,), MASK, np.uint64)  # words no thread writes stay all ones
    for c in range(C):
        off = ((line * np.uint64(C)) << np.uint64(log_i)) + i + np.uint64(c << log_i)
        out[off.astype(np.int64)] = lift_word(v, big, k4[:, c], error)
    assert (out != MASK).all(), "every word is written"
    return out.reshape(geo.rows, A, C, I)


def enc_walk(rows: int, A: int, C: int, I: int, ctas: int):  # noqa: E741
    """The launcher's walk with `ctas` resident CTAs: (slices of
    kEncThreads * kEncWords words along I, then the (tile, first row, rows)
    runs of every CTA in CTA order, each (tile, row) unit once).  Units are
    A * C * slices * rows, unit = tile * rows + r, tile = (a * C + c) *
    slices + slice; min(units, ctas) CTAs, CTA b taking units [b * units //
    grid, (b + 1) * units // grid)."""
    slices = -(-I // (ENC_THREADS * ENC_WORDS))
    units = A * C * slices * rows
    grid = max(1, min(units, ctas))
    runs, seen = [], 0
    for b in range(grid):
        unit, end = units * b // grid, units * (b + 1) // grid
        assert unit == seen, "the CTAs' runs tile the units"
        while unit < end:
            tile, r = divmod(unit, rows)
            n = min(rows - r, end - unit)
            runs.append((tile, r, n))
            unit += n
        seen = end
    assert seen == units
    return slices, runs


def encrypt(columns, geo, L: int, u, s_pairs, ctas: int, with_c1: bool = True):
    """`encrypt_kernel` over `ctas` resident CTAs: (c0, c1 or None) uint32
    [rows, A, C, I] from u ([rows, A, C, I] residues) and s pairs [L, C, I,
    2] (uint64 words)."""
    C, A, I, R = len(columns), geo.A, geo.I, geo.rows
    assert I & (I - 1) == 0
    c0 = np.full((R, A, C, I), MASK, np.uint64)  # words no thread writes stay all ones
    c1 = np.full_like(c0, MASK) if with_c1 else None
    j = np.arange(ENC_WORDS, dtype=np.uint64)[:, None] * np.uint64(ENC_THREADS)
    tid = np.arange(ENC_THREADS, dtype=np.uint64)[None, :]
    slices, runs = enc_walk(R, A, C, I, ctas)
    for tile, r, n in runs:
        slc, c, a = tile % slices, (tile // slices) % C, tile // slices // C
        col = columns[c]
        Q = np.uint64(col[4])
        i0 = np.uint64(slc * ENC_THREADS * ENC_WORDS) + tid  # each thread's word 0
        i = i0 + j  # [words, threads]
        ok = i < np.uint64(I)
        ii = i[ok].astype(np.int64)
        sv = s_pairs[a % L, c][ii]  # read once a tile
        ctr = np.uint64(geo.lo * A * I) + np.uint64((r * A + a) * I) + i0
        lo, hi = ctr & MASK, ctr >> np.uint64(32)
        for k in range(r, r + n):
            ctr_w = (hi << np.uint64(32)) | ((lo + j) & MASK)  # no word of a line carries
            av = draw_value(col, ctr_w)[ok]
            v = sub(u[k, a, c][ii], shoup(av, sv, Q), Q)
            assert (c0[k, a, c][ii] == MASK).all(), "a word is written once"
            c0[k, a, c, ii] = v
            if with_c1:
                c1[k, a, c, ii] = av
            lo = lo + np.uint64(A * I)
            hi = hi + (lo >> np.uint64(32))  # the row's carry test
            lo &= MASK
    assert (c0 != MASK).all(), "every word is written"
    return c0, c1


def _words(ptr: int, count: int, ctype=ctypes.c_uint32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


class _Lib:
    """`ringsnark_prng_lift` and `ringsnark_prng_encrypt` over host memory,
    with the C functions' arguments; the encryption walks as if `ctas` CTAs
    were resident."""

    def __init__(self, ctas: int = 7):
        self.ctas, self.calls = ctas, []

    def ringsnark_prng_lift(self, out, pt, k, C, Cs, scalar, k0, k1, n_words, last_mask, n_axis,
                            lo, rows, A, I, stream):
        from types import SimpleNamespace

        assert 1 <= C <= Cs and I & (I - 1) == 0 and 0 <= n_words <= 64
        geo = SimpleNamespace(n_axis=n_axis, lo=lo, rows=rows, A=A, I=I)
        consts = _words(k, A * Cs * 4).astype(np.uint64).reshape(A, Cs, 4)
        src = _words(pt, rows * A * (1 if scalar else I)).astype(np.uint64)
        k = None
        if n_words:
            k = 32 * (n_words - 1) + int(last_mask).bit_length()
            assert last_mask == (1 << (k - 32 * (n_words - 1))) - 1
        got = lift(src, consts, C, geo, bool(scalar), None if k is None else ((k0, k1), k))
        _words(out, got.size)[:] = got.reshape(-1).astype(np.uint32)
        self.calls.append(("lift", bool(n_words), bool(scalar), rows))
        return 0

    def ringsnark_prng_encrypt(self, c0, c1, u, s, table, C, L, n_axis, lo, rows, A, I, stream):
        from types import SimpleNamespace

        geo = SimpleNamespace(n_axis=n_axis, lo=lo, rows=rows, A=A, I=I)
        cols = [tuple(int(w) for w in row) for row in _words(table, 8 * C).reshape(C, 8)]
        n = rows * A * C * I
        uu = _words(u, n).astype(np.uint64).reshape(rows, A, C, I)
        sp = _words(s, 2 * L * C * I).astype(np.uint64).reshape(L, C, I, 2)
        r0, r1 = encrypt(cols, geo, L, uu, sp, self.ctas, c1 is not None)
        _words(c0, n)[:] = r0.reshape(-1).astype(np.uint32)
        if c1 is not None:
            _words(c1, n)[:] = r1.reshape(-1).astype(np.uint32)
        self.calls.append(("encrypt", c1 is not None, rows))
        return 0


def lib(ctas: int = 7) -> _Lib:
    return _Lib(ctas)
