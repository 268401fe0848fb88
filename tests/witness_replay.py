"""numpy replay of `ringsnark_tpu_torch/csrc/witness.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their work on the
host with the wrapper's own geometry (`cuda_witness.geometry`, `moduli`)
and the launcher's plan:

* `spmv`: one launch for every matrix of a call.  The launcher's choice of
  four adjacent slots a thread (16-byte words: every wide window, stride,
  dense coefficient window and output aligned, n a multiple of four) or
  one; its items, matrix by matrix the long rows (long row, limb, slot
  tile), then the tiles (matrix fastest, then slot tile, limb, row tile);
  the persistent walk of a given number of CTAs (CTA b: items b, b + grid,
  ...).  A long row: the CTA's threads (q, g), at most 8 a slot group,
  add the terms of nonzeros k0 + q, q + K, ... and their partial sums are
  added by halves in the shared tile with add_mod.  A tile: each thread's
  rows (r0 + q + j * 256 / G), their bounds and heads, the heads' words
  copied into a ring stage per CTA (stage = the CTA's tile count mod 2; 16
  bytes where the block's slot stride is 1, else one word a slot; at n = 1
  the tile's limbs, the coefficients beside the words; the next tile's
  copies land before the current stage is read, so a wrong stage reads
  another tile's words), the head's coefficient, the further nonzeros of a
  short row, long rows skipped; the store straight (n = 1, or [rows, L,
  n]) or by the warp tiles (slot-major at n > 1: each warp 32 rows by 32
  slots, lane l copying chunk l % 8 of rows l / 8 + 4k swizzled, 16 bytes
  or a word a slot below n, then computing and storing its own row; a
  word never copied is stale and its sum never stored).  Every term z * c mod p
  with c's Shoup constant made from mu's halves (`mac_replay.shoup_of`,
  `mac_replay.mul_mod`, whose asserts check the kernel's 32-bit wraps),
  summed with add_mod (checked below 2^32); the assignment word from the
  last block starting at or below the column, at its strides; every output
  word written once.
* `mulmod`: the launcher's choice of four words a thread or one, each
  word of b given its Shoup constant from mu's halves (`mac_replay.shoup_of`)
  and reduced by `mac_replay.mul_mod`, c added with add_mod.

`lib(ctas)` gives an object with the library's two C functions over host
memory (the tensors' pointers read with `np.ctypeslib`), `spmv` walking
`ctas` CTAs, so the wrappers and every prover run through it on the CPU.
"""

import ctypes

import numpy as np

import mac_replay
from ringsnark_tpu_torch.ops import cuda_witness

THREADS = cuda_witness.THREADS
STAGE = THREADS * 32  # kStageWords
STALE = 0xFFFFFFFF  # a ring word no copy wrote: terms of it would fail mac_replay's asserts


def term(z, w, p, mu):
    """`term`: z * w mod p with w's Shoup constant from mu's halves
    (`mac_replay.shoup_of`, `mac_replay.mul_mod`: z < 2^31, w < p)."""
    return mac_replay.mul_mod(z, w, mac_replay.shoup_of(w, mu), p)


def add_mod(a, b, p):
    s = a + b
    assert (a < p).all() and (b < p).all() and (s < np.uint64(1 << 32)).all()
    return np.where(s >= p, s - p, s)


def _words(ptr: int, count: int, ctype=ctypes.c_uint32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


def _gather(ptr: int, offsets: np.ndarray) -> np.ndarray:
    """The uint32 words at `offsets` (words) from `ptr`."""
    if not offsets.size:
        return np.zeros(0, np.uint64)
    assert offsets.min() >= 0
    return _words(ptr, int(offsets.max()) + 1)[offsets].astype(np.uint64)


def z_ref(blocks, c, l, i):
    """`z_ref`: for the assignment words (c, l, i) (arrays), each from the
    last block that starts at or below its row: the word offsets from each
    block's pointer, the block and its slot stride."""
    which = np.zeros(c.shape, np.int64)
    for b, blk in enumerate(blocks[1:], 1):
        which = np.where(c >= blk[1], b, which)
    start, row, limb, slot = (np.array([blk[k] for blk in blocks], np.int64)[which]
                              for k in (1, 2, 3, 4))
    return (c - start) * row + l * limb + i * slot, which, slot


def z_words(blocks, c, l, i, vec):
    """`z_load`: VEC words a slot apart from each (c, l, i) (16 bytes where
    the slot stride is 1: checked aligned), [..., vec]."""
    off, which, slot = z_ref(blocks, c, l, i)
    out = np.zeros(c.shape + (vec,), np.uint64)
    for b, (ptr, *_) in enumerate(blocks):
        m = which == b
        if vec == 4:
            wide = m & (slot == 1)
            assert ((ptr + 4 * off[wide]) % 16 == 0).all(), "16-byte words aligned"
        for v in range(vec):
            out[m, v] = _gather(ptr, off[m] + v * slot[m])
    return out


def coef_words(mat, k, l, i, vec):
    """`coef_load`: nonzero k's coefficients at limb l for slots i..i+VEC-1."""
    base = k * mat["ck"] + l * mat["cl"] + i * mat["ci"]
    return np.stack([_gather(mat["coef"], base + v * mat["ci"]) for v in range(vec)], axis=-1)


def terms(zw, w, p, mu):
    return term(zw.ravel(), w.ravel(), np.uint64(p), mu).reshape(zw.shape)


class Launch:
    """One launch of spmv_kernel over host memory: the launcher's plan
    (`vec`, the tile, the items) and the kernel's work, CTA by CTA."""

    def __init__(self, mats, blocks, primes, mu, L, rows, n, slot_major, vec):
        self.mats, self.blocks, self.primes, self.mu = mats, blocks, primes, mu
        self.L, self.rows, self.n, self.slot_major, self.vec = L, rows, n, slot_major, vec
        self.log_g, self.log_ts, self.log_tr, self.lt = cuda_witness.geometry(n, vec, L,
                                                                             slot_major)
        self.log_rp = 8 - self.log_g
        self.R = 8 if vec == 4 else 4  # a thread's rows
        self.slot_tiles = -(-n // (1 << self.log_ts))
        # a long row's slot tiles: at most LONG_GROUP threads a row
        self.log_gl = min(self.log_g, cuda_witness.LONG_GROUP.bit_length() - 1)
        self.long_slot_tiles = -(-n // (vec << self.log_gl))
        self.tiles = -(-rows // (1 << self.log_tr)) * (L // self.lt) * self.slot_tiles
        for m in mats:
            m["long_items"] = m["nlong"] * L * self.long_slot_tiles
        self.long_items = sum(m["long_items"] for m in mats)
        self.items = self.long_items + len(mats) * self.tiles
        tid = np.arange(THREADS)
        self.g, self.q = tid & ((1 << self.log_g) - 1), tid >> self.log_g
        self.outs = [np.zeros(rows * L * n, np.uint64) for _ in mats]
        self.written = [np.zeros(rows * L * n, np.int64) for _ in mats]

    def out_index(self, r, l, i):
        if self.slot_major:
            return (i * self.L + l) * self.rows + r
        return (r * self.L + l) * self.n + i

    def store(self, m, r, l, i, val):
        dst = self.out_index(r, l, i)
        self.outs[m][dst] = val
        np.add.at(self.written[m], dst, 1)

    def long_item(self, u):
        """A long row: thread (q, g)'s partial sums over nonzeros k0 + q, q +
        K, ..., added by halves in the tile, stored by the threads q = 0."""
        mi = 0
        while mi + 1 < len(self.mats) and u >= self.mats[mi]["long_items"]:
            u -= self.mats[mi]["long_items"]
            mi += 1
        M, vec = self.mats[mi], self.vec
        st, u = u % self.long_slot_tiles, u // self.long_slot_tiles
        l, j = u % self.L, u // self.L
        r = int(M["longs"][j])
        k0, k1 = int(M["ptr"][r]), int(M["ptr"][r + 1])
        ts, K = vec << self.log_gl, THREADS >> self.log_gl
        tid = np.arange(THREADS)
        g, q = tid & ((1 << self.log_gl) - 1), tid >> self.log_gl
        i = st * ts + g * vec
        live = i < self.n
        p = self.primes[l]
        acc = np.zeros((THREADS, vec), np.uint64)
        ks = np.arange(k0, k1)
        if ks.size and live.any():  # each (nonzero, slot group) term, summed by its thread
            gs = np.flatnonzero(live[:1 << self.log_gl])
            kk, gg = np.repeat(ks, gs.size), np.tile(gs, ks.size)
            ii = st * ts + gg * vec
            zw = z_words(self.blocks, M["idx"][kk], np.full(kk.size, l), ii, vec)
            tw = terms(zw, coef_words(M, kk, l, ii, vec), p, self.mu[l])
            owner = ((kk - k0) % K) * (1 << self.log_gl) + gg  # thread (q, g)
            for v in range(vec):
                sums = np.zeros(THREADS, np.uint64)
                np.add.at(sums, owner, tw[:, v])  # below 2^64: fewer than 2^33 terms
                acc[:, v] = sums % np.uint64(p)
        tile = np.zeros(STAGE, np.uint64)
        a = q * ts + g * vec
        for v in range(vec):
            tile[a + v] = acc[:, v]
        h = K >> 1
        while h:
            m = q < h
            for v in range(vec):
                tile[a[m] + v] = add_mod(tile[a[m] + v], tile[a[m] + h * ts + v], p)
            h >>= 1
        m = (q == 0) & live
        for v in range(vec):
            self.store(mi, np.full(m.sum(), r), l, i[m] + v, tile[a[m] + v])

    def at(self, t):
        m, t = t % len(self.mats), t // len(self.mats)
        i0, t = (t % self.slot_tiles) << self.log_ts, t // self.slot_tiles
        lts = self.L // self.lt
        return m, t % lts, (t // lts) << self.log_tr, i0

    def rows_of(self, a):
        """rows_of: [R, THREADS] first nonzero, length and head."""
        m, _, r0, _ = a
        M = self.mats[m]
        r = r0 + self.q[None, :] + (np.arange(self.R)[:, None] << self.log_rp)
        inside = r < M["csr_rows"]
        rs = np.where(inside, r, 0)
        if not M["csr_rows"]:
            return rs, rs, rs
        if M["unit"]:
            k0, ln, c = rs, np.ones_like(rs), M["idx"][rs]
        else:
            k0 = M["ptr"][rs]
            ln, c = M["ptr"][rs + 1] - k0, M["head"][rs]
        return (np.where(inside, k0, 0), np.where(inside, ln, 0), np.where(inside, c, 0))

    def issue(self, a, stage, rows):
        """issue: the heads' words into `stage` (each thread its own), the
        scalar coefficients; returns them."""
        m, l, _, i0 = a
        M, vec = self.mats[m], self.vec
        k0, ln, c = rows
        if self.log_ts == 0:  # n = 1: the tile's limbs, words and coefficients
            copy = (ln > 0) & (ln <= M["long_len"])
            tid = np.broadcast_to(np.arange(THREADS)[None, :], k0.shape)
            j = np.broadcast_to(np.arange(self.R)[:, None], k0.shape)
            for e in range(self.lt):
                at_z = ((j[copy] * self.lt + e) << 8) + tid[copy]
                stage[at_z] = z_words(self.blocks, c[copy], np.full(copy.sum(), l + e),
                                      np.zeros(copy.sum(), np.int64), 1)[:, 0]
                stage[at_z + ((self.R * self.lt) << 8)] = coef_words(M, k0[copy], l + e, 0, 1)[:, 0]
            return None
        i = np.broadcast_to(i0 + self.g[None, :] * vec, k0.shape)
        copy = (i < self.n) & (ln > 0) & (ln <= M["long_len"])
        pos = ((np.arange(self.R)[:, None] << 8) + np.arange(THREADS)[None, :]) * vec
        words = z_words(self.blocks, c[copy], np.full(copy.sum(), l), i[copy], vec)
        for v in range(vec):
            stage[pos[copy] + v] = words[:, v]
        w = np.zeros(k0.shape, np.uint64)
        if not M["ci"]:
            w[copy] = coef_words(M, k0[copy], l, 0, 1)[:, 0]
        return w

    def run(self, a, stage, rows, w):
        """run: a tile's sums (the heads from the stage, then the further
        nonzeros of the short rows) and their store."""
        m, l, r0, i0 = a
        if self.log_ts == 0:
            return self.run_n1(a, stage, rows)
        M, vec, p, mu = self.mats[m], self.vec, self.primes[l], self.mu[l]
        k0, ln, _ = rows
        i = np.broadcast_to(i0 + self.g[None, :] * vec, k0.shape)
        live = i < self.n
        short = live & (ln > 0) & (ln <= M["long_len"])
        pos = ((np.arange(self.R)[:, None] << 8) + np.arange(THREADS)[None, :]) * vec
        val = np.zeros(k0.shape + (vec,), np.uint64)
        zs = np.stack([stage[pos[short] + v] for v in range(vec)], axis=-1)
        if M["ci"]:
            wv = coef_words(M, k0[short], l, i[short], vec)
        else:
            wv = np.repeat(w[short][:, None], vec, axis=1)
        val[short] = terms(zs, wv, p, mu)
        steps = int((np.where(short, ln, 1) - 1).max(initial=0))
        for step in range(1, steps + 1):
            more = live & (step < ln) & (ln <= M["long_len"])
            k = k0[more] + step
            zw = z_words(self.blocks, M["idx"][k], np.full(k.size, l), i[more], vec)
            val[more] = add_mod(val[more], terms(zw, coef_words(M, k, l, i[more], vec), p, mu), p)
        r = r0 + self.q[None, :] + (np.arange(self.R)[:, None] << self.log_rp)
        assert not self.slot_major, "slot-major at n > 1 takes the warp tiles"
        ok = (r < self.rows) & live & (ln <= M["long_len"])
        for v in range(vec):
            self.store(m, r[ok], l, i[ok] + v, val[ok][:, v])

    def run_n1(self, a, stage, rows):
        """run at n = 1: limb by limb, each row's word and coefficient from
        the ring, its further nonzeros loaded, a row a thread."""
        m, l0, r0, _ = a
        M = self.mats[m]
        k0, ln, _ = rows
        short = (ln > 0) & (ln <= M["long_len"])
        tid = np.broadcast_to(np.arange(THREADS)[None, :], k0.shape)
        j = np.broadcast_to(np.arange(self.R)[:, None], k0.shape)
        r = r0 + tid + (j << self.log_rp)
        for e in range(self.lt):
            l = l0 + e
            p, mu = self.primes[l], self.mu[l]
            at_z = ((j[short] * self.lt + e) << 8) + tid[short]
            val = np.zeros(k0.shape, np.uint64)
            val[short] = terms(stage[at_z], stage[at_z + ((self.R * self.lt) << 8)], p, mu)
            for step in range(1, int(np.where(short, ln, 1).max(initial=1))):
                more = short & (step < ln)
                k = k0[more] + step
                zw = z_words(self.blocks, M["idx"][k], np.full(k.size, l),
                             np.zeros(k.size, np.int64), 1)[:, 0]
                val[more] = add_mod(val[more], terms(zw, coef_words(M, k, l, 0, 1)[:, 0], p, mu), p)
            ok = (r < self.rows) & (ln <= M["long_len"])
            self.store(m, r[ok], l, 0, val[ok])

    @property
    def warp_tiles(self) -> bool:
        """The launcher's warp tiles: slot-major at n > 1."""
        return self.slot_major and self.n > 1

    def z4(self, c, l, i):
        """z4: four slots from i of rows c at limb l, [..., 4] (16-byte words
        at vec 4; else a word a slot, zero at or past n)."""
        i = np.broadcast_to(i, c.shape)
        if self.vec == 4:
            return z_words(self.blocks, c, np.full(c.shape, l), i, 4)
        out = np.zeros(c.shape + (4,), np.uint64)
        for v in range(4):
            m = i + v < self.n
            out[m, v] = z_words(self.blocks, c[m], np.full(m.sum(), l), i[m] + v, 1)[:, 0]
        return out

    def coef4(self, M, k, l, i):
        """coef4: nonzeros k's coefficients at limb l for four slots from i."""
        i = np.broadcast_to(i, k.shape)
        if self.vec == 4:
            return coef_words(M, k, l, i, 4)
        out = np.zeros(k.shape + (4,), np.uint64)
        for v in range(4):
            m = i + v < self.n
            out[m, v] = coef_words(M, k[m], l, i[m] + v, 1)[:, 0]
        return out

    def warp_rows(self, a):
        """warp_tiles' row_of: [8 warps, 32 lanes] first nonzero, length, head."""
        m, _, r0, _ = a
        M = self.mats[m]
        log_rb = self.log_tr - 5
        warp = np.arange(8)[:, None]
        r = r0 + ((warp & ((1 << log_rb) - 1)) << 5) + np.arange(32)[None, :]
        inside = r < M["csr_rows"]
        rs = np.where(inside, r, 0)
        if not M["csr_rows"]:
            return rs, rs, rs, r
        if M["unit"]:
            k0, ln, c = rs, np.ones_like(rs), M["idx"][rs]
        else:
            k0 = M["ptr"][rs]
            ln, c = M["ptr"][rs + 1] - k0, M["head"][rs]
        return (np.where(inside, k0, 0), np.where(inside, ln, 0), np.where(inside, c, 0), r)

    def warp_issue(self, a, stage, rows):
        """warp_tiles' issue: lane l copies chunk l % 8 of rows l / 8 + 4k (their
        heads from the lanes that own them) into the warp's words, chunk c of
        row rho at rho * 32 + 4 (c ^ rho % 8), a word a slot below n at vec 1;
        the lanes' scalar coefficients."""
        m, l, _, i0 = a
        M = self.mats[m]
        k0, ln, c, _ = rows
        log_rb = self.log_tr - 5
        lane = np.arange(32)
        chunk = lane & 7
        for warp in range(8):
            sb = warp >> log_rb
            i = i0 + (sb << 5) + chunk * 4
            for k in range(8):
                rho = (lane >> 3) + 4 * k
                cr, lr = c[warp, rho], ln[warp, rho]
                ok = (i < self.n) & (lr > 0) & (lr <= M["long_len"])
                words = self.z4(cr[ok], l, i[ok])
                dst = warp * 1024 + rho[ok] * 32 + ((chunk[ok] ^ (rho[ok] & 7)) << 2)
                for v in range(4):
                    below = i[ok] + v < self.n
                    stage[dst[below] + v] = words[below, v]
        w = np.zeros(k0.shape, np.uint64)
        copy = (ln > 0) & (ln <= M["long_len"])
        if not M["ci"]:
            w[copy] = coef_words(M, k0[copy], l, 0, 1)[:, 0]
        return w

    def warp_run(self, a, stage, rows, w):
        """warp_tiles' run: lane = row, its 8 chunks read back swizzled (the
        stale words past n left out of the sums, which are never stored), the
        row's further nonzeros, a slot's 32 rows a store."""
        m, l, _, i0 = a
        M, p, mu = self.mats[m], self.primes[l], self.mu[l]
        k0, ln, _, r = rows
        log_rb = self.log_tr - 5
        lane = np.arange(32)
        for warp in range(8):
            sb = warp >> log_rb
            short = (ln[warp] > 0) & (ln[warp] <= M["long_len"])
            for c8 in range(8):
                i = i0 + (sb << 5) + c8 * 4
                if i >= self.n:
                    continue
                src = warp * 1024 + lane * 32 + ((c8 ^ (lane & 7)) << 2)
                below = i + np.arange(4) < self.n
                zs = np.stack([stage[src + v] for v in range(4)], axis=-1)
                zs = np.where(below[None, :], zs, 0)
                val = np.zeros((32, 4), np.uint64)
                if M["ci"]:
                    wv = self.coef4(M, k0[warp][short], l, i)
                else:
                    wv = np.repeat(w[warp][short][:, None], 4, axis=1)
                val[short] = terms(zs[short], wv, p, mu)
                for step in range(1, int(np.where(short, ln[warp], 1).max(initial=1))):
                    more = short & (step < ln[warp])
                    k = k0[warp][more] + step
                    zw = self.z4(M["idx"][k], l, i)
                    val[more] = add_mod(val[more], terms(zw, self.coef4(M, k, l, i), p, mu), p)
                ok = (r[warp] < self.rows) & (ln[warp] <= M["long_len"])
                for v in np.flatnonzero(below):
                    self.store(m, r[warp][ok], l, i + v, val[ok, v])

    def cta(self, b, grid):
        """CTA b's walk: its long items, then its tiles through the ring."""
        u = b
        while u < self.long_items:
            self.long_item(u)
            u += grid
        if u >= self.items:
            return
        ring = np.full((cuda_witness.STAGES, STAGE), STALE, np.uint64)
        rows_of, issue, run = ((self.warp_rows, self.warp_issue, self.warp_run)
                               if self.warp_tiles else (self.rows_of, self.issue, self.run))
        t, short = u - self.long_items, self.items - self.long_items
        cur = self.at(t)
        rows = rows_of(cur)
        w = issue(cur, ring[0], rows)
        st = 0
        while True:
            tn = t + grid
            if tn < short:  # the next tile's copies, into the other stage
                nxt = self.at(tn)
                nrows = rows_of(nxt)
                nw = issue(nxt, ring[st ^ 1], nrows)
            run(cur, ring[st], rows, w)
            if tn >= short:
                return
            cur, rows, w, st, t = nxt, nrows, nw, st ^ 1, tn


def vector_path(mats, blocks, n, lo) -> bool:
    """The launcher's choice of 16-byte words."""
    vec = n % 4 == 0
    for ptr, _, row, limb, slot in blocks:
        if slot:
            vec = vec and slot == 1 and row % 4 == 0 and limb % 4 == 0 and ptr % 16 == 0
    for m in mats:
        if m["ci"]:
            vec = vec and m["ck"] % 4 == 0 and m["cl"] % 4 == 0 and (m["coef"] + 4 * lo) % 16 == 0
        vec = vec and m["out"] % 16 == 0
    return vec


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

    def __init__(self, ctas: int):
        self.ctas, self.calls = ctas, []

    def ringsnark_spmv(self, mats, nmats, zptrs, zmeta, nblocks, primes, mu, L, rows, n, lo,
                       slot_major, stream):
        assert 1 <= nmats <= 3 and 1 <= nblocks <= 3 and n >= 1 and rows >= 1
        primes = _words(primes, L).astype(np.uint64)
        mu = _words(mu, L, ctypes.c_uint64)
        assert all(2 <= int(p) < 1 << 31 and int(m) == (1 << 64) // int(p)
                   for p, m in zip(primes, mu))
        zp = _words(zptrs, nblocks, ctypes.c_uint64)
        zm = _words(zmeta, 4 * nblocks, ctypes.c_int64).reshape(nblocks, 4)
        assert zm[0, 0] == 0 and (np.diff(zm[:, 0]) >= 0).all()
        blocks = [(int(zp[b]), *map(int, zm[b])) for b in range(nblocks)]
        desc = _words(mats, 13 * nmats, ctypes.c_int64).reshape(nmats, 13)
        ms = []
        for d in desc:
            ptr, idx, head, coef, longs, out, csr_rows, nlong, unit, long_len, ck, cl, ci = map(
                int, d)
            assert 0 <= csr_rows <= rows and 0 <= nlong <= csr_rows and long_len >= 1
            assert ci in (0, 1) and (not nlong or not unit)
            bounds = (np.arange(csr_rows + 1) if unit else
                      _words(ptr, csr_rows + 1, ctypes.c_int32).astype(np.int64))
            nnz = int(bounds[-1])
            ix = _words(idx, nnz, ctypes.c_int64) if nnz else np.zeros(0, np.int64)
            hd = ix if unit else (_words(head, csr_rows, ctypes.c_int32) if csr_rows
                                  else np.zeros(0, np.int64))
            lg = _words(longs, nlong, ctypes.c_int32) if nlong else np.zeros(0, np.int32)
            lens = np.diff(bounds)
            assert np.array_equal(lg, np.flatnonzero(lens > long_len)), "longs: the long rows"
            ms.append(dict(ptr=bounds, idx=ix.astype(np.int64), head=hd.astype(np.int64),
                           coef=coef + 4 * lo * ci, longs=lg, out=out, csr_rows=csr_rows,
                           nlong=nlong, unit=unit, long_len=long_len, ck=ck, cl=cl, ci=ci))
        vec = 4 if vector_path(ms, blocks, n, lo) else 1
        launch = Launch(ms, blocks, primes, mu, L, rows, n, bool(slot_major), vec)
        grid = min(self.ctas, launch.items)
        for b in range(grid):
            launch.cta(b, grid)
        for m, o, wr in zip(ms, launch.outs, launch.written):
            assert (wr == 1).all(), "every output word written once"
            _words(m["out"], rows * L * n)[:] = o.astype(np.uint32)
        self.calls.append(("spmv", nmats, rows, n, bool(slot_major), vec,
                           sum(m["nlong"] for m in ms), grid))
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


def lib(ctas: int = 5) -> _Lib:
    """The library over host memory, `spmv` walking `ctas` persistent CTAs
    (the card starts its resident ones; no result depends on the count)."""
    return _Lib(ctas)
