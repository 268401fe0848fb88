"""numpy replay of `ringsnark_tpu_torch/csrc/ntt.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their schedule on
the host with the kernels' own tables (`cuda_ntt._tables`,
`cuda_ntt._split_tables`), geometry (`cuda_ntt.geometry`), pass list
(`cuda_ntt.kernel_passes`) and shared-memory swizzle (`cuda_ntt.swizzle`),
in uint32 arithmetic (uint64 with a 32-bit mask): the CTA tiles and their
order, every thread's groups in every pass (`group_map`, `tile_address`),
the first pass's loads straight from device memory, the merged-psi
twiddle of every butterfly, the swizzled exchanges and which warp reads a
word another warp wrote (only across a CTA-wide barrier), the transposing
store (forward) and load (inverse) through a warp's own words, and the
split's factored outer twiddles.  The kernel exchanges no word by
shuffle: every exchange goes through shared memory.
"""

import numpy as np

from ringsnark_tpu_torch.ops import cuda_ntt

MASK = np.uint64(0xFFFFFFFF)
THREADS = cuda_ntt.MAX_THREADS


def host(t) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.uint64)


def shoup(a, w, p):
    """a * w mod p with the kernel's Shoup multiply; w [..., 2] pairs."""
    q = (a * w[..., 1]) >> np.uint64(32)
    r = (a * w[..., 0] - q * p) & MASK
    return np.where(r >= p, r - p, r)


def add(a, b, p):
    s = a + b
    return np.where(s >= p, s - p, s)


def sub(a, b, p):
    d = (a + p - b) & MASK
    return np.where(d >= p, d - p, d)


def log2(v: int) -> int:
    return v.bit_length() - 1


def group_map(geo, top: bool) -> np.ndarray:
    """[threads, iters] group of thread tid in its iteration it: the top
    pass (the one that touches device memory word by word) g = lane | warp
    << 5 | it << log2(threads), lanes on the low index bits; every other
    pass g = lane | it << 5 | warp << (5 + log2(iters)), a warp's groups in
    one region of the tile."""
    tid = np.arange(geo.threads)[:, None]
    it = np.arange(geo.iters)[None, :]
    lane, warp = tid & 31, tid >> 5
    if top:
        return lane | (warp << 5) | (it << log2(geo.threads))
    return lane | (it << 5) | (warp << (5 + log2(geo.iters)))


def tile_address(g, d: int, log_e: int, j):
    """Tile word of register j of group g in a pass at distance 2^d: the
    register bits d .. d + log_e - 1 inserted into g."""
    return ((g >> d) << (d + log_e)) | (g & ((1 << d) - 1)) | (j << d)


def region_log(geo) -> int:
    """log2 of a warp's words in the passes other than the top one."""
    return 5 + geo.log_e + log2(geo.iters)


def cta_wide(M: int) -> bool:
    """The top pass's exchange crosses warps (a __syncthreads in the kernel)."""
    return M > 1024


def transpose_words(geo):
    """[threads, chunks, 4] tile words a lane moves with its 16-byte
    accesses when a warp copies its region between shared and device
    memory in order (M >= 1024): chunk c = lane + 32 kk of the region at
    warp << region_log."""
    r = region_log(geo)
    tid = np.arange(geo.threads)
    lane, warp = tid & 31, tid >> 5
    c = lane[:, None] + 32 * np.arange(1 << (r - 7))[None, :]
    return (warp[:, None, None] << r) + 4 * c[..., None] + np.arange(4)


def smem_accesses(M: int) -> list:
    """(label, width in words, [instructions, 32] first words) of every
    warp access to shared memory, both directions: width 1 a word a lane,
    width 4 a 16-byte vector (the pass at d = 0 and the transposing copy)."""
    geo = cuda_ntt.geometry(M)
    log_m, T = log2(M), geo.threads
    out = []
    for d, _ in cuda_ntt.kernel_passes(M, False):
        top = d == log_m - geo.log_e
        a = tile_address(group_map(geo, top)[..., None], d, geo.log_e,
                         np.arange(1 << geo.log_e))  # [T, I, E]
        a = a.reshape(T // 32, 32, geo.iters, -1).transpose(0, 2, 3, 1)  # [warps, I, E, 32]
        if d == 0 and log_m > 5:
            out.append((f"pass d=0", 4, a[:, :, ::4].reshape(-1, 32)))
        else:
            out.append((f"pass d={d}", 1, a.reshape(-1, 32)))
    if log_m >= 10:
        w = transpose_words(geo)[..., 0]  # [T, chunks]
        out.append(("transpose", 4, w.reshape(T // 32, 32, -1).transpose(0, 2, 1).reshape(-1, 32)))
    return out


def ntt_kernel(x, primes, M, inverse, negacyclic, S=1, limb_major=False, scale=True):
    """`ntt_kernel` over x [rows, L, S, M] (or [rows, L, M] with S = 1)."""
    rows, L = x.shape[0], x.shape[1]
    nt = rows * L * S
    geo = cuda_ntt.geometry(M)
    log_m, log_e, T, I, tf = log2(M), geo.log_e, geo.threads, geo.iters, geo.tile_tf
    E = 1 << log_e
    tile_words = T * I * E
    assert tile_words == tf * M and T <= THREADS
    tiles = -(-nt // tf)
    s = np.arange(tiles * tf).reshape(tiles, tf)
    valid = s < nt
    t, limb = locate(np.where(valid, s, 0), rows, L, S, limb_major)
    assert np.array_equal(np.sort(t[valid]), np.arange(nt)), "every transform once"
    tb = cuda_ntt._tables(tuple(primes), M, inverse, negacyclic, "cpu")
    tw, consts = host(tb.tw), host(tb.consts)
    assert np.array_equal(consts[:, 0], np.array(primes, np.uint64))
    flat = x.reshape(-1, M).astype(np.uint64)
    src = flat[t]  # [tiles, tf, M]: the transforms of each tile
    out = np.zeros_like(src)
    smem = np.zeros((tiles, tile_words), np.uint64)
    writer = np.full(tile_words, -1)  # the warp that last wrote each shared word
    passes = cuda_ntt.kernel_passes(M, inverse)
    warp_of = (np.arange(T) >> 5)[:, None, None]  # [T, 1, 1]
    transposed = log_m >= 10
    first_words = None
    for q, (d, k) in enumerate(passes):
        first, last = q == 0, q == len(passes) - 1
        top = last if inverse else first
        g = group_map(geo, top)
        a = tile_address(g[..., None], d, log_e, np.arange(E))  # [T, I, E]
        assert np.array_equal(np.sort(a.ravel()), np.arange(tile_words)), "a pass covers the tile"
        tr, idx = a >> log_m, a & (M - 1)
        assert (tr == tr[..., :1]).all(), "a group lies in one transform"
        if I == 1:  # a thread keeps one transform of the tile in every pass
            assert (tr[..., 0] == (np.arange(T) >> (log_m - log_e))[:, None]).all()
        phys = cuda_ntt.swizzle(a)
        if first and transposed and inverse:
            # the warp's region, in order from device memory into its own words
            w = transpose_words(geo)
            smem[:, cuda_ntt.swizzle(w)] = src[:, w >> log_m, w & (M - 1)]
            writer[cuda_ntt.swizzle(w)] = (np.arange(T) >> 5)[:, None, None]
        if first and not (transposed and inverse):
            if top and M >= 1024:  # a warp's load of register j: 32 words in a row
                rowwise = idx.reshape(T // 32, 32, I, E)
                assert (np.diff(rowwise, axis=1) == 1).all(), "coalesced first load"
            v = src[:, tr, idx]  # [tiles, T, I, E], straight from device memory
            if not inverse and I > 1:  # groups after the first go through their own words
                assert not set(phys[:, 0].ravel()) & set(phys[:, 1:].ravel())
            first_words = [set(a[w * 32:(w + 1) * 32].ravel()) for w in range(T // 32)]
        else:
            if not (q == len(passes) - 1 and inverse and cta_wide(M)) and not (
                    q == 1 and not inverse and cta_wide(M)):
                assert (writer[phys] == warp_of).all(), "a warp reads only its own words"
            v = smem[:, phys]
        lg = limb[:, tr[..., 0]]  # [tiles, T, I]
        p = np.asarray(primes, np.uint64)[lg]
        hi = (M | idx[..., 0]) >> (d + log_e)  # [T, I]
        for e in (range(k) if inverse else range(k - 1, -1, -1)):
            jd = 1 << e
            root = inverse and d + e == log_m - 1
            for j in range(E):
                if j & jd:
                    continue
                if root:  # entry 1 holds M^-1, entry 0 the root's twiddle without it
                    wi = np.int64(1 if scale else 0)
                else:
                    wi = (hi << (log_e - 1 - e)) | (j >> (e + 1))
                w = tw[lg, wi]  # [tiles, T, I, 2]
                A, B = v[..., j].copy(), v[..., j + jd].copy()
                if inverse:
                    af = consts[lg][..., 1:3] if scale else consts[lg][..., 3:5]
                    v[..., j] = shoup(A + B, af, p) if root else add(A, B, p)
                    v[..., j + jd] = shoup(A + p - B, w, p)
                else:
                    m = shoup(B, w, p)
                    v[..., j], v[..., j + jd] = add(A, m, p), sub(A, m, p)
        if last and not (transposed and not inverse):
            if top and M >= 1024:
                rowwise = idx.reshape(T // 32, 32, I, E)
                assert (np.diff(rowwise, axis=1) == 1).all(), "coalesced last store"
            out[:, tr, idx] = v
        else:
            smem[:, phys] = v
            writer[phys] = warp_of
        if last and transposed and not inverse:
            # the warp's region, in order from its own words to device memory
            w = transpose_words(geo)
            assert (writer[cuda_ntt.swizzle(w)] == (np.arange(T) >> 5)[:, None, None]).all()
            out[:, w >> log_m, w & (M - 1)] = smem[:, cuda_ntt.swizzle(w)]
    if not cta_wide(M) and first_words is not None:  # no __syncthreads between tiles either
        r = region_log(geo)
        assert all(words == set(range(w << r, (w + 1) << r)) for w, words in
                   enumerate(first_words)), "a warp keeps its region from tile to tile"
    y = np.empty_like(flat)
    y[t[valid]] = out[valid]
    return y.reshape(x.shape)


def locate(s, rows, L, S, limb_major):
    """CTA order: transform sequence number s -> (transform t, limb)."""
    if limb_major:
        per_limb = rows * S
        limb, j = s // per_limb, s % per_limb
        return ((j // S) * L + limb) * S + j % S, limb
    return s, (s // S) % L


def outer_pass(v, primes, log_r, i0, k, inverse, negacyclic, st, scale=True):
    """One `outer_kernel` pass, stages i0 .. i0 + k - 1 (factored twiddles),
    on v [rows, L, R, mi], indexed as the kernel's threads index it: thread
    (hi, lo) of a column holds rows r(m) = (hi << (log_r - i0)) | (m <<
    log_lo) | lo.  The pass at i0 = 0 twists by psi first (forward) or scales
    last (inverse; the cyclic inverse not when `scale` is off)."""
    col, row, sc, consts = host(st.col), host(st.row), host(st.sc), host(st.consts)
    R, K = 1 << log_r, 1 << k
    log_lo = log_r - k - i0
    j = np.arange(R // K)
    lo = j & ((1 << log_lo) - 1)
    rows_m = (((j >> log_lo) << (log_r - i0)) | lo)[:, None] + (np.arange(K) << log_lo)
    assert np.array_equal(np.sort(rows_m.ravel()), np.arange(R)), "a pass covers every row"
    p = np.asarray(primes, np.uint64)[:, None, None]  # [L, 1, 1] against [rows, L, J, mi]
    v = [v[:, :, rows_m[:, m], :] for m in range(K)]
    edge = i0 == 0
    if negacyclic and not inverse and edge:
        v = [shoup(v[m], sc[:, rows_m[:, m]], p) for m in range(K)]
    for kk in range(k):
        e = k - 1 - kk if inverse else kk
        i, dl = i0 + e, K >> (e + 1)
        wc = col[:, i][:, None]  # [L, 1, mi, 2]
        for m in range(K):
            if (m & (2 * dl - 1)) >= dl:
                continue
            lo_i = ((m & (dl - 1)) << log_lo) | lo  # [J]
            wr = row[:, i, lo_i][:, :, None]  # [L, J, 1, 2]
            nz = (lo_i != 0)[:, None]
            a = v[m]
            if inverse:
                mm = shoup(v[m + dl], wc, p)
                mm = np.where(nz, shoup(mm, wr, p), mm)
                v[m], v[m + dl] = add(a, mm, p), sub(a, mm, p)
            else:
                t = shoup(sub(a, v[m + dl], p), wc, p)
                v[m], v[m + dl] = add(a, v[m + dl], p), np.where(nz, shoup(t, wr, p), t)
    if inverse and edge and (negacyclic or scale):
        v = [shoup(v[m], sc[:, rows_m[:, m]], p) if negacyclic
             else shoup(v[m], consts[:, None, None, 1:3], p) for m in range(K)]
    n, L, _, mi = v[0].shape
    out = np.empty((n, L, R, mi), np.uint64)
    for m in range(K):
        out[:, :, rows_m[:, m], :] = v[m]
    return out


def ntt_split(x, primes, size, mi, inverse, negacyclic, limb_major=False, scale=True):
    """`ntt_split`: the outer kernel's passes (`cuda_ntt.outer_passes`) and
    `ntt_kernel` with S = R (inverse: unscaled inner first, then the outer
    passes)."""
    rows, L = x.shape[:2]
    R = size // mi
    log_r = R.bit_length() - 1
    st = cuda_ntt._split_tables(tuple(primes), size, mi, inverse, negacyclic, "cpu")
    v = x.reshape(rows, L, R, mi).astype(np.uint64)
    if inverse:
        v = ntt_kernel(v, primes, mi, True, False, R, limb_major, scale=False)
    for i0, k in cuda_ntt.outer_passes(log_r, inverse):
        v = outer_pass(v, primes, log_r, i0, k, inverse, negacyclic, st, scale)
    if not inverse:
        v = ntt_kernel(v, primes, mi, False, False, R, limb_major)
    return v.reshape(x.shape)
