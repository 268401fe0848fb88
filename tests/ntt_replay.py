"""numpy replay of `ringsnark_tpu_torch/csrc/ntt.cu`, for the CPU tests.

The kernels run only on the card; these functions repeat their schedule on
the host with the kernels' own tables (`cuda_ntt._tables`,
`cuda_ntt._split_tables`), geometry (`cuda_ntt.geometry`), pass list
(`cuda_ntt.kernel_passes`) and shared-memory swizzle (`cuda_ntt.swizzle`),
in uint32 arithmetic (uint64 with a 32-bit mask): the CTA tiles and their
order, every pass's register groups and twiddle indices, the swizzled
exchanges and the split's factored outer twiddles.
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


def run_passes(smem, M, tf, inverse, tw, limb, primes, twist=None, scale=None, minv=None):
    """`ntt_kernel`'s passes on n tiles of tf transforms held in smem
    [n, tf * M] (physical words, updated in place).  limb: [n, tf].  The
    last pass returns [n, tf, M] (logical order), scaled by `scale`
    ([L, M, 2]) or `minv` ([L, 2])."""
    log_m = M.bit_length() - 1
    log_e = min(4, log_m)
    E, G, log_g = 1 << log_e, M >> log_e, log_m - log_e
    gi = np.arange(tf * G)
    tr, g = gi >> log_g, gi & (G - 1)
    lg = limb[:, tr]  # [n, groups]
    p = np.asarray(primes, np.uint64)[lg][..., None]  # [n, groups, 1]
    passes = cuda_ntt.kernel_passes(M, inverse)
    out = np.zeros((smem.shape[0], tf, M), np.uint64)
    for q, (log_d, e_lo) in enumerate(passes):
        lo = g & ((1 << log_d) - 1)
        base = ((g >> log_d) << (log_d + log_e)) | lo
        idx = base[:, None] + (np.arange(E) << log_d)[None, :]  # [groups, E]
        addr = (tr << log_m)[:, None] + idx
        assert np.array_equal(np.sort(addr.ravel()), np.arange(tf * M)), "a pass covers the tile"
        phys = cuda_ntt.swizzle(addr)
        v = smem[:, phys]  # [n, groups, E]
        if q == 0 and twist is not None:
            v = shoup(v, twist[lg[..., None], idx[None]], p)
        exps = range(e_lo, log_e) if inverse else range(log_e - 1, e_lo - 1, -1)
        for e in exps:
            jd = 1 << e
            d = jd << log_d
            for m in range(jd):
                w = tw[lg, d + lo + (m << log_d)][:, :, None, :]  # [n, groups, 1, 2]
                j = np.arange(m, E, 2 * jd)
                a, b = v[..., j], v[..., j + jd]
                if inverse:
                    mm = shoup(b, w, p)
                    v[..., j], v[..., j + jd] = add(a, mm, p), sub(a, mm, p)
                else:
                    v[..., j], v[..., j + jd] = add(a, b, p), shoup(sub(a, b, p), w, p)
        if q == len(passes) - 1:
            if scale is not None:
                v = shoup(v, scale[lg[..., None], idx[None]], p)
            elif minv is not None:
                v = shoup(v, minv[lg][:, :, None, :], p)
            out[:, tr[:, None], idx] = v
        else:
            smem[:, phys] = v
    return out


def locate(s, rows, L, S, limb_major):
    """CTA order: transform sequence number s -> (transform t, limb)."""
    if limb_major:
        per_limb = rows * S
        limb, j = s // per_limb, s % per_limb
        return ((j // S) * L + limb) * S + j % S, limb
    return s, (s // S) % L


def ntt_kernel(x, primes, M, inverse, negacyclic, S=1, limb_major=False, scale=True):
    """`ntt_kernel` over x [rows, L, S, M] (or [rows, L, M] with S = 1)."""
    rows, L = x.shape[0], x.shape[1]
    nt = rows * L * S
    geo = cuda_ntt.geometry(M)
    tf = geo.tile_tf
    assert geo.threads <= tf * (M >> geo.log_e) and geo.threads <= THREADS
    tiles = -(-nt // tf)
    s = np.arange(tiles * tf).reshape(tiles, tf)
    valid = s < nt
    t, limb = locate(np.where(valid, s, 0), rows, L, S, limb_major)
    assert np.array_equal(np.sort(t[valid]), np.arange(nt)), "every transform once"
    tb = cuda_ntt._tables(tuple(primes), M, inverse, negacyclic, "cpu")
    tw, sc, consts = host(tb.tw), host(tb.sc), host(tb.consts)
    assert np.array_equal(consts[:, 0], np.array(primes, np.uint64))
    flat = x.reshape(-1, M).astype(np.uint64)
    idx = np.arange(tf * M)
    smem = np.zeros((tiles, tf * M), np.uint64)
    smem[:, cuda_ntt.swizzle(idx)] = flat[t].reshape(tiles, tf * M)[:, idx]
    res = run_passes(
        smem, M, tf, inverse, tw, limb, primes,
        twist=sc if negacyclic and not inverse else None,
        scale=sc if negacyclic and inverse else None,
        minv=consts[:, 1:3] if inverse and not negacyclic and scale else None)
    y = np.empty_like(flat)
    y[t[valid]] = res[valid]
    return y.reshape(x.shape)


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
