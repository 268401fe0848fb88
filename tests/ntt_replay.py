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


def _outer(v, primes, size, mi, inverse, negacyclic, st):
    """`outer_stages` (factored twiddles) on v [..., L, R, mi], plus the psi
    twist before (forward) or the scale after (inverse)."""
    R, s = size // mi, (size // mi).bit_length() - 1
    col, row, sc, consts = host(st.col), host(st.row), host(st.sc), host(st.consts)
    p = np.asarray(primes, np.uint64)[:, None]  # [L, 1] against v[..., r, :]
    v = [v[..., r, :] for r in range(R)]
    if negacyclic and not inverse:
        v = [shoup(v[r], sc[:, r], p) for r in range(R)]
    for i in (range(s - 1, -1, -1) if inverse else range(s)):
        d = R >> (i + 1)
        wc = col[:, i]  # [L, mi, 2]
        for r in range(R):
            if (r & (2 * d - 1)) >= d:
                continue
            lo = r & (d - 1)
            wr = row[:, i, lo][:, None, :]
            a = v[r]
            if inverse:
                m = shoup(v[r + d], wc, p)
                m = shoup(m, wr, p) if lo else m
                v[r], v[r + d] = add(a, m, p), sub(a, m, p)
            else:
                t = shoup(sub(a, v[r + d], p), wc, p)
                v[r], v[r + d] = add(a, v[r + d], p), (shoup(t, wr, p) if lo else t)
    if inverse:
        v = [shoup(v[r], sc[:, r], p) if negacyclic else shoup(v[r], consts[:, None, 1:3], p)
             for r in range(R)]
    return np.stack(v, axis=-2)


def split_two_pass(x, primes, size, mi, inverse, negacyclic, limb_major=False):
    """`ntt_split` on its two-pass path: outer kernel + `ntt_kernel` with
    S = R (inverse: unscaled inner, then the outer kernel)."""
    rows, L = x.shape[:2]
    R = size // mi
    st = cuda_ntt._split_tables(tuple(primes), size, mi, inverse, negacyclic, "cpu")
    xr = x.reshape(rows, L, R, mi).astype(np.uint64)
    if not inverse:
        mid = _outer(xr, primes, size, mi, False, negacyclic, st)
        out = ntt_kernel(mid, primes, mi, False, False, R, limb_major)
    else:
        mid = ntt_kernel(xr, primes, mi, True, False, R, limb_major, scale=False)
        out = _outer(mid, primes, size, mi, True, negacyclic, st)
    return out.reshape(x.shape)
