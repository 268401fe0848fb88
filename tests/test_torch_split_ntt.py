"""The split large-M NTT of ringsnark_tpu_torch against the JAX package, on
the CPU, bit for bit:

* ``ntt_split_plain`` against the JAX split path (``ntt_split_pallas`` in
  interpret mode) in all four modes, and against the full-size plain twin;
* ``get_split_tables`` against the JAX package's;
* the CUDA kernels' index arithmetic and tables, through a numpy replay of
  ``csrc/ntt.cu``'s ``outer_kernel`` and of ``ntt_kernel`` over the
  ``[B, L, R, Mi]`` view in both CTA orders (the kernels themselves run
  only on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ringsnark_tpu.ops import pallas_ntt as pntt
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu_torch.ops import cuda_ntt
from ringsnark_tpu_torch.ops import ntt as tntt

M, MI = 1024, 256
MODES = [(False, True), (True, True), (False, False), (True, False)]
IDS = ["negacyclic_fwd", "negacyclic_inv", "cyclic_fwd", "cyclic_inv"]
MASK = np.uint64(0xFFFFFFFF)


def _residues(primes, size, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.stack([rng.integers(0, q, size, dtype=np.uint64) for q in primes]) for _ in range(B)]
    ).astype(np.uint32)  # [B, L, size]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.uint64)


@pytest.fixture(scope="module")
def primes():
    return tuple(find_ntt_primes(2, 1 << 15))


@pytest.fixture(scope="module")
def jax_split(primes):
    """The JAX split path in interpret mode, all four modes, one input."""
    x = _residues(primes, M, 8, seed=7)
    tables = pntt.get_split_tables(primes, M, MI)
    out = {}
    for inverse, nega in MODES:
        out[(inverse, nega)] = np.asarray(pntt.ntt_split_pallas(
            jnp.asarray(x), tables, 8, inverse=inverse, negacyclic=nega, interpret=True))
    return x, out


@pytest.mark.parametrize("inverse,negacyclic", MODES, ids=IDS)
def test_split_plain_matches_jax_split_and_full_twin(primes, jax_split, inverse, negacyclic):
    x, want = jax_split
    plan = tntt.get_plan(primes, M, negacyclic=negacyclic)
    got = tntt.ntt_split_plain(_t(x), plan, inverse, negacyclic, mi=MI)
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), want[(inverse, negacyclic)])
    assert torch.equal(got, tntt.PLAIN_TWINS[(inverse, negacyclic)](_t(x), plan))
    back = tntt.ntt_split_plain(got, plan, not inverse, negacyclic, mi=MI)
    assert np.array_equal(_u32(back), x)


@pytest.mark.parametrize("size,mi", [(64, 8), (4096, 256), (2048, 64)])
def test_split_plain_equals_full_twin_other_ratios(size, mi):
    """R = 8, 16, 32: the outer stages beyond the R = 4 of the JAX check."""
    ps = tuple(find_ntt_primes(3, 1 << 13))
    x = _t(_residues(ps, size, 2, seed=size))
    for inverse, nega in MODES:
        plan = tntt.get_plan(ps, size, negacyclic=nega)
        got = tntt.ntt_split_plain(x, plan, inverse, nega, mi=mi)
        assert torch.equal(got, tntt.PLAIN_TWINS[(inverse, nega)](x, plan)), (inverse, nega)


def test_split_tables_match_jax(primes):
    want = pntt.get_split_tables(primes, M, MI)
    got = tntt.get_split_tables(primes, M, MI)
    for name in ("fwd_tw", "fwd_tw_sh", "inv_tw", "inv_tw_sh", "psi", "psi_sh",
                 "psiinv_s", "psiinv_s_sh"):
        assert np.array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(want, name))), name
    assert tuple(int(v) for v in got.minv) == tuple(int(v) for v in want.minv)
    assert tuple(int(v) for v in got.minv_sh) == tuple(int(v) for v in want.minv_sh)
    cyc = tntt.get_split_tables(primes, M, MI, negacyclic=False)
    assert cyc.psi is None and np.array_equal(cyc.fwd_tw, got.fwd_tw)


# ---------------------------------------------------------------------------
# numpy replay of csrc/ntt.cu
# ---------------------------------------------------------------------------


def _shoup(a, w, w_sh, p):
    q = (a * w_sh) >> np.uint64(32)
    r = (a * w - q * p) & MASK
    return np.where(r >= p, r - p, r)


def _add(a, b, p):
    s = a + b
    return np.where(s >= p, s - p, s)


def _sub(a, b, p):
    d = (a + p - b) & MASK
    return np.where(d >= p, d - p, d)


def _replay_ntt_kernel(x, primes, size, inverse, negacyclic, S, limb_major, scale):
    """`ntt_kernel` over x [rows, L, S, size]: CTA g -> (limb, transform t)
    as the kernel computes them, then its stages on each CTA's polynomial."""
    rows, L = x.shape[0], x.shape[1]
    tb = cuda_ntt._tables(primes, size, inverse, negacyclic, "cpu")
    tw, tw_sh, sc, sc_sh, consts = (_host(t) for t in (tb.tw, tb.tw_sh, tb.sc, tb.sc_sh,
                                                       tb.consts))
    g = np.arange(rows * L * S)
    if limb_major:
        per_limb = rows * S
        limb, j = g // per_limb, g % per_limb
        t = ((j // S) * L + limb) * S + j % S
    else:
        limb, t = (g // S) % L, g
    assert np.array_equal(np.sort(t), g), "CTAs must cover every transform once"
    flat = x.reshape(-1, size).astype(np.uint64)
    buf, p = flat[t], consts[limb, 0:1]
    if negacyclic and not inverse:
        buf = _shoup(buf, sc[limb], sc_sh[limb], p)
    log_m = size.bit_length() - 1
    j = np.arange(size // 2)
    for logd in (range(log_m) if inverse else range(log_m - 1, -1, -1)):
        d = 1 << logd
        k = j & (d - 1)
        i0 = ((j >> logd) << (logd + 1)) + k
        a, b = buf[:, i0], buf[:, i0 + d]
        w, w_sh = tw[limb][:, d + k], tw_sh[limb][:, d + k]
        if inverse:
            m = _shoup(b, w, w_sh, p)
            buf[:, i0], buf[:, i0 + d] = _add(a, m, p), _sub(a, m, p)
        else:
            buf[:, i0], buf[:, i0 + d] = _add(a, b, p), _shoup(_sub(a, b, p), w, w_sh, p)
    if inverse and negacyclic:
        buf = _shoup(buf, sc[limb], sc_sh[limb], p)
    elif inverse and scale:
        buf = _shoup(buf, consts[limb, 1:2], consts[limb, 2:3], p)
    out = np.empty_like(flat)
    out[t] = buf
    return out.reshape(x.shape)


def _replay_outer_kernel(x, primes, size, mi, inverse, negacyclic):
    """`outer_kernel` over x [rows, L, R, mi]: every (row, limb, column)
    thread's R registers at once."""
    R, s = size // mi, (size // mi).bit_length() - 1
    ot = cuda_ntt._outer_tables(primes, size, mi, inverse, negacyclic, "cpu")
    tw, tw_sh, sc, sc_sh, consts = (_host(t) for t in (ot.tw, ot.tw_sh, ot.sc, ot.sc_sh,
                                                       ot.consts))
    p = consts[:, 0][:, None]  # [L, 1] against v[r]: [rows, L, mi]
    v = [x[:, :, r, :].astype(np.uint64) for r in range(R)]
    if negacyclic and not inverse:
        v = [_shoup(v[r], sc[:, r], sc_sh[:, r], p) for r in range(R)]
    stages = range(s - 1, -1, -1) if inverse else range(s)
    for i in stages:
        d = R >> (i + 1)
        for r in range(R):
            if (r & (2 * d - 1)) < d:
                w, w_sh = tw[:, i, r + d], tw_sh[:, i, r + d]
                a = v[r]
                if inverse:
                    m = _shoup(v[r + d], w, w_sh, p)
                    v[r], v[r + d] = _add(a, m, p), _sub(a, m, p)
                else:
                    v[r], v[r + d] = _add(a, v[r + d], p), _shoup(_sub(a, v[r + d], p), w, w_sh, p)
    if inverse:
        v = [_shoup(v[r], sc[:, r], sc_sh[:, r], p) if negacyclic
             else _shoup(v[r], consts[:, 1:2], consts[:, 2:3], p) for r in range(R)]
    return np.stack(v, axis=2)


@pytest.mark.parametrize("order", cuda_ntt.CTA_ORDERS)
@pytest.mark.parametrize("inverse,negacyclic", MODES, ids=IDS)
def test_split_kernels_replayed_match_twin(inverse, negacyclic, order):
    """ntt_split's two launches (outer kernel, then the shared-memory kernel
    with S = R, unscaled when inverse) replayed on the host give the
    full-size twin's output."""
    size, mi = 1024, 128
    R = size // mi
    ps = tuple(find_ntt_primes(3, 1 << 13))
    x = _residues(ps, size, 3, seed=11)
    xr = x.reshape(3, 3, R, mi)
    lm = order == "limb"
    if not inverse:
        mid = _replay_outer_kernel(xr, ps, size, mi, False, negacyclic)
        got = _replay_ntt_kernel(mid, ps, mi, False, False, R, lm, True)
    else:
        mid = _replay_ntt_kernel(xr, ps, mi, True, False, R, lm, False)
        got = _replay_outer_kernel(mid, ps, size, mi, True, negacyclic)
    plan = tntt.get_plan(ps, size, negacyclic=negacyclic)
    want = _u32(tntt.PLAIN_TWINS[(inverse, negacyclic)](_t(x), plan))
    assert np.array_equal(got.reshape(x.shape).astype(np.uint32), want)


@pytest.mark.parametrize("inverse,negacyclic", MODES, ids=IDS)
def test_limb_major_cta_order_replayed_matches_twin(inverse, negacyclic):
    """The shared-memory kernel alone on [B, L, M] in limb-major CTA order."""
    ps = tuple(find_ntt_primes(3, 1 << 12))
    x = _residues(ps, 256, 5, seed=3)
    got = _replay_ntt_kernel(x[:, :, None, :], ps, 256, inverse, negacyclic, 1, True, True)
    plan = tntt.get_plan(ps, 256, negacyclic=negacyclic)
    want = _u32(tntt.PLAIN_TWINS[(inverse, negacyclic)](_t(x), plan))
    assert np.array_equal(got[:, :, 0].astype(np.uint32), want)


def test_split_route_refuses_what_it_cannot_take():
    """The dispatcher's routing is decided before any launch: a CUDA tensor
    above 2^19 has no route.  (The launches themselves are tested on the card.)"""
    assert tntt.MAX_KERNEL_M == 32768 and tntt.SPLIT_MI == 16384
    assert tntt.MAX_SPLIT_M == 1 << 19
    plan = tntt.get_plan(tuple(find_ntt_primes(1, 1 << 21)), 1 << 20)
    x = torch.empty((1, 1, 1 << 20), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no NTT route"):
        tntt.cyclic_ntt_rev(x, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ntt.ntt_split(torch.zeros((1, 1, 1 << 20), dtype=torch.int32), plan, False, False)
