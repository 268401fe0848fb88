"""The split large-M NTT of ringsnark_tpu_torch against the JAX package, on
the CPU, bit for bit:

* ``ntt_split_plain`` against the JAX split path (``ntt_split_pallas`` in
  interpret mode) in all four modes, and against the full-size plain twin;
* ``get_split_tables`` against the JAX package's;
* the CUDA kernels' schedules and tables, through a numpy replay of
  ``csrc/ntt.cu`` (``tests/ntt_replay.py``): ``outer_kernel`` with
  factored twiddles, then ``ntt_kernel`` over the ``[B, L, R, Mi]`` view in
  both CTA orders (the kernels themselves run only on the card:
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ringsnark_tpu.ops import pallas_ntt as pntt
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu_torch.ops import cuda_ntt
from ringsnark_tpu_torch.ops import ntt as tntt

import ntt_replay

M, MI = 1024, 256
MODES = [(False, True), (True, True), (False, False), (True, False)]
IDS = ["negacyclic_fwd", "negacyclic_inv", "cyclic_fwd", "cyclic_inv"]


def _residues(primes, size, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.stack([rng.integers(0, q, size, dtype=np.uint64) for q in primes]) for _ in range(B)]
    ).astype(np.uint32)  # [B, L, size]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


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


@pytest.mark.parametrize("size,mi", [(64, 8), (4096, 256), (2048, 64), (4096, 32)])
def test_split_plain_equals_full_twin_other_ratios(size, mi):
    """R = 8, 16, 32, 128: the outer stages beyond the R = 4 of the JAX check."""
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
# numpy replay of csrc/ntt.cu (tests/ntt_replay.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", cuda_ntt.CTA_ORDERS)
@pytest.mark.parametrize("inverse,negacyclic", MODES, ids=IDS)
def test_split_kernels_replayed_match_twin(inverse, negacyclic, order):
    """ntt_split replayed on the host gives the full-size twin's output:
    the outer kernel with factored twiddles, then the shared-memory kernel
    with S = R in this CTA order (inverse: that kernel unscaled first)."""
    size, mi = 1024, 128
    ps = tuple(find_ntt_primes(3, 1 << 13))
    x = _residues(ps, size, 3, seed=11)
    plan = tntt.get_plan(ps, size, negacyclic=negacyclic)
    want = _u32(tntt.PLAIN_TWINS[(inverse, negacyclic)](_t(x), plan))
    got = ntt_replay.ntt_split(x, ps, size, mi, inverse, negacyclic, order == "limb")
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("size,mi", [(256, 128), (512, 128), (2048, 128), (4096, 128)])
def test_split_ratios_replayed_match_twin(size, mi):
    """The split at R = 2, 4, 16 and 32 (R = 8 is the test above's): every
    outer kernel, all four modes."""
    ps = tuple(find_ntt_primes(2, 1 << 13))
    x = _residues(ps, size, 2, seed=size)
    for inverse, nega in MODES:
        plan = tntt.get_plan(ps, size, negacyclic=nega)
        want = _u32(tntt.PLAIN_TWINS[(inverse, nega)](_t(x), plan))
        got = ntt_replay.ntt_split(x, ps, size, mi, inverse, nega)
        assert np.array_equal(got.astype(np.uint32), want), (inverse, nega)


def test_factored_outer_twiddles_equal_positioned_table():
    """col[i, c] * row[i, lo] is the JAX package's positioned b-row twiddle
    w^(2^i (lo Mi + c)) of `get_split_tables`, forward and inverse."""
    ps = tuple(find_ntt_primes(2, 1 << 13))
    size, mi = 2048, 64
    R, s = size // mi, (size // mi).bit_length() - 1
    ref = tntt.get_split_tables(ps, size, mi, negacyclic=False)
    for inverse in (False, True):
        st = cuda_ntt._split_tables(ps, size, mi, inverse, False, "cpu")
        col, row = ntt_replay.host(st.col), ntt_replay.host(st.row)
        pos = np.asarray(ref.inv_tw if inverse else ref.fwd_tw).astype(np.uint64)
        for l, p in enumerate(ps):
            for i in range(s):
                d = R >> (i + 1)
                for r in range(R):
                    if r & d:  # a b-row of stage i
                        prod = col[l, i, :, 0] * row[l, i, r & (d - 1), 0] % np.uint64(p)
                        assert np.array_equal(prod, pos[l, i, r]), (inverse, l, i, r)
        assert np.array_equal(col[..., 1], (col[..., 0] << np.uint64(32))
                              // np.asarray(ps, np.uint64)[:, None, None])


@pytest.mark.parametrize("inverse,negacyclic", MODES, ids=IDS)
def test_limb_major_cta_order_replayed_matches_twin(inverse, negacyclic):
    """The shared-memory kernel alone on [B, L, M] in limb-major CTA order."""
    ps = tuple(find_ntt_primes(3, 1 << 12))
    x = _residues(ps, 256, 5, seed=3)
    got = ntt_replay.ntt_kernel(x, ps, 256, inverse, negacyclic, limb_major=True)
    plan = tntt.get_plan(ps, 256, negacyclic=negacyclic)
    want = _u32(tntt.PLAIN_TWINS[(inverse, negacyclic)](_t(x), plan))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("size,mi", [(8192, 128), (4096, 16), (16384, 8)])
def test_split_passes_replayed_match_twin(size, mi):
    """R = 64, 256 and 2048: the outer stages in two and three passes of at
    most five (3 + 3, 4 + 4, 4 + 4 + 3), all four modes, in both CTA
    orders of the inner kernel; the plain split equals the twin there too."""
    ps = tuple(find_ntt_primes(2, 1 << 15))
    x = _residues(ps, size, 2, seed=size + mi)
    log_r = (size // mi).bit_length() - 1
    assert len(cuda_ntt.outer_passes(log_r, False)) == (2 if log_r < 11 else 3)
    for n, (inverse, nega) in enumerate(MODES):
        plan = tntt.get_plan(ps, size, negacyclic=nega)
        want = tntt.PLAIN_TWINS[(inverse, nega)](_t(x), plan)
        got = ntt_replay.ntt_split(x, ps, size, mi, inverse, nega, limb_major=n % 2 == 1)
        assert np.array_equal(got.astype(np.uint32), _u32(want)), (inverse, nega)
        assert torch.equal(tntt.ntt_split_plain(_t(x), plan, inverse, nega, mi=mi), want)


def test_outer_passes_cover_the_stages_in_order():
    """Passes of at most five stages, as even as possible, covering stages
    0 .. log_r - 1 once each, in order (the inverse in reverse); one pass up
    to R = 32 (the kernel's earlier single pass)."""
    for log_r in range(1, 17):
        fwd = cuda_ntt.outer_passes(log_r, False)
        assert fwd == cuda_ntt.outer_passes(log_r, True)[::-1]
        assert [i for i0, k in fwd for i in range(i0, i0 + k)] == list(range(log_r))
        assert all(1 <= k <= 5 for _, k in fwd)
        assert max(k for _, k in fwd) - min(k for _, k in fwd) <= 1
        assert len(fwd) == -(-log_r // 5)
    assert cuda_ntt.outer_passes(6, False) == [(0, 3), (3, 3)]


def test_split_route_refuses_what_it_cannot_take():
    """The dispatcher's routing is decided before any launch: every power of
    two above 2^15 takes the split (inner size 16384 up to 2^19, 32768
    above), and a tensor on no supported device has no route.  (The
    launches themselves are tested on the card.)"""
    assert tntt.MAX_KERNEL_M == 32768 and tntt.SPLIT_MI == 16384
    assert [tntt.split_mi(1 << k) for k in range(16, 24)] == [16384] * 4 + [32768] * 4
    plan = tntt.get_plan(tuple(find_ntt_primes(1, 1 << 21)), 1 << 20)
    x = torch.empty((1, 1, 1 << 20), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no NTT route"):
        tntt.cyclic_ntt_rev(x, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ntt.ntt_split(torch.zeros((1, 1, 1 << 20), dtype=torch.int32), plan, False, False)
