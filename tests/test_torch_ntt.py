"""ringsnark_tpu_torch NTT: the plain twins and the kernel's tables against
the JAX package, on the CPU, bit for bit.

* the four plain PyTorch transforms against `ringsnark_tpu.ops.ntt` (its
  XLA path on the CPU) and against the Pallas kernels in interpret mode;
* the CUDA kernel's tables, register passes and swizzled exchanges,
  through a numpy replay of `csrc/ntt.cu`'s schedule (`tests/ntt_replay.py`;
  the kernel itself runs only on the card: `tests/test_torch_cuda.py` and
  `chip_smoke.py`);
* int64 modular arithmetic with p just under 2^31;
* `import ringsnark_tpu_torch` keeps jax out of `sys.modules`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu.ops import ntt as jntt
from ringsnark_tpu.ops import pallas_ntt as pntt
from ringsnark_tpu.ops.modops import mul_mod as jmul_mod
from ringsnark_tpu.ops.primes import find_ntt_primes, make_prime
from ringsnark_tpu_torch.ops import cuda_ntt, modops
from ringsnark_tpu_torch.ops import ntt as tntt

import ntt_replay

MODES = ["cyclic_fwd", "cyclic_inv", "negacyclic_fwd", "negacyclic_inv"]
# jitted: one compile per shape instead of one per eager op
JAX_FN = {
    "cyclic_fwd": jax.jit(jntt.cyclic_ntt_rev, static_argnums=1),
    "cyclic_inv": jax.jit(jntt.cyclic_intt_nat, static_argnums=1),
    "negacyclic_fwd": jax.jit(jntt.negacyclic_ntt_rev, static_argnums=1),
    "negacyclic_inv": jax.jit(jntt.negacyclic_intt_nat, static_argnums=1),
}
PLAIN_FN = {
    "cyclic_fwd": tntt.cyclic_ntt_rev_plain,
    "cyclic_inv": tntt.cyclic_intt_nat_plain,
    "negacyclic_fwd": tntt.negacyclic_ntt_rev_plain,
    "negacyclic_inv": tntt.negacyclic_intt_nat_plain,
}
PALLAS_FN = {
    "cyclic_fwd": pntt.cyclic_ntt_rev_pallas,
    "cyclic_inv": pntt.cyclic_intt_nat_pallas,
    "negacyclic_fwd": pntt.negacyclic_ntt_rev_pallas,
    "negacyclic_inv": pntt.negacyclic_intt_nat_pallas,
}


def _residues(primes, M, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.stack([rng.integers(0, q, M, dtype=np.uint64) for q in primes]) for _ in range(B)]
    ).astype(np.uint32)  # [B, L, M]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("M", [2, 256, 4096])
def test_plain_twin_matches_jax(M, L, mode):
    primes = tuple(find_ntt_primes(L, 1 << 13))
    plan = jntt.get_plan(primes, M, negacyclic=mode.startswith("nega"))
    x = _residues(primes, M, 3, seed=M + L)
    want = np.asarray(JAX_FN[mode](jnp.asarray(x), plan))
    tplan = tntt.get_plan(primes, M, negacyclic=mode.startswith("nega"))
    got = PLAIN_FN[mode](_t(x), tplan)
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), want)
    # the dispatcher sends a CPU tensor to the same twin
    fwd_or_inv = getattr(tntt, JAX_FN[mode].__wrapped__.__name__)
    assert torch.equal(fwd_or_inv(_t(x), tplan), got)


@pytest.mark.parametrize("mode", MODES)
def test_plain_twin_matches_pallas_interpret(mode):
    M = 256
    primes = tuple(find_ntt_primes(2, 1 << 12))
    tables = pntt.get_pallas_tables(primes, M)
    x = _residues(primes, M, 8, seed=5)
    want = np.asarray(PALLAS_FN[mode](jnp.asarray(x), tables, 8, interpret=True))
    got = PLAIN_FN[mode](_t(x), tntt.get_plan(primes, M, negacyclic=mode.startswith("nega")))
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [2, 64, 2048])
def test_kernel_tables_replayed_match_twin(M, mode):
    """The kernel's tables, tiles, register passes, swizzled exchanges and
    Shoup arithmetic give the twin's output (replayed on the host; the card
    runs the same schedule)."""
    inverse, nega = mode.endswith("inv"), mode.startswith("nega")
    primes = tuple(find_ntt_primes(3, 1 << 12))
    x = _residues(primes, M, 2, seed=M)
    got = ntt_replay.ntt_kernel(x, primes, M, inverse, nega)
    want = _u32(PLAIN_FN[mode](_t(x), tntt.get_plan(primes, M, negacyclic=nega)))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [1 << k for k in range(1, 16)])
def test_kernel_replayed_every_size_matches_jax(M, mode):
    """Every size the kernel takes, 2 .. 32768, replayed from the wrapper's
    own tables and geometry (the merged-psi twiddles, the passes, each
    thread's groups, the first pass straight from device memory, the
    transposing copy) equals the JAX package's transform bit for bit, in
    both CTA orders, on a batch whose last tile is part-full; the cyclic
    inverse also without M^-1."""
    inverse, nega = mode.endswith("inv"), mode.startswith("nega")
    primes = tuple(find_ntt_primes(2, 2 * M))
    x = _residues(primes, M, 2 + 300 // M, seed=M + 7)
    want = np.asarray(JAX_FN[mode](jnp.asarray(x), jntt.get_plan(primes, M, negacyclic=nega)))
    for limb_major in (False, True):
        got = ntt_replay.ntt_kernel(x, primes, M, inverse, nega, limb_major=limb_major)
        assert np.array_equal(got.astype(np.uint32), want), limb_major
    if mode == "cyclic_inv":
        tplan = tntt.get_plan(primes, M)
        got = ntt_replay.ntt_kernel(x, primes, M, True, False, scale=False)
        unscaled = _u32(tntt.cyclic_intt_nat_plain(_t(x), tplan, scale=False))
        assert np.array_equal(got.astype(np.uint32), unscaled)
        p = np.asarray(primes, np.uint64)[:, None]
        assert np.array_equal(got * tplan.minv.astype(np.uint64) % p, want)


@pytest.mark.parametrize("mode", MODES)
def test_register_radix_replayed_at_16384(mode):
    """E = 32 at the main path's N' = 16384, one limb: the top pass of five
    stages straight from device memory, four more at distance 32 and five at
    distance 1, 256 threads of two groups each, one transform a tile."""
    inverse, nega = mode.endswith("inv"), mode.startswith("nega")
    M = 16384
    geo = cuda_ntt.geometry(M)
    assert (geo.log_e, geo.threads, geo.tile_tf, geo.iters, geo.min_ctas) == (5, 256, 1, 2, 2)
    assert cuda_ntt.kernel_passes(M, inverse) == (
        [(0, 5), (5, 4), (9, 5)] if inverse else [(9, 5), (5, 4), (0, 5)])
    primes = tuple(find_ntt_primes(1, 1 << 15))
    x = _residues(primes, M, 3, seed=16)
    got = ntt_replay.ntt_kernel(x, primes, M, inverse, nega)
    want = _u32(PLAIN_FN[mode](_t(x), tntt.get_plan(primes, M, negacyclic=nega)))
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("M", [1024, 2048, 4096, 8192, 16384, 32768])
def test_exchanges_free_of_bank_conflicts(M):
    """Every warp access to shared memory from M = 1024 up hits every bank
    once: a word a lane (32 distinct banks), or a 16-byte vector a lane
    (each quarter warp, which the card serves at once, on eight distinct
    aligned groups of four banks, the vector's words in a row); the swizzle
    is a permutation of each 32-word row and linear over GF(2), which the
    kernel's swz(a0) ^ swz(j << d) addressing relies on."""
    a = np.arange(M)
    assert np.array_equal(np.sort(cuda_ntt.swizzle(a).reshape(-1, 32), axis=1),
                          a.reshape(-1, 32))
    b = np.random.default_rng(M).integers(0, M, M)
    assert np.array_equal(cuda_ntt.swizzle(a ^ b), cuda_ntt.swizzle(a) ^ cuda_ntt.swizzle(b))
    labels = []
    for label, width, words in ntt_replay.smem_accesses(M):
        labels.append(label)
        phys = cuda_ntt.swizzle(words)
        if width == 1:
            assert all(len(set(w)) == 32 for w in phys & 31), (M, label)
            continue
        for k in range(4):  # a vector's words stay in a row
            assert np.array_equal(cuda_ntt.swizzle(words + k), phys + k), (M, label)
        quarters = (phys >> 2).reshape(-1, 4, 8) & 7
        assert all(len(set(q)) == 8 for q in quarters.reshape(-1, 8)), (M, label)
    assert labels[-1] == "transpose" and "pass d=0" in labels


def test_modops_near_2_31():
    p = (1 << 31) - 1  # the largest prime below 2^31
    assert make_prime(p).value == p
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.integers(0, p, 500, dtype=np.uint64), [p - 1, p - 2, 0, 1]])
    b = np.concatenate([rng.integers(0, p, 500, dtype=np.uint64), [p - 1, p - 1, p - 1, 0]])
    ta, tb_ = _t(a.astype(np.uint32)), _t(b.astype(np.uint32))
    ai, bi = [int(v) for v in a], [int(v) for v in b]
    assert [int(v) for v in modops.mul_mod(ta, tb_, p)] == [x * y % p for x, y in zip(ai, bi)]
    assert [int(v) for v in modops.add_mod(ta, tb_, p)] == [(x + y) % p for x, y in zip(ai, bi)]
    assert [int(v) for v in modops.sub_mod(ta, tb_, p)] == [(x - y) % p for x, y in zip(ai, bi)]
    assert [int(v) for v in modops.neg_mod(ta, p)] == [(-x) % p for x in ai]
    assert [int(v) for v in modops.pow_mod(ta, 12345, p)] == [pow(x, 12345, p) for x in ai]
    nz = [x for x in ai if x]
    assert [int(v) for v in modops.inv_mod(_t(np.array(nz, np.uint32)), p)] == [
        pow(x, -1, p) for x in nz
    ]
    # and the JAX package's Barrett multiply agrees
    pr = make_prime(p)
    want = np.asarray(jmul_mod(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)),
                               np.uint32(p), np.uint64(pr.mu), np.uint32(pr.bits)))
    assert np.array_equal(_u32(modops.mul_mod(ta, tb_, p)), want)


def test_dispatch_never_falls_back_for_other_devices():
    plan = tntt.get_plan(tuple(find_ntt_primes(1, 1 << 12)), 256, negacyclic=True)
    x = torch.empty((2, 1, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no NTT route"):
        tntt.negacyclic_ntt_rev(x, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ntt.ntt(torch.zeros((2, 1, 256), dtype=torch.int32), plan, False, True)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import ringsnark_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import bench_torch\n"
        "bench = [m.name for m in pkgutil.walk_packages(bench_torch.__path__, 'bench_torch.')]\n"
        "for m in bench: importlib.import_module(m)\n"
        "assert len(mods) > 20 and len(bench) >= 6, (mods, bench)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'ringsnark_tpu.')) or m == 'ringsnark_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
