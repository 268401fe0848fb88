"""The port's coefficient-sharded NTT (ringsnark_tpu_torch.parallel.ntt_sharded)
on gloo ranks against the JAX package's sharded_ntt on the virtual 8-device
CPU mesh, and the unscaled cyclic inverse (``cyclic_intt_nat(scale=False)``)
on the twin and in the numpy replays of both kernel routes against JAX's.
Every comparison is exact (==).

The ranks (tests/torch_parallel_worker.py) are spawned once per world size
D in {2, 4, 8}; each returns its coefficient block of every transform, and
the blocks in rank order must be JAX's sharded result."""

from functools import lru_cache

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import ntt_replay
import torch_parallel_worker
from ringsnark_tpu.ops import ntt as jntt
from ringsnark_tpu.ops import primes as pr
from ringsnark_tpu.parallel.ntt_sharded import make_sharded_ntt as jmake_sharded_ntt
from ringsnark_tpu.parallel.ntt_sharded import sharded_ntt as jsharded_ntt
from ringsnark_tpu_torch.ops import ntt as tntt


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


def _residues(ps, M, batch, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.integers(0, q, M, dtype=np.uint64) for q in ps])
                     for _ in range(batch)]).astype(np.uint32)  # [batch, L, M]


# ---------------------------------------------------------------------------
# the sharded transform, D ranks (tests/test_ntt_sharded.py's shapes)
# ---------------------------------------------------------------------------

M, L, BATCH = 64, 2, 3


@lru_cache(maxsize=None)
def _spawned(D: int):
    """(x, JAX's sharded results, the ranks' outputs) at M = 64, L = 2,
    batch 3, on D ranks; on D = 8 also the (data 2, coeff 4) mesh at
    M = 128.  JAX's transforms run under jit on the virtual mesh."""
    ps = tuple(pr.find_ntt_primes(L, 2 * M))
    jplan = jntt.get_plan(ps, M, negacyclic=True)
    x = _residues(ps, M, BATCH, seed=0)
    mesh = Mesh(np.array(jax.devices()[:D]), ("coeff",))
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    inputs = {"primes": np.array(ps), "x": x}
    want = {}
    for nega in (False, True):
        y = (jntt.negacyclic_ntt_rev if nega else jntt.cyclic_ntt_rev)(jnp.asarray(x), jplan)
        inputs[f"y_{int(nega)}"] = np.asarray(y)
        fwd = jax.jit(jmake_sharded_ntt(jplan, mesh, negacyclic=nega))
        inv = jax.jit(jmake_sharded_ntt(jplan, mesh, negacyclic=nega, inverse=True))
        want[f"fwd_{int(nega)}"] = np.asarray(fwd(jax.device_put(jnp.asarray(x), sh)))
        want[f"inv_{int(nega)}"] = np.asarray(inv(jax.device_put(y, sh)))
    if D == 8:
        ps2 = tuple(pr.find_ntt_primes(2, 256))
        x2 = _residues(ps2, 128, 4, seed=9)
        plan2 = jntt.get_plan(ps2, 128, negacyclic=True)
        mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "coeff"))
        sp = P("data", None, "coeff")
        fwd2 = jax.jit(jmake_sharded_ntt(plan2, mesh2, negacyclic=True, spec=sp))
        want["mesh2_fwd"] = np.asarray(fwd2(jax.device_put(jnp.asarray(x2),
                                                           NamedSharding(mesh2, sp))))
        want["mesh2_x"] = x2
        inputs.update(primes2=np.array(ps2), x2=x2)
    return x, want, torch_parallel_worker.run(D, "ntt", inputs)


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda d: f"D{d}")
def sharded(request):
    return _spawned(request.param)


def _gathered(outs, key):
    return np.concatenate([o[key] for o in outs], axis=-1)


@pytest.mark.parametrize("negacyclic", [False, True], ids=["cyclic", "negacyclic"])
def test_sharded_forward_matches_jax(sharded, negacyclic):
    x, want, outs = sharded
    assert np.array_equal(_gathered(outs, f"fwd_{int(negacyclic)}"),
                          want[f"fwd_{int(negacyclic)}"])


@pytest.mark.parametrize("negacyclic", [False, True], ids=["cyclic", "negacyclic"])
def test_sharded_inverse_matches_jax_and_roundtrips(sharded, negacyclic):
    x, want, outs = sharded
    got = _gathered(outs, f"inv_{int(negacyclic)}")
    assert np.array_equal(got, want[f"inv_{int(negacyclic)}"])
    assert np.array_equal(got, x)
    assert np.array_equal(_gathered(outs, f"roundtrip_{int(negacyclic)}"), x)


def test_sharded_2d_mesh_matches_jax_and_roundtrips():
    """('data', 'coeff') = (2, 4) at M = 128 on the 8-rank world: batch rows
    over data, the coefficients over coeff; each rank's block of the
    forward is JAX's, and the round trip gives the block back."""
    _, want, outs = _spawned(8)
    for o in outs:
        rows, cols = slice(*o["mesh2_rows"]), slice(*o["mesh2_cols"])
        assert np.array_equal(o["mesh2_fwd"], want["mesh2_fwd"][rows, :, cols])
        assert np.array_equal(o["mesh2_roundtrip"], want["mesh2_x"][rows, :, cols])


# ---------------------------------------------------------------------------
# the unscaled cyclic inverse
# ---------------------------------------------------------------------------


def _jax_unscaled(x, ps):
    """JAX's unscaled cyclic inverse of x [batch, L, M] (under jit)."""
    plan = jntt.get_plan(ps, x.shape[-1])
    return np.asarray(jax.jit(lambda v: jntt.cyclic_intt_nat(v, plan, scale=False))(
        jnp.asarray(x)))


@pytest.mark.parametrize("M", [64, 1 << 10, 1 << 16])
def test_cyclic_intt_unscaled_matches_jax(M):
    ps = tuple(pr.find_ntt_primes(2, 2 * M))
    x = _residues(ps, M, 2, seed=M)
    want = _jax_unscaled(x, ps)
    plan = tntt.get_plan(ps, M)
    assert np.array_equal(_u(tntt.cyclic_intt_nat(_t(x), plan, scale=False)), want)
    scaled = _u(tntt.cyclic_intt_nat(_t(x), plan))
    minv = np.array([pow(M, p - 2, p) for p in ps], np.uint64)[:, None]
    assert np.array_equal(scaled, (want.astype(np.uint64) * minv % np.array(ps, np.uint64)[:, None])
                          .astype(np.uint32))


@pytest.mark.parametrize("order", ["row", "limb"])
def test_unscaled_inverse_replayed_shared_memory_route(order):
    """The shared-memory kernel's schedule with `scale` off (numpy replay of
    csrc/ntt.cu) equals JAX's unscaled inverse."""
    ps = tuple(pr.find_ntt_primes(3, 1 << 13))
    M = 1024
    x = _residues(ps, M, 3, seed=21)
    want = _jax_unscaled(x, ps)
    got = ntt_replay.ntt_kernel(x, ps, M, True, False, limb_major=order == "limb", scale=False)
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("size,mi", [(1024, 128), (4096, 128), (8192, 128)])
def test_unscaled_inverse_replayed_split_route(size, mi):
    """The split route with `scale` off (the outer kernel without its M^-1,
    after the unscaled inner pass; one outer pass, and two past R = 32)
    equals JAX's unscaled inverse, as does the plain split."""
    ps = tuple(pr.find_ntt_primes(2, 1 << 14))
    x = _residues(ps, size, 2, seed=size)
    want = _jax_unscaled(x, ps)
    got = ntt_replay.ntt_split(x, ps, size, mi, True, False, scale=False)
    assert np.array_equal(got.astype(np.uint32), want)
    plan = tntt.get_plan(ps, size)
    assert np.array_equal(_u(tntt.ntt_split_plain(_t(x), plan, True, False, mi=mi, scale=False)),
                          want)


@pytest.mark.parametrize("inverse,negacyclic", [(False, False), (False, True), (True, True)])
def test_unscaled_refused_outside_cyclic_inverse(inverse, negacyclic):
    """`scale=False` is the cyclic inverse's option: the dispatcher and the
    plain split refuse it for every other mode before they pick a route,
    as the CUDA wrappers do."""
    ps = tuple(pr.find_ntt_primes(2, 1 << 12))
    plan = tntt.get_plan(ps, 1024, negacyclic=True)
    x = _t(_residues(ps, 1024, 1, seed=5))
    with pytest.raises(ValueError, match="cyclic inverse only"):
        tntt._dispatch(x, plan, inverse, negacyclic, scale=False)
    with pytest.raises(ValueError, match="cyclic inverse only"):
        tntt.ntt_split_plain(x, plan, inverse, negacyclic, mi=128, scale=False)
