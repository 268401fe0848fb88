"""The port's multi-device layer (ringsnark_tpu_torch.parallel) on gloo ranks
against the JAX package on the virtual 8-device CPU mesh, in the env of
tests/test_parallel.py (ring L=2, N=8, N'=16, the toy circuit), exactly (==):

* ringGroth16 on (limb 2 x data 2) against JAX's ``groth16_prove_sharded``
  on ``make_mesh(4, limb=2)``, and on (limb 1 x coeff 2 x data 2) against
  JAX's single-device prover (JAX's coeff-mesh prover is held
  bit-identical to it by tests/test_parallel.py's slow tier);
* Rinocchio with ZK on, on (limb 2 x data 2), against JAX's single-device
  prover under the same numpy seed (JAX's sharded Rinocchio is held equal
  to it by the same slow tier);
* the data-sharded streamed chunk at N in {1, 8}, chunk 64, slab 8, D = 4,
  against JAX's ``stream_chunk_ip_sharded``;
* every rank returns the same proof, and the port's verifier accepts it.

The ranks (tests/torch_parallel_worker.py) are spawned once per mesh."""

from functools import lru_cache

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import torch_parallel_worker
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import keygen as jkeygen
from ringsnark_tpu.models import build_toy_circuit as jbuild_toy_circuit
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.parallel import groth16_prove_sharded as jgroth16_prove_sharded
from ringsnark_tpu.parallel import make_mesh as jmake_mesh
from ringsnark_tpu.parallel import stream_chunk_ip_sharded as jstream_chunk_ip_sharded
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import rinocchio as jrin
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch.parallel import dryrun, make_mesh, mesh as pmesh

WORLD = 4
G16 = ("A", "B", "C")
RIN = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")
CHUNK, SLAB = 64, 8
MESHES = {"limb2_data2": (2, 1), "limb1_coeff2_data2": (1, 2)}


def _triple(e) -> tuple:
    return (np.asarray(e.c0).astype(np.uint32), np.asarray(e.c1).astype(np.uint32), e.level)


@lru_cache(maxsize=None)
def _jax_env():
    """tests/test_parallel.py's env."""
    ring = jdefault_context(L=2, N=8, order=1 << 12)
    inner, below = [], 1 << 31
    while len(inner) < 3:
        c = find_ntt_primes(1, 32, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    params = JSnarkParams(ring=ring, enc=JEncodingContext(ring=ring, n_inner=16,
                                                          inner_primes=tuple(inner)))
    rng = np.random.default_rng(31)
    pb = jbuild_toy_circuit(ring, rng, replicate=2)
    assert pb.is_satisfied()
    kp = jg16.generator(pb.get_constraint_system(), params, rng, jax.random.PRNGKey(300))
    return params, pb, kp


@lru_cache(maxsize=None)
def _stream_inputs():
    """tests/test_parallel.py's streamed chunk: rows and two plaintext
    batches drawn after the secret key from numpy seed 17, per ring N; and
    JAX's sharded result on a ("data",) mesh of 4."""
    inputs, want = {"stream.slab": np.array(SLAB)}, {}
    for N in (1, 8):
        ring = jdefault_context(L=1, N=N, order=1 << 10)
        inner, below = [], 1 << 31
        while len(inner) < 2:
            c = find_ntt_primes(1, 128, below=below)[0]
            below = c
            if c not in ring.primes:
                inner.append(c)
        ectx = JEncodingContext(ring=ring, n_inner=64, inner_primes=tuple(inner))
        rng = np.random.default_rng(17)
        _, sk = jkeygen(ectx, rng)
        rows = rng.integers(0, ring.primes[0], (CHUNK, 1, N), dtype=np.int64).astype(np.uint32)
        pts = [rng.integers(0, ring.primes[0], (CHUNK, 1, N), dtype=np.int64).astype(np.uint32)
               for _ in range(2)]
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
        got = jstream_chunk_ip_sharded(mesh, ectx, sk, jnp.asarray(rows),
                                       [jnp.asarray(p) for p in pts],
                                       jax.random.key(9, impl="threefry2x32"), SLAB)
        inputs[f"stream{N}.rows"] = rows
        for i, p in enumerate(pts):
            inputs[f"stream{N}.pt{i}"] = p
        want[N] = [_triple(e) for e in got]
    return inputs, want


@lru_cache(maxsize=None)
def _ranks(mesh_name: str) -> list:
    limb, coeff = MESHES[mesh_name]
    inputs = {"mesh": np.array([limb, coeff])}
    if coeff == 1:
        inputs.update(_stream_inputs()[0])
    return torch_parallel_worker.run(WORLD, "prover", inputs)


@lru_cache(maxsize=None)
def _jax_groth16(mesh_name: str) -> dict:
    params, pb, kp = _jax_env()
    if mesh_name == "limb2_data2":
        proof = jgroth16_prove_sharded(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                                       jmake_mesh(WORLD, limb=2))
    else:
        proof = jg16.prover(kp.pk, pb.primary_input(), pb.auxiliary_input())
    return {n: _triple(getattr(proof, n)) for n in G16}


@lru_cache(maxsize=None)
def _jax_rinocchio() -> dict:
    params, pb, _ = _jax_env()
    kpr = jrin.generator(pb.get_constraint_system(), params, np.random.default_rng(77),
                         jax.random.PRNGKey(900))
    proof = jrin.prover(kpr.pk, pb.primary_input(), pb.auxiliary_input(),
                        rng=np.random.default_rng(5))
    return {n: _triple(getattr(proof, n)) for n in RIN}


def _equal(out: dict, prefix: str, want: tuple) -> bool:
    c0, c1, level = want
    return (np.array_equal(out[f"{prefix}.c0"], c0) and np.array_equal(out[f"{prefix}.c1"], c1)
            and int(out[f"{prefix}.level"]) == level)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(1, device_type="cpu")


def test_single_process_mesh_and_backend_rule():
    """A world of one gloo rank: the ('limb', 'data') mesh of one device; a
    CUDA mesh over the gloo group is refused, not switched."""
    pmesh.init_single_process("cpu")
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("limb", "data") and tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError, match="nccl backend"):
            make_mesh()
        with pytest.raises(AssertionError):
            make_mesh(2, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n,parts", [(10, 4), (3, 4), (8, 2)])
def test_blocks_are_uneven_row_ranges(n, parts):
    blocks = [pmesh.block(n, parts, i) for i in range(parts)]
    assert [b.stop - b.start for b in blocks] == [len(a) for a in np.array_split(np.arange(n),
                                                                               parts)]
    assert blocks[0].start == 0 and blocks[-1].stop == n


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_worker_meshes(mesh_name):
    limb, coeff = MESHES[mesh_name]
    for out in _ranks(mesh_name):
        if coeff > 1:
            assert tuple(out["mesh_names"]) == ("limb", "coeff", "data")
            assert tuple(out["mesh_shape"]) == (limb, coeff, WORLD // (limb * coeff))
        else:
            assert tuple(out["mesh_names"]) == ("limb", "data")
            assert tuple(out["mesh_shape"]) == (limb, WORLD // limb)


# ---------------------------------------------------------------------------
# the sharded provers and the streamed chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_groth16_sharded_equals_jax(mesh_name, rank):
    out = _ranks(mesh_name)[rank]
    want = _jax_groth16(mesh_name)
    for name in G16:
        assert _equal(out, f"groth16.{name}", want[name]), name
    assert bool(out["groth16.verified"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_rinocchio_sharded_zk_equals_jax(rank):
    out = _ranks("limb2_data2")[rank]
    want = _jax_rinocchio()
    for name in RIN:
        assert _equal(out, f"rinocchio.{name}", want[name]), name
    assert bool(out["rinocchio.verified"])


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("N", [1, 8])
def test_stream_chunk_sharded_equals_jax(N, rank):
    out = _ranks("limb2_data2")[rank]
    for i, want in enumerate(_stream_inputs()[1][N]):
        assert _equal(out, f"stream{N}.{i}", want), i


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_gloo_ranks():
    report = dryrun.dryrun_multichip(WORLD, device_type="cpu")
    assert report["backend"] == "gloo" and report["ranks"] == WORLD
    assert report["prover_mesh"] == {"limb": 2, "coeff": 2, "data": 1}
    assert report["proof_equals_single_device"] and report["verified"]


def test_dryrun_multichip_refuses_missing_gpus():
    if torch.cuda.device_count() >= 64:
        pytest.skip("needs fewer than 64 GPUs")
    with pytest.raises(RuntimeError, match="GPUs"):
        dryrun.dryrun_multichip(64)
