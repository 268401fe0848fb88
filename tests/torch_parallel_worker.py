"""The ranks of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_ntt_sharded.py): gloo ranks on the CPU that import only
ringsnark_tpu_torch.  The test process writes the inputs (``in.npz``) into
a directory and starts the ranks with ``parallel.dryrun.spawn``; rank r
writes its outputs to ``out_<r>.npz`` there.  Every array crosses as
uint32 (int32 residues viewed unsigned)."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ringsnark_tpu_torch.parallel import mesh as pmesh


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32))


def _u(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().numpy().view(np.uint32).copy()


def _enc_arrays(prefix: str, enc, out: dict) -> None:
    out[f"{prefix}.c0"], out[f"{prefix}.c1"] = _u(enc.c0), _u(enc.c1)
    out[f"{prefix}.level"] = np.array(enc.level)


# ---------------------------------------------------------------------------
# the coefficient-sharded NTT
# ---------------------------------------------------------------------------


def ntt_task(rank: int, world: int, inp) -> dict:
    """On a ("coeff",) mesh of the world: both directions, negacyclic and
    cyclic, on this rank's coefficient block of x (forward) and of y (the
    single-device forward, for the inverse), and the round trip; on 8
    ranks also the ("data", "coeff") = (2, 4) mesh at M = 128."""
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.parallel.ntt_sharded import make_sharded_ntt

    primes = tuple(int(p) for p in inp["primes"])
    x = _t(inp["x"])
    M = x.shape[-1]
    cmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("coeff",))
    Mc = M // world
    own = slice(rank * Mc, (rank + 1) * Mc)
    out = {}
    for nega in (False, True):
        plan = nttm.get_plan(primes, M, negacyclic=True)
        fwd = make_sharded_ntt(plan, cmesh, negacyclic=nega)
        inv = make_sharded_ntt(plan, cmesh, negacyclic=nega, inverse=True)
        y = fwd(x[..., own].contiguous())
        out[f"fwd_{int(nega)}"] = _u(y)
        out[f"inv_{int(nega)}"] = _u(inv(_t(inp[f"y_{int(nega)}"])[..., own].contiguous()))
        out[f"roundtrip_{int(nega)}"] = _u(inv(y))
    if world == 8:
        x2 = _t(inp["x2"])
        M2 = x2.shape[-1]
        plan2 = nttm.get_plan(tuple(int(p) for p in inp["primes2"]), M2, negacyclic=True)
        mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "coeff"))
        rows = pmesh.block(x2.shape[0], 2, pmesh.axis_rank(mesh2, "data"))
        c = pmesh.axis_rank(mesh2, "coeff")
        own2 = slice(c * (M2 // 4), (c + 1) * (M2 // 4))
        y2 = make_sharded_ntt(plan2, mesh2, negacyclic=True)(x2[rows, :, own2].contiguous())
        out["mesh2_fwd"] = _u(y2)
        out["mesh2_roundtrip"] = _u(make_sharded_ntt(plan2, mesh2, negacyclic=True,
                                                     inverse=True)(y2))
        out["mesh2_rows"] = np.array([rows.start, rows.stop])
        out["mesh2_cols"] = np.array([own2.start, own2.stop])
    return out


# ---------------------------------------------------------------------------
# the sharded provers and the streamed chunk
# ---------------------------------------------------------------------------


def _env(seed: int = 31, key: int = 300):
    """The JAX package's test env (tests/test_parallel.py): ring L=2, N=8,
    N'=16, three inner primes, the toy circuit with replicate=2, and the
    ringGroth16 keypair of the same numpy seed and threefry key."""
    from ringsnark_tpu_torch.encoding import EncodingContext
    from ringsnark_tpu_torch.models import build_toy_circuit
    from ringsnark_tpu_torch.ops.primes import find_ntt_primes
    from ringsnark_tpu_torch.rings.context import default_context
    from ringsnark_tpu_torch.snark import groth16
    from ringsnark_tpu_torch.snark.api import SnarkParams
    from ringsnark_tpu_torch.utils import prng

    ring = default_context(L=2, N=8, order=1 << 12, device="cpu")
    n_inner = 16
    inner, below = [], 1 << 31
    while len(inner) < 3:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    enc = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=tuple(inner))
    params = SnarkParams(ring=ring, enc=enc)
    rng = np.random.default_rng(seed)
    pb = build_toy_circuit(ring, rng, replicate=2)
    assert pb.is_satisfied()
    kp = groth16.generator(pb.get_constraint_system(), params, rng, prng.key(key))
    return params, pb, kp


def prover_task(rank: int, world: int, inp) -> dict:
    """groth16_prove_sharded on the mesh (limb, coeff, data) of `inp`;
    with coeff 1 also rinocchio_prove_sharded (ZK on) and the streamed chunk
    at N = 1 and 8 on a ("data",) mesh of the world."""
    from ringsnark_tpu_torch.parallel import (
        groth16_prove_sharded,
        make_mesh,
        rinocchio_prove_sharded,
        stream_chunk_ip_sharded,
    )
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.utils import prng

    limb, coeff = (int(v) for v in inp["mesh"])
    mesh = make_mesh(world, limb=limb, coeff=coeff, device_type="cpu")
    out = {"mesh_names": np.array(mesh.mesh_dim_names),
           "mesh_shape": np.array(mesh.mesh.shape)}
    params, pb, kp = _env()
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    proof = groth16_prove_sharded(kp.pk, primary, aux, mesh)
    for name in ("A", "B", "C"):
        _enc_arrays(f"groth16.{name}", getattr(proof, name), out)
    out["groth16.verified"] = np.array(groth16.verifier(kp.vk, primary, proof))
    if coeff > 1:
        return out

    kpr = rinocchio.generator(pb.get_constraint_system(), params, np.random.default_rng(77),
                              prng.key(900))
    proof = rinocchio_prove_sharded(kpr.pk, primary, aux, mesh, rng=np.random.default_rng(5))
    for name in ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F"):
        _enc_arrays(f"rinocchio.{name}", getattr(proof, name), out)
    out["rinocchio.verified"] = np.array(rinocchio.verifier(kpr.vk, primary, proof))

    dmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    for N in (1, 8):
        ectx, sk = _stream_ctx(N)
        got = stream_chunk_ip_sharded(dmesh, ectx, sk, _t(inp[f"stream{N}.rows"]),
                                      [_t(inp[f"stream{N}.pt{i}"]) for i in range(2)],
                                      prng.key(9), int(inp["stream.slab"]))
        for i, e in enumerate(got):
            _enc_arrays(f"stream{N}.{i}", e, out)
    return out


def _stream_ctx(N: int):
    """tests/test_parallel.py's streamed-chunk context: ring L=1, N'=64, two
    inner primes, the secret key of numpy seed 17."""
    from ringsnark_tpu_torch.encoding import EncodingContext, keygen
    from ringsnark_tpu_torch.ops.primes import find_ntt_primes
    from ringsnark_tpu_torch.rings.context import default_context

    ring = default_context(L=1, N=N, order=1 << 10, device="cpu")
    inner, below = [], 1 << 31
    while len(inner) < 2:
        c = find_ntt_primes(1, 128, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    ectx = EncodingContext(ring=ring, n_inner=64, inner_primes=tuple(inner))
    _, sk = keygen(ectx, np.random.default_rng(17))
    return ectx, sk


TASKS = {"ntt": ntt_task, "prover": prover_task}


def run(world: int, task: str, inputs: dict) -> list:
    """Spawn `world` gloo ranks of `task` on `inputs` (from the test
    process); their outputs in rank order."""
    from ringsnark_tpu_torch.parallel.dryrun import spawn

    with tempfile.TemporaryDirectory(prefix="ringsnark_ranks_") as tmp:
        np.savez(Path(tmp) / "in.npz", **inputs)
        spawn(main, world, (world, tmp, task))
        return [dict(np.load(Path(tmp) / f"out_{r}.npz")) for r in range(world)]


def main(rank: int, world: int, tmp: str, task: str) -> None:
    pmesh.init_rank(rank, world, Path(tmp) / "pg", "cpu")
    try:
        inp = np.load(Path(tmp) / "in.npz")
        np.savez(Path(tmp) / f"out_{rank}.npz", **TASKS[task](rank, world, inp))
    finally:
        dist.destroy_process_group()
