"""Multi-device dry run: start the ranks of a world and prove on it.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
and its ``_tiny_env``: ``dryrun_multichip(n)`` starts n ranks with
``torch.multiprocessing`` (spawn), one per visible GPU over NCCL, or gloo
ranks on the CPU when ``device_type="cpu"`` is asked for (with fewer GPUs
than ranks it raises; it never falls back to the CPU).  Every rank then

* proves the toy circuit once with ``groth16_prove_sharded`` on a
  ('limb', ['coeff',] 'data') mesh of the whole world, and checks that the
  verifier accepts and that the proof equals the single-device proof;
* runs the coefficient-sharded NTT forward and back over a ('data',
  'coeff') mesh (the forward blocks equal ``ops.ntt``'s, the round trip
  gives the input back);
* encodes and MACs one data-sharded streamed chunk and checks it against
  ``seeded.encode_seeded`` + ``seeded_inner_product``.

Run it as ``python -m ringsnark_tpu_torch.parallel.dryrun N [cpu|cuda]``.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["dryrun_multichip", "spawn", "tiny_env", "SPAWN_TIMEOUT_S"]

# the ranks of one spawn that are not all done by then are killed
SPAWN_TIMEOUT_S = 300


def spawn(fn, nprocs: int, args: tuple) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes; raise if one fails
    (the others are ended) or if they are not all done in SPAWN_TIMEOUT_S."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, start_method="spawn", join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{nprocs} ranks not done in {SPAWN_TIMEOUT_S} s")


def tiny_env(device: str, L=2, N=8, n_inner=16, L_inner=3, replicate=2, seed=7):
    """(params, protoboard, keypair) of the toy circuit at a tiny ring (the
    JAX package's ``_tiny_env``)."""
    from ..encoding import EncodingContext
    from ..encoding.context import default_inner_primes
    from ..models import build_toy_circuit
    from ..rings.context import default_context
    from ..snark import groth16
    from ..snark.api import SnarkParams
    from ..utils import prng

    ring = default_context(L=L, N=N, order=1 << 12, device=device)
    enc = EncodingContext(ring=ring, n_inner=n_inner,
                          inner_primes=default_inner_primes(n_inner, ring.primes, L_inner))
    params = SnarkParams(ring=ring, enc=enc)
    rng = np.random.default_rng(seed)
    pb = build_toy_circuit(ring, rng, replicate=replicate)
    kp = groth16.generator(pb.get_constraint_system(), params, rng, prng.key(1))
    return params, pb, kp


def mesh_shape(n: int) -> tuple:
    """(limb, coeff, data) of the prover's mesh over n ranks, as the JAX dry
    run picks them: limb 2 on an even count, coeff 2 where data is even.
    (Row blocks may be uneven here, so data needs no power of two.)"""
    limb = 2 if n % 2 == 0 and n > 1 else 1
    data = n // limb
    coeff = 2 if data % 2 == 0 and data >= 2 else 1
    return limb, coeff, data // coeff


def _rank(rank: int, n: int, device_type: str, tmp: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from ..ops import ntt as nttm
    from ..ops.primes import find_ntt_primes
    from ..encoding import keygen
    from ..rings.elem import RingElem
    from ..snark import groth16
    from ..snark import seeded as sd
    from ..utils import prng
    from .mesh import block, init_rank, make_mesh
    from .ntt_sharded import make_sharded_ntt
    from .sharded import groth16_prove_sharded
    from .stream_sharded import stream_chunk_ip_sharded

    init_rank(rank, n, Path(tmp) / "pg", device_type)
    try:
        t0 = time.perf_counter()
        device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
        params, pb, kp = tiny_env(device)
        limb, coeff, data = mesh_shape(n)
        mesh = make_mesh(n, limb=limb, coeff=coeff, device_type=device_type)
        primary, aux = pb.primary_input(), pb.auxiliary_input()
        proof = groth16_prove_sharded(kp.pk, primary, aux, mesh)
        assert groth16.verifier(kp.vk, primary, proof), "sharded proof failed verification"
        single = groth16.prover(kp.pk, primary, aux)
        for name in ("A", "B", "C"):
            assert getattr(proof, name) == getattr(single, name), f"proof element {name} differs"

        # coefficient-sharded NTT over the largest power of two dividing n
        D = n & -n
        cmesh = init_device_mesh(device_type, (n // D, D), mesh_dim_names=("data", "coeff"))
        M = max(2 * D, 16)
        ps = tuple(find_ntt_primes(2, 2 * M))
        plan = nttm.get_plan(ps, M, negacyclic=True)
        rng = np.random.default_rng(3)
        x = torch.as_tensor(np.stack([rng.integers(0, q, (4, M)) for q in ps], axis=1),
                            dtype=torch.int32, device=device)  # [4, L, M]
        ci, di = cmesh.get_local_rank(1), cmesh.get_local_rank(0)
        rows, own = block(4, n // D, di), slice(ci * (M // D), (ci + 1) * (M // D))
        fwd = make_sharded_ntt(plan, cmesh, negacyclic=True)(x[rows, :, own].contiguous())
        assert torch.equal(fwd, nttm.negacyclic_ntt_rev(x, plan)[rows, :, own]), "sharded NTT"
        back = make_sharded_ntt(plan, cmesh, negacyclic=True, inverse=True)(fwd)
        assert torch.equal(back, x[rows, :, own]), "sharded NTT round trip"

        # the data-sharded streamed chunk
        ring, ectx = params.ring, params.enc
        _, sk = keygen(ectx, np.random.default_rng(19))
        dmesh = init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
        chunk, slab = 16 * n, 4

        def slots(seed):
            r = np.random.default_rng(seed)
            return torch.as_tensor(np.stack([r.integers(0, q, (chunk, ring.N))
                                             for q in ring.primes], axis=1),
                                   dtype=torch.int32, device=device)

        rows_c, pts = slots(20), [slots(21)]
        key = prng.key(13)
        got = stream_chunk_ip_sharded(dmesh, ectx, sk, rows_c, pts, key, slab)
        want = sd.seeded_inner_product(sd.encode_seeded(ectx, sk, RingElem(ring, rows_c), key,
                                                        slab), pts, use_modswitch=False)
        assert all(g == w for g, w in zip(got, want)), "data-sharded streamed chunk"
        if rank == 0:
            (Path(tmp) / "report.json").write_text(json.dumps({
                "ranks": n, "device_type": device_type, "backend": dist.get_backend(),
                "prover_mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                "proof_equals_single_device": True, "verified": True,
                "ntt_mesh": {"data": n // D, "coeff": D, "M": M},
                "stream_chunk": {"rows": chunk, "slab": slab},
                "seconds": time.perf_counter() - t0}))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device_type: str | None = None) -> dict:
    """Start `n_devices` ranks (GPUs over NCCL by default; gloo ranks on the
    CPU with ``device_type="cpu"``), prove and check as the module says, and
    return rank 0's report.  Raises where a check fails, where the GPUs are
    fewer than the ranks, or after SPAWN_TIMEOUT_S."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} GPUs, "
                           f"{torch.cuda.device_count()} visible (device_type='cpu' runs "
                           "gloo ranks on the CPU)")
    with tempfile.TemporaryDirectory(prefix="ringsnark_dryrun_") as tmp:
        spawn(_rank, n_devices, (n_devices, device_type, tmp))
        return json.loads((Path(tmp) / "report.json").read_text())


if __name__ == "__main__":
    print(json.dumps(dryrun_multichip(int(sys.argv[1]),
                                      sys.argv[2] if len(sys.argv) > 2 else None)))
