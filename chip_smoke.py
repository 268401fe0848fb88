#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ringsnark_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # full size: Rq N=8192, L=1, N'=16384; M=2^14 resident,
                                     # 2^16 seeded and streamed Rinocchio, 2^18 streamed; the
                                     # four reference circuits at their published shapes, L=2
    python3 chip_smoke.py --small    # the same phases at a small size (debugging)

Phases, each timed on its own line; any failure raises, prints its
traceback and exits nonzero without the final line:

0. environment: torch/CUDA versions, nvcc, the card's name and power limit;
   fails without CUDA.
1. build the kernels' library from `ringsnark_tpu_torch/csrc/ntt.cu`,
   `csrc/prng.cu` and `csrc/mac.cu` in one nvcc call (or reuse the library
   of these exact sources, with the compiler output kept beside it);
   `ptxas` must report no register spills.
2. the shared-memory kernel against its plain PyTorch twin, on the card:
   every mode at every shape the resident path uses, and at the streamed
   path's encryption shapes ([512, 1, 4, 16384] forward, [512, 1, 16384]
   mod t inverse), must be equal, on a batch of up to 32 rows and on the
   main path's batch (at the encryption and witness-map shapes several
   tiles for every persistent CTA); then both are timed on that batch (CUDA
   events), beside the bound (one read and one write of every residue at
   3.35 TB/s) and the kernel's share of it.
2b. the split kernel (two passes) against its plain versions
   (`ntt_split_plain` and the full-size twin): all four modes at M = 2^16,
   2^17 (the seeded path's witness map) and 2^18, 2^19 (the streamed
   path's) on the witness map's batch of 1024 slot rows, plus
   inverse(forward(x)) == x; kernel and plain versions timed at every
   shape, beside the bound and share.  Then the two CTA orders of the
   shared-memory kernel, timed at the seeded MAC's encoding shape.
2c. the split route past 2^19 (inner size 32768; the outer stages in two
   passes from 2^21) through the dispatcher, all four modes at M = 2^20,
   2^21 and 2^22 against the full-size plain twin (equal, max abs err 0,
   inverse(forward(x)) == x); the cyclic modes timed at 2^20 and 2^21 on a
   512 MiB batch beside the bound and the plain twin.
2d. the draw, lift and encryption kernels (`csrc/prng.cu`: `uniform`,
   `cbd_error`, `lift`, `encrypt`) against their plain torch-op versions on
   the same inputs (equal, max abs err 0) at the north star's encryption
   sub-chunk (rows 1024-1536 of a 4096-row slab, L=1, L'=4, N'=16384), one
   Z_q limb's short last sub-chunk (rows 2730-4096, L'=3, N'=4096),
   logistic regression's encode chunk (32 rows, L=2, L'=4, N'=16384) and
   `models/fhe.py`'s signed span 13 (`prng.randint` in [-6, 7)): the lift
   with its error at the encryption shapes, `encrypt` with c1 and with c0
   alone, `bgv.encrypt` against the plain schedule; the lift alone at phase
   2e's operand shapes (the north star's 512 rows, Z_q's 910 broadcast
   rows, logreg's 128 rows at L=2); each timed beside its bound and the
   plain version's time: the kernel eagerly (`ms`, with the host's wrapper:
   key columns, geometry, ctypes) and from a replayed CUDA graph
   (`graph_ms`, the device alone).  The bound (`prng_bound`) is the larger
   of the bytes at 3.35 TB/s and the least time of the operations the
   function needs, counted by the pipe they issue on (`Ops`: ALU, the FMA
   pipe's integer multiplier, popcount, and the issue rate over all).
2e. the MAC kernels (`csrc/mac.cu`: `mac` with c1 given, `mac_drawn` with
   c1 drawn in registers) against `encoding.mac.mac_plain` on the same
   inputs (equal, max abs err 0) at the north star's row sub-chunk (512
   rows, L=1, L'=4, N'=16384) with two operands and with one (the seeded
   prove's `delta_ts` and `delta_mid`), Z_q's seeded sub-chunk with
   its broadcast operand (910 rows, L=3, L'=3, N'=4096) and logistic
   regression's resident chunk (128 rows, L=2, L'=4, N'=16384); each timed
   as in 2d beside its bound and the plain version's time.
3. the resident main path (M=2^14) through the package API: ringGroth16
   `generator` -> `prover` (cold, then warm: the two proofs must be
   identical) -> `verifier` (True), and `verifier` with one public input
   changed (False).  Every kernel launch count is reset just before and
   read just after; each shared-memory mode, and the lift and encryption
   kernels (the generator's encryptions, the prover's operands) and `mac`
   (the prove), must have launched.  So on every path: the streamed ones
   (7, 8, 14b) must launch `lift`, `encrypt` and `mac`, the seeded ones (5,
   14d) `mac_drawn` (c1 drawn in the MAC's registers; no `uniform` draw
   writes it); the frontend's circuits, the keys, the sharded provers and
   the examples `lift`, `encrypt` and `mac`.  From phase 3 to 14 every
   encryption on the card must launch one forward NTT, one `lift` and one
   `encrypt` (`one_ntt_per_encryption`).
4. small-input cross-check: a keypair made on the card, carried to the CPU,
   gives the same proof from the plain twins as from the kernels, and the
   CPU verifier accepts the card's proof.
5. the seeded main path (M=2^16): the resident phase's memory is freed, then
   `generator_seeded` -> `prover_seeded` cold and warm (identical proofs) ->
   `verifier` (True; False with a changed public input), with the launch
   counts reset before and read after: the negacyclic shared-memory modes
   and both cyclic split modes must have launched.  Prints the stage times,
   the resident CRS (c0) and the peak allocation.
6. small seeded cross-check: the card's seeded proof equals, bit for bit,
   the proof that the same keypair gives on the CPU, and the CPU verifier
   accepts it.
7. the streamed ringGroth16 path at the north star, M=2^18 (slab 4096,
   phase_rows 2^16): `streamed.stream_prove` once (setup and prove in one
   pass, the CRS never resident) -> `verifier` (True; False with a changed
   public input), launch counts reset before and read after: both
   negacyclic modes and both cyclic split modes must have launched.
   Prints the StreamRecord totals, its sections, the wall time and the
   peak allocation.
8. streamed Rinocchio at M=2^16: `stream_prove_rinocchio` once (F present)
   -> `rinocchio.verifier` (True; False with a changed public input), with
   the same launch checks.
9. small streamed cross-check (N=256, N'=512, M=2^6; L=1 and L=2, the
   limb-local branch): `stream_prove` and `stream_prove_rinocchio` on the
   card equal the CPU's calls bit for bit, two card calls with one seed
   give one proof, the CPU verifiers accept the card's proofs, and
   `amplify.prove_repeated` with K=2 verifies and rejects a changed public
   input.

10. the circuit frontend at the four reference circuits' published shapes
   (ring L=2, N'=16384; plaintext check N=2048, logT=32; ct-mul N=8192,
   logT=16; in-circuit NTT N=4096; logistic regression, 256 features,
   N=2048, logT=16): each built on a `Protoboard`, `is_satisfied()`, then
   for Rinocchio and for ringGroth16 with a resident CRS `generator(cs)` ->
   `prover` cold and warm (identical proofs) -> `verifier` (True; False with
   one public input changed).  Rinocchio's proof holds F exactly when the
   circuit has auxiliary wires.  Launch counts are reset before each circuit
   and read after: both negacyclic modes must have launched.  Prints per
   circuit and system: constraints, variables, nnz, build, setup, prove
   (cold, warm) and verify seconds, CRS and peak GiB, proof bits.  After a
   circuit's counts are read, the shared-memory kernel is held to its plain
   twin at that circuit's own shapes (ring L=2 at its N for one element and
   for the outer BGV batch, `encode`'s randomness chunk on the fresh level
   and mod t, its inner chain level by level at the MAC's chunk, the cyclic
   modes at its domain size M and 2M at the slot chunk's rows): equal, and
   inverse(forward(x)) == x.
11. small frontend cross-check (N=16, N'=512, L=2; logistic regression with
   4 features and the plaintext check): the card's Rinocchio and ringGroth16
   proofs from a keypair made on the card equal, bit for bit, the proofs the
   carried keypair gives on the CPU, and the CPU verifiers accept the card's
   proofs; the kernel is held to its plain twin at these shapes as well.
12. keys on disk (`utils/serialization.py`), logistic regression at its
   published shape (256 features, N=2048, logT=16, ring L=2, N'=16384),
   resident Rinocchio (CRS 8.0 GiB) then ringGroth16 (6.0 GiB), one at a
   time: generate, prove from memory, `save_vk` (pk and constraint system
   with it) into `keys_out/` after checking the free disk space, drop the
   keypair, `load_vk` onto the card, prove from the loaded pk (equal bit for
   bit to the proof from memory), `save_proof` / `load_proof`, verify with
   the loaded vk (True; False with a changed public input), delete the
   files.  0.25 GiB of the Rinocchio pk (a quarter of `s_pows` c0) is also written with
   `np.savez_compressed` (the JAX package's writer) beside `np.savez` (the
   port's) and read back.  Then phase 7's north-star vk (a CRS-less stub) is
   saved, loaded, and verifies phase 7's proof.  Prints per system the save,
   load and prove seconds, file and peak GiB, the stored/compressed
   comparison, and the phase's launch counts (path `keys`).
12b. small keys cross-check (logistic regression with 4 features, N=16,
   N'=512): a vk and a proof saved on the card load on the CPU; the CPU's
   proof from the loaded key equals the card's bit for bit, and the CPU
   verifier accepts the card's proof from its file.
13. the multi-device layer (`ringsnark_tpu_torch/parallel/`) on a world of
   one rank over NCCL, opened before phase 3 (one card: NCCL refuses two
   ranks on one device, so no exchange stage runs; the exchange stages, the
   sum over 'data' and the gathers over 'limb' and 'coeff' at D > 1 are
   held by the CPU tests on gloo ranks): the ('limb', 'data') = (1, 1) mesh
   of `make_mesh` and a ('limb', 'coeff', 'data') = (1, 1, 1) mesh built
   directly.  `sharded_ntt` in all four modes at M = 2^18 on 1024 rows
   equals `ops.ntt` bit for bit; `cyclic_intt_nat(scale=False)` on the
   shared-memory route (M = 2^14, and 2^15: the sharded witness map's
   inv_2M) and the split route (2^18) equals the plain twin.  The sharded provers run inside the phases whose keys they use,
   after those phases' launch counts are read: `groth16_prove_sharded` in
   phase 3 on both meshes (== phase 3's proof, verifies), the data-sharded
   streamed chunk after phase 7 (65,536 rows at phase 7's parameters, slab
   4096, == `encode_seeded` + `seeded_inner_product(use_modswitch=False)`),
   and `rinocchio_prove_sharded` in phase 10 on logistic regression's keypair
   (== the unsharded proof under the same numpy seed, verifies).  Their launch
   counts, set to 0 before each and read after, are the path `sharded`.
14. the entry-point scripts and examples (`ringsnark_tpu_torch/scripts/`,
   `examples/`), each `main(argv)` called in-process as `python -m` calls it:
   14a `scripts/bench`, the north-star NTT [32, 6, 8192] (kernel == plain
   twin in both directions and == the native C++ output; time a transform
   from a replayed CUDA graph and from the host, share of the bound, the
   plain twin, the CPU legs on 1 and all threads); 14b `bench_prover
   --ring zq --L 3 --n-inner 4096 --log-m 18 --phased --margin 4 --passes 1`
   (the streamed Z_q prover, N=1: one cold pass, verifies, rejects a
   changed public input; launches counted over the call as path `zq`:
   negacyclic forward and inverse, the split cyclic modes, no outer
   negacyclic); 14c the small Z_q L=3 cross-check (M=2^6, N'=512: the card's
   streamed and seeded proofs == the CPU's); 14d `bench_prover` seeded over
   Z_q at M=2^14 (`--margin 6`: L'=3; path `zq_seeded`); 14e the
   four examples at their defaults (path `examples`); 14f `bench_circuits
   --preset reference` for the plaintext check (both systems) and for
   logreg's ringGroth16 and FHE side; 14g `bench_encode_profile`; 14h
   `bench_cpu_full --log-m 12`; 14i `bench_scaling --D 1` (one NCCL rank).
   During 14b, 14d, 14e and 14f-i every shape the dispatcher hands the
   kernels is recorded; after each, every recorded shape is held against
   the plain versions on random residues (the split route against
   `ntt_split_plain` and the full-size twin), at its own rows up to 2^27
   residues.  `--small` runs each at a tiny size.

The line before the last is a JSON object with the kernels' launch counts
(per path, `sharded`, `zq`, `zq_seeded` and `examples` among them; the
negacyclic entries carry 14a's numbers under `north_star`; the PRNG
kernels as `prng_<kernel>`, with every phase-2d shape under `shapes`; the
MAC kernels as `mac` and `mac_drawn`, with every phase-2e shape),
errors, times (`ms`: CUDA events around eager calls, the host's wrapper
in them, in every phase; `graph_ms`: the device alone, from a replayed
CUDA graph, for the PRNG, lift, encryption and MAC kernels and 14a's
north-star NTT, null where a phase does not take it), bounds
(`bound_ms`, `bound_by`, `share_of_bound` of `ms`,
`graph_share_of_bound`)
and `library_ms` (null: no PyTorch call computes an NTT modulo a prime,
nor threefry2x32: `torch`'s generators are Philox, nor sum (c * pt mod
Q_j));
the last line is
`{"ok": true, "device": {...}}`.  This script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple
from pathlib import Path

import numpy as np
import torch

# main-path configurations: the README's Rq row (BASELINE north-star ring);
# the resident CRS at M=2^14, the seeded CRS at M=2^16 (the largest M whose
# seeded CRS fits one 80 GB card)
FULL = dict(L=1, N=8192, n_inner=16384, log_m=14)
FULL_SEEDED = dict(FULL, log_m=16)
# the streamed provers' (slab, phase_rows) are their defaults
FULL_STREAMED = dict(FULL, log_m=18, slab=4096, phase_rows=1 << 16)
FULL_RINOCCHIO = dict(FULL_STREAMED, log_m=16)
SMALL = dict(L=1, N=256, n_inner=512, log_m=8)
SMALL_SEEDED = dict(SMALL, log_m=9)
SMALL_STREAMED = dict(SMALL, log_m=11, slab=256, phase_rows=1 << 10)
SMALL_RINOCCHIO = dict(SMALL_STREAMED, log_m=9)
# phase 10: the reference circuits' published shapes (outer N, inner N',
# logT, features), ring L=2
REFERENCE_CIRCUITS = {
    "plaintext_check": dict(N=2048, n_inner=16384, log_t=32, features=32),
    "ct_mul": dict(N=8192, n_inner=16384, log_t=16, features=32),
    "incircuit_ntt": dict(N=4096, n_inner=16384, log_t=16, features=32),
    "logreg": dict(N=2048, n_inner=16384, log_t=16, features=256),
}
SMALL_CIRCUITS = {
    "plaintext_check": dict(N=64, n_inner=512, log_t=32, features=4),
    "ct_mul": dict(N=256, n_inner=512, log_t=16, features=4),
    "incircuit_ntt": dict(N=128, n_inner=512, log_t=16, features=4),
    "logreg": dict(N=64, n_inner=512, log_t=16, features=8),
}
# phase 13: the sharded NTT's (log2 M, rows); the streamed chunk is one
# phase_rows chunk of phase 7's stream
SHARDED_NTT = dict(full=(18, 1024), small=(16, 8))
REPLACES = "ringsnark_tpu/ops/pallas_ntt.py:170"  # _ntt_kernel_gridfree
REPLACES_SPLIT = "ringsnark_tpu/ops/pallas_ntt.py:557"  # ntt_split_pallas -> _outer_kernel :458
SOURCE = "ringsnark_tpu_torch/csrc/ntt.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def bound_ms(numel: int) -> float:
    """One read and one write of every int32 residue at the card's memory rate."""
    return 2 * 4 * numel / HBM_BYTES_PER_S * 1e3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def build_kernels():
    """Phase 1: build (or reuse) the kernels' library; its ptxas report must
    name every kernel's registers and no spill."""
    from ringsnark_tpu_torch.ops import cuda_ntt

    built = cuda_ntt.build()
    print(f"  library {built.path.name}", flush=True)
    lines = built.log.splitlines()
    regs = [int(w.split()[0]) for line in lines for w in line.split("Used ")[1:]]
    spills = [line.strip() for line in lines
              if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes "
                                                                   "spill stores, 0 bytes spill")]
    check(regs and not spills, f"ptxas reports register spills ({spills}) or no kernel")
    print(f"  ptxas: {len(regs)} kernels, registers per thread {min(regs)}-{max(regs)}, "
          "spills: none", flush=True)
    return built


def phase(n, name, t0):  # n: phase number or label
    torch.cuda.synchronize()
    print(f"[phase {n}] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def add_counts(total: dict, counts: dict) -> dict:
    for m, c in counts.items():
        total[m] = total.get(m, 0) + c
    return total


def reset_counts():
    """Every kernel wrapper's launch count to 0: the NTT's, the PRNG's and
    the MAC's."""
    from ringsnark_tpu_torch.ops import cuda_mac, cuda_ntt, cuda_prng

    cuda_ntt.reset_launch_counts()
    cuda_prng.reset_launch_counts()
    cuda_mac.reset_launch_counts()


def read_counts() -> dict:
    """The launch count of every kernel wrapper, the PRNG's as prng_<kernel>,
    the MAC's as `mac` and `mac_drawn`."""
    from ringsnark_tpu_torch.ops import cuda_mac, cuda_ntt, cuda_prng

    return {**cuda_ntt.launch_counts,
            **{f"prng_{k}": n for k, n in cuda_prng.launch_counts.items()},
            **cuda_mac.launch_counts}


def open_world(card: str):
    """Phase 13's world of one rank over NCCL (before phase 3, which proves
    on it) and its two meshes: ('limb', 'data') from `make_mesh` and
    ('limb', 'coeff', 'data') built directly, so the coeff branch runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ringsnark_tpu_torch.parallel import mesh as pmesh

    pmesh.init_single_process("cuda")
    check(dist.get_backend() == "nccl", f"the world-1 group runs {dist.get_backend()}, not nccl")
    meshes = {"limb x data": pmesh.make_mesh(1),
              "limb x coeff x data": DeviceMesh("cuda", torch.arange(1).reshape(1, 1, 1),
                                                mesh_dim_names=("limb", "coeff", "data"))}
    for name, mesh in meshes.items():
        check(mesh.device_type == "cuda", f"{name} mesh on {mesh.device_type}")
    print(f"  world size {dist.get_world_size()} over {dist.get_backend()}; meshes "
          f"{ {n: dict(zip(m.mesh_dim_names, m.mesh.shape)) for n, m in meshes.items()} }; "
          "world size 1: exchange stages held by tier-1 on gloo", flush=True)
    return meshes


def sharded_groth16(kp, primary, aux, proof, meshes, card):
    """Phase 3's sharded check: groth16_prove_sharded on both meshes ==
    phase 3's proof, bit for bit, and verifies.  Returns the launch counts
    (set to 0 before each prove, read after) and the seconds per mesh."""
    from ringsnark_tpu_torch.parallel import groth16_prove_sharded
    from ringsnark_tpu_torch.snark import groth16

    counts, times = {}, {}
    for name, mesh in meshes.items():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = groth16_prove_sharded(kp.pk, primary, aux, mesh)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        add_counts(counts, read_counts())
        check(all(a == b for a, b in zip((proof.A, proof.B, proof.C), (got.A, got.B, got.C))),
              f"sharded ringGroth16 on the {name} mesh != phase 3's proof")
        check(groth16.verifier(kp.vk, primary, got) is True,
              f"the verifier rejected the sharded ringGroth16 proof ({name})")
        print(f"  sharded ringGroth16 on {name} ({dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}): "
              f"{times[name]:.3f} s, == phase 3's proof, verifies ({card})", flush=True)
    return counts, times


def sharded_rinocchio(kp, primary, aux, proof, mesh, seed, card):
    """Phase 10's sharded check on logistic regression's keypair:
    rinocchio_prove_sharded under the prover's numpy seed == its proof, and
    verifies.  Returns the launch counts and the seconds."""
    from ringsnark_tpu_torch.parallel import rinocchio_prove_sharded
    from ringsnark_tpu_torch.snark import rinocchio

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = rinocchio_prove_sharded(kp.pk, primary, aux, mesh, rng=np.random.default_rng(seed))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(_proofs_equal(proof, got), "sharded Rinocchio != the unsharded proof")
    check(rinocchio.verifier(kp.vk, primary, got) is True,
          "the verifier rejected the sharded Rinocchio proof")
    print(f"  sharded Rinocchio (logreg) on limb x data: {dt:.3f} s, == the unsharded proof, "
          f"verifies ({card})", flush=True)
    return counts, dt


def sharded_stream_chunk(params, cfg, mesh, card):
    """After phase 7: one chunk of its stream (phase_rows rows of random
    CRS slots and two plaintext batches, slab as phase 7) through
    stream_chunk_ip_sharded == encode_seeded + seeded_inner_product
    (use_modswitch=False).  Returns the launch counts and the seconds."""
    from ringsnark_tpu_torch.encoding import keygen
    from ringsnark_tpu_torch.parallel import stream_chunk_ip_sharded
    from ringsnark_tpu_torch.rings.elem import RingElem
    from ringsnark_tpu_torch.snark import seeded
    from ringsnark_tpu_torch.utils import prng

    ring, ectx = params.ring, params.enc
    chunk, slab = cfg["phase_rows"], cfg["slab"]
    _, sk = keygen(ectx, np.random.default_rng(21))
    gen = torch.Generator(device="cuda").manual_seed(22)

    def slots():
        return torch.cat([torch.randint(0, p, (chunk, 1, ring.N), generator=gen,
                                        dtype=torch.int32, device="cuda") for p in ring.primes],
                         dim=1)

    rows, pts, key = slots(), [slots(), slots()], prng.key(23)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = stream_chunk_ip_sharded(mesh, ectx, sk, rows, pts, key, slab)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    want = seeded.seeded_inner_product(seeded.encode_seeded(ectx, sk, RingElem(ring, rows), key,
                                                            slab), pts, use_modswitch=False)
    torch.cuda.synchronize()
    dt_ref = time.perf_counter() - t0
    check(all(g == w for g, w in zip(got, want)), "the sharded streamed chunk != the seeded one")
    print(f"  sharded streamed chunk ({chunk} rows, slab {slab}, N={ring.N}, N'={ectx.n_inner}, "
          f"L'={ectx.L_inner}): {dt:.3f} s, == encode_seeded + seeded_inner_product "
          f"({dt_ref:.3f} s) ({card})", flush=True)
    return counts, dt, dt_ref


def sharded_ntt_phase(meshes, log_m, rows, report, split_report, card):
    """Phase 13: sharded_ntt on the 3-D mesh's 'coeff' dimension in all four
    modes at M = 2^log_m == ops.ntt, bit for bit (launch counts set to 0
    before, read after; ops.ntt's launches are not counted); then
    cyclic_intt_nat(scale=False) on the shared-memory route (M = 2^14, and
    2^15: the inv_2M of the sharded witness map at M = 2^14) and on the
    split route (2^log_m) == the plain twin, timed."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.parallel import sharded_ntt

    from ringsnark_tpu_torch.ops.primes import find_ntt_primes

    mesh = meshes["limb x coeff x data"]
    M = 1 << log_m
    primes = tuple(find_ntt_primes(1, 2 * M))  # one limb, as the streamed witness map's
    gen = torch.Generator(device="cuda").manual_seed(1357)
    x = torch.cat([torch.randint(0, p, (rows, 1, M), generator=gen, dtype=torch.int32,
                                 device="cuda") for p in primes], dim=1)
    plan = nttm.get_plan(primes, M, negacyclic=True)
    modes = [(inv, nega) for nega in (False, True) for inv in (False, True)]
    torch.cuda.synchronize()
    reset_counts()
    got, ms = {}, {}
    for inv, nega in modes:
        t0 = time.perf_counter()
        got[(inv, nega)] = sharded_ntt(x, plan, mesh, negacyclic=nega, inverse=inv)
        torch.cuda.synchronize()
        ms[cuda_ntt.mode_name(inv, nega)] = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    dispatch = {(False, False): nttm.cyclic_ntt_rev, (True, False): nttm.cyclic_intt_nat,
                (False, True): nttm.negacyclic_ntt_rev, (True, True): nttm.negacyclic_intt_nat}
    for inv, nega in modes:
        mode = cuda_ntt.mode_name(inv, nega)
        check(torch.equal(got[(inv, nega)], dispatch[(inv, nega)](x, plan)),
              f"sharded_ntt {mode} != ops.ntt at M=2^{log_m}")
        print(f"  equal  sharded {mode:15s} M=2^{log_m} rows={rows}: {ms[mode]:.3f} ms "
              f"(first call, host clock) ({card})", flush=True)
    del got

    unscaled = {}
    for label, m, rep, route in (("shared-memory M=2^14", 1 << 14, report["cyclic_inv"],
                                  "cyclic_inv"),
                                 ("shared-memory M=2^15", 1 << 15, report["cyclic_inv"],
                                  "cyclic_inv"),
                                 (f"split M=2^{log_m}", M, split_report["split_cyclic_inv"],
                                  "split_cyclic_inv")):
        xm = x[..., :m].contiguous()
        cplan = nttm.get_plan(primes, m)
        before = cuda_ntt.launch_counts[route]
        y = nttm.cyclic_intt_nat(xm, cplan, scale=False)
        check(cuda_ntt.launch_counts[route] == before + 1, f"scale=False not routed to {route}")
        want = nttm.cyclic_intt_nat_plain(xm, cplan, scale=False)
        err = int((y.to(torch.int64) - want.to(torch.int64)).abs().max())
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        check(torch.equal(y, want), f"cyclic_intt_nat(scale=False) != the twin on the {label} route")
        kms = cuda_ms(lambda: nttm.cyclic_intt_nat(xm, cplan, scale=False))
        pms = cuda_ms(lambda: nttm.cyclic_intt_nat_plain(xm, cplan, scale=False), iters=1)
        bms = bound_ms(xm.numel())
        unscaled[f"{route} M={m}"] = dict(ms=kms, plain_ms=pms, bound_ms=bms,
                                          shape=f"M={m}, L={len(primes)}, rows={rows}")
        rep.setdefault("unscaled", {})[f"M={m}"] = unscaled[f"{route} M={m}"]
        print(f"  equal  cyclic_intt_nat(scale=False) {label} rows={rows}: kernel {kms:.4f} ms, "
              f"plain twin {pms:.4f} ms, bound {bms:.4f} ms ({100 * bms / kms:.1f} %) ({card})",
              flush=True)
        del y, want, xm
    del x
    torch.cuda.empty_cache()
    return counts, ms, unscaled


def make_params(cfg, device):
    """bench_prover's parameters for cfg (noise margin 10)."""
    from ringsnark_tpu_torch.scripts.common import bench_params

    return bench_params(cfg["L"], cfg["N"], cfg["n_inner"], cfg["log_m"], 10, device)


def zq_params(L: int, n_inner: int, log_m: int):
    """Phase 14b's Z_q parameters (N=1, margin 4) at L outer limbs, on the card."""
    from ringsnark_tpu_torch.scripts.common import bench_params

    return bench_params(L, 1, n_inner, log_m, 4, "cuda")


def zq_limb_params(n_inner: int, log_m: int):
    """One limb of phase 14b's Z_q parameters, on the card."""
    return zq_params(1, n_inner, log_m)


def make_circuit_params(cfg, device):
    """Ring L=2 and the inner chain for a circuit's largest inner product
    (`features` is what a circuit without features is sized with), as
    bench_circuits makes them."""
    from ringsnark_tpu_torch.scripts.bench_circuits import make_params as circuit_params

    return circuit_params(cfg["N"], cfg["n_inner"],
                          max(4 * cfg["features"] + 8, cfg["N"] + 2, cfg["log_t"] + 2), device)


def build_circuit(name, cfg, ring, seed):
    from ringsnark_tpu_torch import models

    rng = np.random.default_rng(seed)
    if name == "plaintext_check":
        return models.build_plaintext_check(ring, rng, log_t=cfg["log_t"])
    if name == "ct_mul":
        return models.build_ct_mul(ring, rng, log_t=cfg["log_t"])
    if name == "incircuit_ntt":
        return models.build_incircuit_ntt(ring, rng)
    return models.build_logreg_inference(ring, rng, num_features=cfg["features"],
                                         log_t=cfg["log_t"])


def make_stage(times: dict):
    """stage(name, fn): fn() timed on the host clock between synchronizes,
    into times[name]."""

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        print(f"  {name}: {times[name]:.3f} s", flush=True)
        return out

    return stage


def cuda_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10):
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph and replayed between two events, so the host's wrapper (key
    columns, geometry, ctypes) is not in it; `cuda_ms` keeps it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def equal_to_plain(label, primes, size, negacyclic, rows, gen, report):
    """Both modes of the shared-memory kernel on random [rows, L, size]
    residues == their plain twins, and inverse(forward(x)) == x; the largest
    difference goes into report[mode]["max_abs_err"].  Returns (x, plan)."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm

    plan = nttm.get_plan(tuple(primes), size, negacyclic=negacyclic)
    x = torch.cat([torch.randint(0, p, (rows, 1, size), generator=gen, dtype=torch.int32,
                                 device=gen.device) for p in primes], dim=1)
    for inverse in (False, True):
        mode = cuda_ntt.mode_name(inverse, negacyclic)
        got = cuda_ntt.ntt(x, plan, inverse=inverse, negacyclic=negacyclic)
        want = nttm.PLAIN_TWINS[(inverse, negacyclic)](x, plan)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        report[mode]["max_abs_err"] = max(report[mode]["max_abs_err"], err)
        check(torch.equal(got, want), f"{mode} kernel != plain twin at {label}, rows={rows}")
        print(f"  equal  {mode:15s} {label:28s} rows={rows}", flush=True)
    back = cuda_ntt.ntt(cuda_ntt.ntt(x, plan, False, negacyclic), plan, True, negacyclic)
    check(torch.equal(back, x), f"inverse(forward(x)) != x at {label}, rows={rows}")
    return x, plan


def circuit_kernels_vs_plain(params, M, batch, report, seed):
    """The kernels == their plain twins at the shapes a circuit's path gives
    them (rows counted per transform of the plan's limbs): the ring's
    negacyclic transform at N for one element and for the outer BGV helper's
    batch of `batch` plaintexts; `encode`'s randomness chunk (the fresh
    level's forward transform over chunk * L rows, the plaintexts' inverse
    mod t over chunk rows); the MAC's plaintext chunk and modswitch at every
    inner level; and the witness map's cyclic transforms at the domain size
    M and 2M (none at M = 1) at the slot chunk's rows."""
    from ringsnark_tpu_torch.encoding import encoding as enc_mod

    ring, ectx = params.ring, params.enc
    N, n_inner, Li = ring.N, ectx.n_inner, ectx.L_inner
    enc_rows = max(8, enc_mod._ENCODE_CHUNK_ELEMS // (ring.L * Li * n_inner))
    slot_rows = min(1024, N)
    gen = torch.Generator(device=ring.device).manual_seed(seed)
    shapes = [(f"ring N={N} L={ring.L}", ring.primes, N, True, rows) for rows in (1, batch)]
    shapes += [(f"encode N'={n_inner} L'={Li}", ectx.level_primes(0), n_inner, True,
                enc_rows * ring.L),
               (f"encode plain t N'={n_inner}", ring.primes, n_inner, True, enc_rows)]
    shapes += [(f"MAC N'={n_inner} L'={Li - lv}", ectx.level_primes(lv), n_inner, True,
                enc_mod._chunk_rows(ectx, Li - lv) * ring.L)
               for lv in range(Li - ectx.floor_limbs + 1)]
    if M > 1:
        shapes += [(f"cyclic M={M} L={ring.L}", ring.primes, M, False, slot_rows),
                   (f"cyclic 2M={2 * M} L={ring.L}", ring.primes, 2 * M, False, slot_rows)]
    for shape in shapes:
        equal_to_plain(*shape, gen, report)


def kernel_vs_plain(params, cfg):
    """Phase 2: equality at every slice shape, then times per mode."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.snark import seeded

    ring, ectx = params.ring, params.enc
    M, N, n_inner = 1 << cfg["log_m"], cfg["N"], cfg["n_inner"]
    enc_rows = max(1, (1 << 24) // (ring.L * ectx.L_inner * n_inner))  # encode/MAC chunk
    sub_rows = seeded._sub_rows(ectx)  # the streamed path's encryption sub-chunk
    slot_rows = min(1024, N)  # witness-map slot chunk
    floor_level = ectx.L_inner - ectx.floor_limbs
    # (label, primes, size, negacyclic, rows at the main path's batch, modes timed)
    shapes = [(f"ring N={N} outer", ring.primes, N, True, 16, ())]
    shapes += [
        (f"inner N'={n_inner} L'={ectx.L_inner - lv}", ectx.level_primes(lv), n_inner,
         True, enc_rows, ())
        for lv in range(floor_level + 1)
    ]
    shapes += [
        (f"plain t N'={n_inner}", ring.primes, n_inner, True, enc_rows, ()),
        (f"encrypt N'={n_inner} L'={ectx.L_inner}", ectx.level_primes(0), n_inner, True,
         sub_rows, ("negacyclic_fwd",)),
        (f"encrypt plain t N'={n_inner}", ring.primes, n_inner, True, sub_rows,
         ("negacyclic_inv",)),
        (f"cyclic M={M} outer", ring.primes, M, False, slot_rows, ("cyclic_inv",)),
        (f"cyclic 2M={2 * M} outer", ring.primes, 2 * M, False, slot_rows, ("cyclic_fwd",)),
    ]
    gen = torch.Generator(device=ring.device).manual_seed(1234)
    report = {m: {"max_abs_err": 0, "ms": None, "plain_ms": None, "shape": None,
                  "bound_ms": None} for m in cuda_ntt.MODES}
    for label, primes, size, nega, rows, timed in shapes:
        equal_to_plain(label, primes, size, nega, min(rows, 32), gen, report)
        xb, plan = equal_to_plain(label, primes, size, nega, rows, gen, report)
        for inverse in (False, True):
            mode = cuda_ntt.mode_name(inverse, nega)
            ms = cuda_ms(lambda: cuda_ntt.ntt(xb, plan, inverse, nega))
            pms = cuda_ms(lambda: nttm.PLAIN_TWINS[(inverse, nega)](xb, plan), iters=3)
            bms = bound_ms(xb.numel())
            print(f"  time   {mode:15s} {label:28s} rows={rows}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {bms:.4f} ms ({100 * bms / ms:.1f} %)", flush=True)
            if mode in timed:
                report[mode].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                    shape=f"{label}, rows={rows}")
    return report


def split_vs_plain(params, params_streamed, cfg, small: bool):
    """Phase 2b: the split kernel == its plain versions at every shape; times
    at the witness maps' shapes; the two CTA orders of the shared-memory
    kernel at the seeded MAC's encoding shape."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.snark import seeded

    ring, ectx = params.ring, params.enc
    mi = (1 << cfg["log_m"]) // 4 if small else nttm.SPLIT_MI  # full size: M = 4 mi
    slot_rows = min(1024, ring.N)
    # (M, primes): the witness maps' iNTT at M and product at 2M, the seeded
    # path's (M = 4 mi) and the streamed path's (M = 16 mi), on the outer
    # primes of each (roots of order 2M for the negacyclic modes)
    streamed_primes = params_streamed.ring.primes
    shapes = [(4 * mi, ring.primes), (8 * mi, ring.primes),
              (16 * mi, streamed_primes), (32 * mi, streamed_primes)]
    rows = slot_rows
    gen = torch.Generator(device="cuda").manual_seed(4321)
    report = {m: {"max_abs_err": 0, "ms": None, "plain_ms": None, "full_twin_ms": None,
                  "shape": None, "bound_ms": None, "streamed": None}
              for m in cuda_ntt.SPLIT_MODES}
    for M, primes in shapes:
        x = torch.cat([torch.randint(0, p, (rows, 1, M), generator=gen, dtype=torch.int32,
                                     device="cuda") for p in primes], dim=1)
        for nega in (False, True):
            plan = nttm.get_plan(tuple(primes), M, negacyclic=nega)
            for inverse in (False, True):
                mode = "split_" + cuda_ntt.mode_name(inverse, nega)
                got = cuda_ntt.ntt_split(x, plan, inverse, nega, mi=mi)
                plain = nttm.ntt_split_plain(x, plan, inverse, nega, mi=mi)
                full = nttm.PLAIN_TWINS[(inverse, nega)](x, plan)
                err = max(int((got.to(torch.int64) - w.to(torch.int64)).abs().max())
                          for w in (plain, full))
                report[mode]["max_abs_err"] = max(report[mode]["max_abs_err"], err)
                check(torch.equal(got, plain) and torch.equal(got, full),
                      f"{mode} kernel != plain at M={M}, rows={rows}")
                if not inverse:
                    fwd = got
                print(f"  equal  {mode:21s} M={M:<7d} rows={rows}", flush=True)
                del got, plain, full
                ms = cuda_ms(lambda: cuda_ntt.ntt_split(x, plan, inverse, nega, mi=mi))
                pms = cuda_ms(lambda: nttm.ntt_split_plain(x, plan, inverse, nega, mi=mi),
                              iters=3)
                fms = cuda_ms(lambda: nttm.PLAIN_TWINS[(inverse, nega)](x, plan), iters=3)
                bms = bound_ms(x.numel())
                print(f"  time   {mode:21s} M={M:<7d} rows={rows}: kernel {ms:.4f} ms, "
                      f"plain split {pms:.4f} ms, full twin {fms:.4f} ms, bound {bms:.4f} ms "
                      f"({100 * bms / ms:.1f} %)", flush=True)
                # the witness maps' shapes: the cyclic inverse at M
                # (interpolation), the forward at 2M (the H product)
                times = dict(ms=ms, plain_ms=pms, full_twin_ms=fms, bound_ms=bms,
                             shape=f"M={M}, L={len(primes)}, rows={rows}")
                if M == (4 * mi if inverse and not nega else 8 * mi):
                    report[mode].update(times)
                if M == (16 * mi if inverse and not nega else 32 * mi):
                    report[mode]["streamed"] = times
            back = cuda_ntt.ntt_split(fwd, plan, True, nega, mi=mi)
            check(torch.equal(back, x), f"split inverse(forward(x)) != x at M={M}, nega={nega}")
        del x

    # CTA orders of the shared-memory kernel at the seeded MAC's encoding
    # shape: one row sub-chunk of plaintexts, [rows, L * L', N']
    rows = seeded._sub_rows(ectx) * ring.L
    plan = ectx.inner_plan(0)
    x = torch.cat([torch.randint(0, p, (rows, 1, ectx.n_inner), generator=gen,
                                 dtype=torch.int32, device="cuda") for p in plan.primes], dim=1)
    orders = {}
    for inverse in (False, True):
        want = nttm.PLAIN_TWINS[(inverse, True)](x, plan)
        for order in cuda_ntt.CTA_ORDERS:
            got = cuda_ntt.ntt(x, plan, inverse, True, order=order)
            check(torch.equal(got, want), f"CTA order {order} != twin (inverse={inverse})")
        # alternate the two orders so drift hits both alike
        for order in cuda_ntt.CTA_ORDERS + cuda_ntt.CTA_ORDERS[::-1]:
            ms = cuda_ms(lambda: cuda_ntt.ntt(x, plan, inverse, True, order=order), iters=20)
            key = f"negacyclic_{'inv' if inverse else 'fwd'}_{order}_ms"
            orders[key] = min(orders.get(key, ms), ms)
    print(f"  CTA order at N'={ectx.n_inner}, L'={plan.L}, rows={rows}: {orders}; the path "
          f"uses {cuda_ntt.CTA_ORDER!r}", flush=True)
    orders.update(shape=f"N'={ectx.n_inner}, L'={plan.L}, rows={rows}", used=cuda_ntt.CTA_ORDER)
    return report, orders


LARGE_SPLIT_LOG_M = (20, 21, 22)  # phase 2c: the sizes past the one-pass split of 2^19
LARGE_SPLIT_TIMED_BYTES = 1 << 29  # the timed batch: 512 MiB of residues


def large_split_vs_plain(split_report):
    """Phase 2c: the split route past 2^19 (inner size 32768; two outer
    passes from 2^21), through the dispatcher, in all four modes against the
    full-size plain twin at 2^20, 2^21 and 2^22 (equal, inverse(forward(x))
    == x); the cyclic modes timed at 2^20 and 2^21 on a 512 MiB batch, with
    the bound and the plain twin's time there (into split_report[mode]
    ["large"])."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.ops.primes import find_ntt_primes

    primes = tuple(find_ntt_primes(2, 1 << (max(LARGE_SPLIT_LOG_M) + 1)))
    gen = torch.Generator(device="cuda").manual_seed(2468)
    dispatch = {(False, False): nttm.cyclic_ntt_rev, (True, False): nttm.cyclic_intt_nat,
                (False, True): nttm.negacyclic_ntt_rev, (True, True): nttm.negacyclic_intt_nat}

    def residues(rows, M):
        return torch.cat([torch.randint(0, p, (rows, 1, M), generator=gen, dtype=torch.int32,
                                        device="cuda") for p in primes], dim=1)

    for log_m in LARGE_SPLIT_LOG_M:
        M = 1 << log_m
        mi = nttm.split_mi(M)
        passes = len(cuda_ntt.outer_passes(log_m - mi.bit_length() + 1, False))
        x = residues(2, M)
        for nega in (False, True):
            plan = nttm.get_plan(primes, M, negacyclic=nega)
            for inverse in (False, True):
                mode = "split_" + cuda_ntt.mode_name(inverse, nega)
                before = cuda_ntt.launch_counts[mode]
                got = dispatch[(inverse, nega)](x, plan)
                check(cuda_ntt.launch_counts[mode] == before + 1, f"{mode} not routed at 2^{log_m}")
                want = nttm.PLAIN_TWINS[(inverse, nega)](x, plan)
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                split_report[mode]["max_abs_err"] = max(split_report[mode]["max_abs_err"], err)
                check(torch.equal(got, want), f"{mode} kernel != plain twin at M=2^{log_m}")
                back = dispatch[(not inverse, nega)](got, plan)
                check(torch.equal(back, x), f"{mode}: inverse(forward(x)) != x at M=2^{log_m}")
                print(f"  equal  {mode:21s} M=2^{log_m} rows=2 L=2 (inner {mi}, {passes} "
                      "outer pass(es))", flush=True)
                del got, want, back
        del x
        if log_m > 21:
            continue
        rows = LARGE_SPLIT_TIMED_BYTES // (4 * len(primes) * M)
        xb = residues(rows, M)
        plan = nttm.get_plan(primes, M)
        for inverse in (False, True):
            mode = "split_" + cuda_ntt.mode_name(inverse, False)
            ms = cuda_ms(lambda: dispatch[(inverse, False)](xb, plan))
            pms = cuda_ms(lambda: nttm.PLAIN_TWINS[(inverse, False)](xb, plan), iters=1)
            bms = bound_ms(xb.numel())
            split_report[mode].setdefault("large", {})[f"M=2^{log_m}"] = dict(
                ms=ms, plain_ms=pms, bound_ms=bms, share_of_bound=bms / ms,
                shape=f"M=2^{log_m}, L={len(primes)}, rows={rows}")
            print(f"  time   {mode:21s} M=2^{log_m} rows={rows} L={len(primes)}: kernel "
                  f"{ms:.4f} ms, plain twin {pms:.4f} ms, bound {bms:.4f} ms "
                  f"({100 * bms / ms:.1f} %)", flush=True)
        del xb
    # the device tables cached for these sizes would stay on the card
    # through every later phase and raise each one's peak
    for cached in (nttm._twin_tables, nttm._split_twin_tables, cuda_ntt._tables,
                   cuda_ntt._split_tables):
        cached.cache_clear()
    torch.cuda.empty_cache()


# phase 2d: the draws, the lift and the encryption at the shapes the paths
# give them, (parameters, slab, rows of the sub-chunk): the north star's
# encryption sub-chunk (L=1, L'=4, N'=16384), Z_q's short last sub-chunk of
# one limb (L=1, L'=3, N'=4096), logistic regression's encode chunk (ring
# L=2, L'=4, N'=16384); and models/fhe.py's signed span 13 at logreg's N.
# The lift without its error at phase 2e's operand shapes (MAC_SHAPES).
PRNG_SHAPES = {
    "north_star": (lambda: make_params(FULL_STREAMED, "cuda"), 4096, (1024, 1536)),
    "zq": (lambda: zq_limb_params(4096, 18), 4096, (2730, 4096)),
    "logreg": (lambda: make_circuit_params(REFERENCE_CIRCUITS["logreg"], "cuda"), 32, None),
}
SMALL_PRNG_SHAPES = {
    "north_star": (lambda: make_params(SMALL_STREAMED, "cuda"), 256, (64, 128)),
    "zq": (lambda: zq_limb_params(512, 11), 256, (170, 256)),
    "logreg": (lambda: make_circuit_params(SMALL_CIRCUITS["logreg"], "cuda"), 32, None),
}
FHE_SPAN = dict(full=(256, 1, 2048), small=(8, 1, 64))  # (rows, 1, N): randint in [-6, 7)
PRNG_SOURCE = "ringsnark_tpu_torch/csrc/prng.cu"
# the JAX package draws, lifts and encrypts with jax.random and XLA: it has
# no Pallas kernel for them, so each names the function it is the
# counterpart of
PRNG_REPLACES = {
    "uniform": "ringsnark_tpu/encoding/bgv.py:85",  # _sample_uniform (jax.random.randint)
    "cbd_error": "ringsnark_tpu/encoding/bgv.py:110",  # _sample_error_ntt (jax.random.bits)
    "lift": "ringsnark_tpu/encoding/bgv.py:49",  # _lift_centered (+ the error of :110)
    "encrypt": "ringsnark_tpu/encoding/bgv.py:159",  # _encrypt_from_m
}


class Ops(NamedTuple):
    """Integer operations, by the pipe of an H100 SM they issue on: `alu`
    (funnel shifts, logic, three-input adds, compares, selects, min),
    `fma` (the integer multiplies, IMAD*, on the FMA pipe), `either`
    (two-input adds, negations and moves, which issue as IADD3 on the ALU or
    IMAD.IADD / IMAD.MOV on the FMA pipe) and `popc` (population counts).
    A count is the least a unit of work needs: key sums, constants and
    limb-only work hoisted out of the loops over words and columns, adds
    fused as the kernels fuse them, no address arithmetic or loads."""

    alu: float = 0
    fma: float = 0
    either: float = 0
    popc: float = 0

    def __add__(self, o):
        return Ops(*(x + y for x, y in zip(self, o)))

    def __mul__(self, k):
        return Ops(*(x * k for x in self))

    __rmul__ = __mul__


# Each pipe's rate on the H100 SXM (132 SMs): the guide's float32 peak, 67
# TFLOP/s, is 128 FMA lanes an SM at 2 operations each, so one warp
# instruction a clock per scheduler issues 128 lanes an SM (ISSUE); the
# integer ALU and the FMA pipe's integer multiplier each have 64 lanes an
# SM and run side by side; population count has 16.
ISSUE_OPS_PER_S = 67e12 / 2
ALU_OPS_PER_S = FMA_OPS_PER_S = 67e12 / 4
POPC_OPS_PER_S = 67e12 / 16
# threefry2x32, one word y0 ^ y1: 20 funnel-shift rotations and 21 xors on
# the ALU; 20 round adds, 8 key injections and the last 2, and the
# counter's add into x1 as two-input adds
HASH = Ops(alu=41, either=31)
MOD = Ops(alu=1, fma=2)  # w mod span: multiply-high, multiply-add by -span, min(x, x - span)
SHOUP = Ops(alu=1, fma=3)  # a * w mod p: multiply-high, multiply, multiply-add by -p, min
SUB_MOD = Ops(alu=1, either=2)  # a - b mod p: add p, subtract, min
ADD_MOD = Ops(alu=1, either=1)  # add, min
# the lift's two conditional steps a column (v > t/2 is the limb's, once a
# coefficient; Q - t a constant): add Q - t, select; subtract Q, compare,
# select
LIFT_COLUMN = Ops(alu=3, either=2)
LIFT_COEFF = Ops(alu=1)  # v > t/2
ERROR_COLUMN = Ops(alu=1, either=1)  # e's residue: Q + e, select (e < 0 once a coefficient)
# a canonical MAC term a * w mod Q_j (a < 2^31, w < Q_j) with the operand
# word's Shoup constant w_sh: umulhi(a, w_sh), a * w, and the product of
# the quotient by Q_j fused with the subtract (3); r - Q_j and min(r, r -
# Q_j); half of a pair's 32-bit add and half of its 64-bit add into the
# accumulator (one IMAD.WIDE a pair)
MAC_TERM = Ops(alu=1, fma=3, either=2)
# an operand word's Shoup constant from mu_j = floor(2^64 / Q_j)'s halves:
# w * mu_hi + umulhi(w, mu_lo), once a word for both components
MAC_OPERAND = Ops(fma=2)


def cbd_ops(n_words: int) -> Ops:
    """The CBD error of one coefficient: 2 n_words hashes, their popcounts
    and sums, the last words masked, the sign tested once."""
    return n_words * (2 * HASH + Ops(popc=2, either=1)) + Ops(alu=3)


def ops_seconds(ops: Ops) -> float:
    """The least time of `ops` on the card: the busiest pipe, with the
    two-input adds and moves spread over the ALU and the FMA pipe."""
    return max(ops.alu / ALU_OPS_PER_S, ops.fma / FMA_OPS_PER_S, ops.popc / POPC_OPS_PER_S,
               sum(ops) / ISSUE_OPS_PER_S)


def prng_bound(ops: Ops, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations' least time
    (`ops_seconds`) and the bytes at the card's memory rate."""
    t_ops, t_bytes = ops_seconds(ops) * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prng_vs_plain(small: bool) -> dict:
    """Phase 2d: each draw, lift and encryption kernel == its plain version
    on the same inputs at each shape of PRNG_SHAPES (max abs err 0), then
    both timed (CUDA events) beside the bound: the lift with its error
    (`_lift_error_plain`), the encryption from u = NTT(lift + t*e) with c1
    and with c0 alone (`_encrypt_from_u` over `_uniform_plain`); the lift
    alone (`_lift_centered`) at each plaintext operand shape of MAC_SHAPES.
    The first shape's numbers head each kernel's report.  Launches made
    here are not a path's."""
    from ringsnark_tpu_torch.encoding import bgv, encoding, keygen
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.snark import seeded
    from ringsnark_tpu_torch.utils import prng

    report = {k: {"max_abs_err": 0, "shapes": []} for k in cuda_prng.KERNELS}

    def hold(kernel, label, fn, plain, ops, nbytes, timed=None):
        """fn() == plain() on the card; then `timed` (fn by default) timed
        eagerly (ms: with the host's wrapper, as every phase times a kernel)
        and from a replayed CUDA graph (graph_ms: the device alone), the
        plain version eagerly."""
        got, want = fn(), plain()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        check(got.shape == want.shape and torch.equal(got, want),
              f"prng {kernel} kernel != its plain version at {label}")
        timed = timed or fn
        ms, gms, pms = cuda_ms(timed), graph_ms(timed), cuda_ms(plain, iters=2)
        bms, by = prng_bound(ops, nbytes)
        r = report[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(dict(shape=label, ms=ms, graph_ms=gms, plain_ms=pms, bound_ms=bms,
                                bound_by=by, share_of_bound=bms / ms,
                                graph_share_of_bound=bms / gms, max_abs_err=err))
        print(f"  prng {kernel:9s} {label:58s}: equal; kernel {ms:.4f} ms (graph {gms:.4f}), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f} %; "
              f"graph {100 * bms / gms:.1f} %)", flush=True)

    def slots_of(ring, n, gen):
        return torch.cat([torch.randint(0, p, (n, 1, ring.N), generator=gen, dtype=torch.int32,
                                        device="cuda") for p in ring.primes], dim=1)

    for name, (make, slab, rows) in (SMALL_PRNG_SHAPES if small else PRNG_SHAPES).items():
        params = make()
        ring, ctx = params.ring, params.enc
        _, sk = keygen(ctx, np.random.default_rng(41))
        k_a, k_e = prng.split(prng.key(42))
        batch, n = (slab,), slab if rows is None else rows[1] - rows[0]
        lo = 0 if rows is None else rows[0]
        label = (f"{name} rows {rows or (0, slab)} of {slab}, L={ctx.L} L'={ctx.L_inner} "
                 f"N'={ctx.n_inner}")
        words = n * ctx.L * ctx.L_inner * ctx.n_inner
        coeffs = n * ctx.L * ctx.n_inner
        n_words = -(-bgv._cbd_k(ctx.error_stddev) // 32)
        slots = slots_of(ring, n, torch.Generator(device="cuda").manual_seed(43))
        pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
        u = nttm.negacyclic_ntt_rev(bgv._lift_error_plain(ctx, pt, k_e, batch, rows),
                                    ctx.inner_plan(0))
        hold("uniform", label, lambda: bgv._sample_uniform(ctx, k_a, batch, rows),
             lambda: bgv._uniform_plain(ctx, k_a, batch, rows),
             words * (HASH + MOD), 4 * words)
        hold("cbd_error", label, lambda: bgv._sample_error_coeffs(ctx, k_e, batch, rows),
             lambda: bgv._error_coeffs_plain(ctx, k_e, batch, rows),
             coeffs * (cbd_ops(n_words) + ctx.L_inner * ERROR_COLUMN), 4 * coeffs * ctx.L_inner)
        hold("lift", f"{label}, with the error", lambda: bgv._lift_error(ctx, pt, k_e, batch, rows),
             lambda: bgv._lift_error_plain(ctx, pt, k_e, batch, rows),
             coeffs * (cbd_ops(n_words) + LIFT_COEFF
                       + ctx.L_inner * (LIFT_COLUMN + ERROR_COLUMN + SHOUP + ADD_MOD)),
             4 * pt.numel() + 4 * words)
        s_bytes = 8 * ctx.L * ctx.L_inner * ctx.n_inner
        enc_ops = words * (HASH + MOD + SHOUP + SUB_MOD)
        out = torch.empty_like(u)
        for with_c1 in (True, False):
            def run(with_c1=with_c1):  # (c0, c1), or (c0 written into `out`, None)
                return cuda_prng.encrypt(ctx, sk, u, k_a, batch, rows,
                                         None if with_c1 else out)

            def plain(with_c1=with_c1):
                c = bgv._encrypt_from_u(ctx, sk.s_ntt, u, bgv._uniform_plain(ctx, k_a, batch, rows))
                return torch.stack(c) if with_c1 else c[0]

            hold("encrypt", f"{label}, {'c0 and c1' if with_c1 else 'c0 alone'}",
                 lambda run=run, with_c1=with_c1: torch.stack(run()) if with_c1 else run()[0],
                 plain, enc_ops, (12 if with_c1 else 8) * words + s_bytes, timed=run)
        check(torch.equal(torch.stack(bgv.encrypt(ctx, sk, slots, prng.key(42), slab, lo)),
                          torch.stack(bgv._encrypt_from_u(
                              ctx, sk.s_ntt, u, bgv._uniform_plain(ctx, k_a, batch, rows)))),
              f"bgv.encrypt != the plain schedule at {label}")
        del params, ctx, sk, slots, pt, u, out
    held = set()
    for name, (make, P, _) in (SMALL_MAC_SHAPES if small else MAC_SHAPES).items():
        if name.split("_P")[0] in held:  # one operand shape a configuration
            continue
        held.add(name)
        params = make()
        ring, ctx = params.ring, params.enc
        n = (encoding._chunk_rows(ctx, ctx.L_inner) if name == "logreg"
             else seeded._sub_rows(ctx))
        slots = slots_of(ring, n, torch.Generator(device="cuda").manual_seed(44))
        pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
        label = (f"{name} operand {n} rows, L={ctx.L} L'={ctx.L_inner} N'={ctx.n_inner}"
                 f"{' (broadcast)' if bgv._scalar(ctx, slots) else ''}, one of {P}")
        hold("lift", label, lambda: bgv._lift(ctx, pt, 0),
             lambda: bgv._lift_centered(ctx, pt, 0).to(torch.int32),
             pt.numel() * (LIFT_COEFF + ctx.L_inner * LIFT_COLUMN),
             4 * pt.numel() * (1 + ctx.L_inner))
        del params, ctx, slots, pt
    shape = FHE_SPAN["small" if small else "full"]
    values = math.prod(shape)
    hold("uniform", f"fhe randint [-6, 7) {shape}",
         lambda: prng.randint(prng.key(44), shape, 7, "cuda", minval=-6),
         lambda: prng.randint_plain(prng.key(44), shape, 7, "cuda", minval=-6),
         values * (2 * HASH + 3 * MOD + Ops(fma=1, either=1)), 8 * values)
    for r in report.values():
        r.update({k: v for k, v in r["shapes"][0].items() if k != "max_abs_err"})
    torch.cuda.empty_cache()
    return report


# phase 2e: the MAC kernels at the shapes the paths give them, rows from the
# paths' own rules: the north star's row sub-chunk (seeded._sub_rows: 512
# rows, L=1, L'=4, N'=16384) with A and B together (`s_pows`) and with one
# operand (`delta_ts`, `delta_mid`: two thirds of the seeded prove's
# launches), Z_q's seeded sub-chunk with its broadcast operand (910 rows at
# L=3, L'=3, N'=4096), logistic regression's resident chunk
# (encoding._chunk_rows: 128 rows, L=2, L'=4, N'=16384; one operand);
# (parameters, operands, the drawn c1's slab row lo)
MAC_SHAPES = {
    "north_star": (lambda: make_params(FULL_STREAMED, "cuda"), 2, 1024),
    "north_star_P1": (lambda: make_params(FULL_STREAMED, "cuda"), 1, 1536),
    "zq": (lambda: zq_params(3, 4096, 18), 2, 2730),
    "logreg": (lambda: make_circuit_params(REFERENCE_CIRCUITS["logreg"], "cuda"), 1, 0),
}
SMALL_MAC_SHAPES = {
    "north_star": (lambda: make_params(SMALL_STREAMED, "cuda"), 2, 64),
    "north_star_P1": (lambda: make_params(SMALL_STREAMED, "cuda"), 1, 96),
    "zq": (lambda: zq_params(3, 512, 11), 2, 170),
    "logreg": (lambda: make_circuit_params(SMALL_CIRCUITS["logreg"], "cuda"), 1, 0),
}
MAC_SLAB = 4096  # the drawn c1's slab (seeded.DEFAULT_SLAB; --small: the rows' end)
MAC_SOURCE = "ringsnark_tpu_torch/csrc/mac.cu"
# the JAX package's MAC is XLA's (a jitted scan): no Pallas kernel stands
# behind these, so each names the function it is the counterpart of
MAC_REPLACES = {
    "mac": "ringsnark_tpu/encoding/encoding.py:193",  # inner_product (the u64 scan body :345)
    "mac_drawn": "ringsnark_tpu/snark/seeded.py:296",  # _seeded_mac_kernel, c1 regenerated
}


def mac_vs_plain(small: bool) -> dict:
    """Phase 2e: `mac` and `mac_drawn` == `mac_plain` on the same inputs at
    each shape of MAC_SHAPES (max abs err 0; the operands from
    `bgv.plain_to_inner_ntt`, so Z_q's is the broadcast it is on the path),
    then both timed beside the bound (`prng_bound`: the operations' least
    time on the card's pipes, or the bytes at 3.35 TB/s: c0, c1 or its key,
    the operands, the accumulators read and written): the kernel eagerly
    (ms, CUDA events around ten calls, the host's wrapper in them) and from
    a replayed CUDA graph (graph_ms, the device alone), the plain version
    eagerly.  Launches made here are not a path's."""
    from ringsnark_tpu_torch.encoding import bgv, encoding, mac
    from ringsnark_tpu_torch.ops import cuda_mac
    from ringsnark_tpu_torch.snark import seeded
    from ringsnark_tpu_torch.utils import prng

    report = {k: {"max_abs_err": 0, "shapes": []} for k in cuda_mac.KERNELS}
    for name, (make, P, lo) in (SMALL_MAC_SHAPES if small else MAC_SHAPES).items():
        params = make()
        ring, ctx = params.ring, params.enc
        n = (encoding._chunk_rows(ctx, ctx.L_inner) if name == "logreg"
             else seeded._sub_rows(ctx))
        width = ctx.L * ctx.L_inner * ctx.n_inner
        gen = torch.Generator(device="cuda").manual_seed(46)

        def residues(rows, primes, last):
            return torch.cat([torch.randint(0, p, (rows, 1, last), generator=gen,
                                            dtype=torch.int32, device="cuda")
                              for p in primes], dim=1)

        c0 = residues(n * ctx.L, ctx.inner_primes, ctx.n_inner).reshape(
            n, ctx.L, ctx.L_inner, ctx.n_inner).contiguous()
        c1 = residues(n * ctx.L, ctx.inner_primes, ctx.n_inner).reshape(c0.shape).contiguous()
        pts = [bgv.plain_to_inner_ntt(ctx, residues(n, ring.primes, ring.N), 0)
               for _ in range(P)]
        bcast = pts[0].stride(-1) == 0
        drawn = mac.Drawn(prng.key(47), (max(MAC_SLAB, lo + n),), (lo, lo + n))
        label = (f"{name} {n} rows, L={ctx.L} L'={ctx.L_inner} N'={ctx.n_inner}, P={P}"
                 f"{', broadcast operand' if bcast else ''}")
        words = P * n * (ctx.L * ctx.L_inner if bcast else width)  # the operands'
        nbytes = 4 * words + 2 * 2 * P * 8 * width  # the accumulators in and out
        mac_ops = 2 * P * n * width * MAC_TERM + words * MAC_OPERAND
        for kernel, c, ops, cbytes in (
            ("mac", c1, mac_ops, 8 * n * width),
            ("mac_drawn", drawn, mac_ops + n * width * (HASH + MOD), 4 * n * width),
        ):
            run = cuda_mac.mac if kernel == "mac" else cuda_mac.mac_drawn

            def accs():
                return [tuple(torch.zeros((ctx.L, ctx.L_inner, ctx.n_inner), dtype=torch.int64,
                                          device="cuda") for _ in range(2)) for _ in range(P)]

            got, want = accs(), accs()
            run(ctx, 0, c0, c, pts, got)
            mac.mac_plain(ctx, 0, c0, c, pts, want)
            err = max(int((g - w).abs().max()) for pair in zip(got, want) for g, w in
                      zip(*pair))
            check(all(torch.equal(g, w) for pair in zip(got, want) for g, w in zip(*pair)),
                  f"mac kernel {kernel} != mac_plain at {label}")
            ms, gms = cuda_ms(lambda: run(ctx, 0, c0, c, pts, got)), graph_ms(
                lambda: run(ctx, 0, c0, c, pts, got))
            pms = cuda_ms(lambda: mac.mac_plain(ctx, 0, c0, c, pts, want), iters=2)
            bms, by = prng_bound(ops, nbytes + cbytes)
            r = report[kernel]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["shapes"].append(dict(shape=label, ms=ms, graph_ms=gms, plain_ms=pms, bound_ms=bms,
                                    bound_by=by, share_of_bound=bms / ms,
                                    graph_share_of_bound=bms / gms, max_abs_err=err))
            print(f"  {kernel:9s} {label:60s}: equal; kernel {ms:.4f} ms (graph {gms:.4f}), "
                  f"plain {pms:.4f} ms, bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f} %; "
                  f"graph {100 * bms / gms:.1f} %)", flush=True)
        del params, ctx, c0, c1, pts
    for r in report.values():
        r.update({k: v for k, v in r["shapes"][0].items() if k != "max_abs_err"})
    torch.cuda.empty_cache()
    return report


def main_path(params, cfg, meshes, card):
    """Phase 3: generator -> prover x2 -> verifier (+ tampered); then, its
    launch counts read, the sharded prover on both meshes (phase 13)."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.snark import groth16
    from ringsnark_tpu_torch.utils import prng

    ring = params.ring
    M = 1 << cfg["log_m"]
    print(f"  config: ring N={ring.N} L={ring.L} primes={ring.primes}, M=2^{cfg['log_m']}, "
          f"N'={params.enc.n_inner} L'={params.enc.L_inner} floor={params.enc.floor_limbs} "
          f"inner={params.enc.inner_primes}", flush=True)
    times = {}
    stage = make_stage(times)

    comp, primary, aux = stage(
        "circuit", lambda: build_synthetic_square_chain(ring, M, np.random.default_rng(0)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    kp = stage("setup", lambda: groth16.generator(comp, params, np.random.default_rng(1),
                                                  prng.key(0)))
    proof = stage("prove_cold", lambda: groth16.prover(kp.pk, primary, aux))
    proof2 = stage("prove_warm", lambda: groth16.prover(kp.pk, primary, aux))
    ok = stage("verify", lambda: groth16.verifier(kp.vk, primary, proof))
    bad = primary + 1
    rejected = not stage("verify_tampered", lambda: groth16.verifier(kp.vk, bad, proof))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    pk = kp.pk
    crs_bytes = sum(e.c0.numel() * 4 * 2 for e in (pk.alpha, pk.beta, pk.s_pows,
                                                    pk.gamma_io, pk.delta_mid, pk.delta_ts)
                    if e is not None)
    print(f"  CRS {crs_bytes / 2**30:.3f} GiB (c0 + c1, int32); peak allocated "
          f"{peak / 2**30:.3f} GiB; launches {counts}", flush=True)
    check(ok is True, "verifier rejected an honest proof")
    check(rejected, "verifier accepted a proof against a changed public input")
    check(all(a == b for a, b in zip((proof.A, proof.B, proof.C),
                                     (proof2.A, proof2.B, proof2.C))),
          "cold and warm proofs differ")
    for e in (proof.A, proof.B, proof.C):
        check(tuple(e.c0.shape) == (ring.L, params.enc.floor_limbs, params.enc.n_inner),
              f"proof element shape {tuple(e.c0.shape)}")
    for mode in (*cuda_ntt.MODES, *(f"prng_{k}" for k in ENCRYPTION), "mac"):
        check(counts[mode] > 0, f"kernel {mode} never launched on the main path")
    sharded_counts, sharded_times = sharded_groth16(kp, primary, aux, proof, meshes, card)
    return counts, times, crs_bytes, peak, sharded_counts, sharded_times


def small_cross_check():
    """Phase 4: the card's prover == the CPU plain-twin prover, bit for bit."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16
    from ringsnark_tpu_torch.utils import interop, prng

    cfg = dict(SMALL, log_m=6)
    p_gpu, p_cpu = make_params(cfg, "cuda"), make_params(cfg, "cpu")
    M = 1 << cfg["log_m"]
    comp, primary, aux = build_synthetic_square_chain(p_gpu.ring, M, np.random.default_rng(5))
    kp = groth16.generator(comp, p_gpu, np.random.default_rng(6), prng.key(7))
    proof = groth16.prover(kp.pk, primary, aux)
    kp_cpu = interop.keypair_from_numpy(p_cpu, interop.keypair_to_numpy(kp))
    _, primary_c, aux_c = build_synthetic_square_chain(p_cpu.ring, M, np.random.default_rng(5))
    proof_cpu = groth16.prover(kp_cpu.pk, primary_c, aux_c)
    for (g0, g1, gl), (c0, c1, cl) in zip(interop.proof_to_numpy(proof),
                                          interop.proof_to_numpy(proof_cpu)):
        check(gl == cl and np.array_equal(g0, c0) and np.array_equal(g1, c1),
              "card proof != CPU plain-twin proof on the small input")
    check(groth16.verifier(kp_cpu.vk, primary_c,
                           interop.proof_from_numpy(p_cpu, interop.proof_to_numpy(proof))),
          "CPU verifier rejected the card's proof")
    print(f"  small input (N={cfg['N']}, N'={cfg['n_inner']}, M=2^{cfg['log_m']}): "
          "card proof == CPU proof, CPU verifier accepts", flush=True)


def seeded_path(params, cfg):
    """Phase 5: generator_seeded -> prover_seeded x2 -> verifier (+ tampered)."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, seeded
    from ringsnark_tpu_torch.utils import prng

    ring, ectx = params.ring, params.enc
    M = 1 << cfg["log_m"]
    print(f"  config: ring N={ring.N} L={ring.L} primes={ring.primes}, M=2^{cfg['log_m']}, "
          f"N'={ectx.n_inner} L'={ectx.L_inner} floor={ectx.floor_limbs} "
          f"inner={ectx.inner_primes}, slab {seeded.DEFAULT_SLAB}", flush=True)
    times = {}
    stage = make_stage(times)

    comp, primary, aux = stage(
        "circuit", lambda: build_synthetic_square_chain(ring, M, np.random.default_rng(0)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    kp = stage("setup", lambda: seeded.generator_seeded(comp, params, np.random.default_rng(1),
                                                        prng.key(0)))
    proof = stage("prove_cold", lambda: seeded.prover_seeded(kp.pk, primary, aux))
    proof2 = stage("prove_warm", lambda: seeded.prover_seeded(kp.pk, primary, aux))
    ok = stage("verify", lambda: groth16.verifier(kp.vk, primary, proof))
    rejected = not stage("verify_tampered", lambda: groth16.verifier(kp.vk, primary + 1, proof))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    crs_bytes = kp.pk.c0_bytes()
    print(f"  seeded CRS {crs_bytes / 2**30:.3f} GiB resident (c0 of the seeded batches; "
          f"alpha, beta, gamma_io whole); peak allocated {peak / 2**30:.3f} GiB; "
          f"launches {counts}", flush=True)
    check(ok is True, "verifier rejected an honest seeded proof")
    check(rejected, "verifier accepted a seeded proof against a changed public input")
    check(all(a == b for a, b in zip((proof.A, proof.B, proof.C),
                                     (proof2.A, proof2.B, proof2.C))),
          "cold and warm seeded proofs differ")
    for e in (proof.A, proof.B, proof.C):
        check(tuple(e.c0.shape) == (ring.L, ectx.floor_limbs, ectx.n_inner),
              f"proof element shape {tuple(e.c0.shape)}")
    _launch_check(counts, M, "seeded", macs=SEEDED_MAC)
    return counts, times, crs_bytes, peak


def small_seeded_cross_check():
    """Phase 6: the card's seeded proof == the CPU's from the same keypair."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, seeded
    from ringsnark_tpu_torch.utils import interop, prng

    cfg = dict(SMALL, log_m=6)
    p_gpu, p_cpu = make_params(cfg, "cuda"), make_params(cfg, "cpu")
    M = 1 << cfg["log_m"]
    comp, primary, aux = build_synthetic_square_chain(p_gpu.ring, M, np.random.default_rng(8))
    kp = seeded.generator_seeded(comp, p_gpu, np.random.default_rng(9), prng.key(10), slab=16)
    proof = seeded.prover_seeded(kp.pk, primary, aux)
    kp_cpu = interop.keypair_from_numpy(p_cpu, interop.keypair_to_numpy(kp))
    _, primary_c, aux_c = build_synthetic_square_chain(p_cpu.ring, M, np.random.default_rng(8))
    proof_cpu = seeded.prover_seeded(kp_cpu.pk, primary_c, aux_c)
    for (g0, g1, gl), (c0, c1, cl) in zip(interop.proof_to_numpy(proof),
                                          interop.proof_to_numpy(proof_cpu)):
        check(gl == cl and np.array_equal(g0, c0) and np.array_equal(g1, c1),
              "card seeded proof != CPU seeded proof on the small input")
    check(groth16.verifier(kp_cpu.vk, primary_c,
                           interop.proof_from_numpy(p_cpu, interop.proof_to_numpy(proof))),
          "CPU verifier rejected the card's seeded proof")
    print(f"  small seeded input (N={cfg['N']}, N'={cfg['n_inner']}, M=2^{cfg['log_m']}, "
          "slab 16): card proof == CPU proof, CPU verifier accepts", flush=True)


ENCRYPTION = ("lift", "encrypt")  # the kernels of every encryption on the card


@contextlib.contextmanager
def one_ntt_per_encryption():
    """While open, every `bgv.encrypt` on a card context must launch its
    schedule's three steps once each: one forward NTT, one `lift` (with the
    error) and one `encrypt`.  Yields the list of the encryptions checked."""
    from ringsnark_tpu_torch.encoding import bgv
    from ringsnark_tpu_torch.ops import cuda_ntt, cuda_prng

    encrypt, seen = bgv.encrypt, []

    def steps():
        return (cuda_ntt.launch_counts["negacyclic_fwd"]
                + cuda_ntt.launch_counts["split_negacyclic_fwd"],
                cuda_prng.launch_counts["lift"], cuda_prng.launch_counts["encrypt"])

    def checked(ctx, sk, slots, *args, **kwargs):
        if not bgv._on_card(ctx) or slots.numel() == 0:
            return encrypt(ctx, sk, slots, *args, **kwargs)
        before = steps()
        out = encrypt(ctx, sk, slots, *args, **kwargs)
        launched = tuple(b - a for a, b in zip(before, steps()))
        check(launched == (1, 1, 1), f"an encryption launched {launched} (forward NTTs, lifts, "
              "encrypts), not one of each")
        seen.append(tuple(slots.shape))
        return out

    bgv.encrypt = checked
    try:
        yield seen
    finally:
        bgv.encrypt = encrypt
# the MAC kernel of a seeded prove: c1 drawn in its registers (no `uniform`
# draw writes it); every other prove launches `mac`
SEEDED_MAC = ("mac_drawn",)


def _launch_check(counts, M, path, draws=ENCRYPTION, macs=("mac",)):
    """Both negacyclic shared-memory modes, both cyclic modes of the
    witness map (split past MAX_KERNEL_M), the PRNG kernels `draws` and the
    MAC kernels `macs` must have launched."""
    from ringsnark_tpu_torch.ops import ntt as nttm

    inv = "split_cyclic_inv" if M > nttm.MAX_KERNEL_M else "cyclic_inv"
    fwd = "split_cyclic_fwd" if 2 * M > nttm.MAX_KERNEL_M else "cyclic_fwd"
    for mode in ("negacyclic_fwd", "negacyclic_inv", fwd, inv, *(f"prng_{k}" for k in draws),
                 *macs):
        check(counts[mode] > 0, f"kernel {mode} never launched on the {path} path")


def streamed_path(params, cfg):
    """Phase 7: stream_prove (setup + prove in one pass) -> verifier (+ tampered)."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, streamed
    from ringsnark_tpu_torch.utils import prng

    ring, ectx = params.ring, params.enc
    M = 1 << cfg["log_m"]
    plan = streamed.plan_chunks(M + 1, cfg["phase_rows"], cfg["slab"])
    print(f"  config: ring N={ring.N} L={ring.L} primes={ring.primes}, M=2^{cfg['log_m']}, "
          f"N'={ectx.n_inner} L'={ectx.L_inner} floor={ectx.floor_limbs} "
          f"inner={ectx.inner_primes}, slab {cfg['slab']}, phase_rows {cfg['phase_rows']}: "
          f"{plan[0]} chunks of {plan[1]} rows", flush=True)
    times = {}
    stage = make_stage(times)
    comp, primary, aux = stage(
        "circuit", lambda: build_synthetic_square_chain(ring, M, np.random.default_rng(0)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rec = streamed.StreamRecord(sync=True)
    proof, vk, _ = stage("setup_prove", lambda: streamed.stream_prove(
        comp, params, primary, aux, np.random.default_rng(1), prng.key(0), slab=cfg["slab"],
        phase_rows=cfg["phase_rows"], record=rec))
    ok = stage("verify", lambda: groth16.verifier(vk, primary, proof))
    rejected = not stage("verify_tampered", lambda: groth16.verifier(vk, primary + 1, proof))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    totals = {k: rec.total(k) for k in ("setup", "prove", "stream")}
    print(f"  record totals {totals}; sections {[(k, n, round(dt, 3)) for k, n, dt in rec.events]}",
          flush=True)
    print(f"  peak allocated {peak / 2**30:.3f} GiB; launches {counts}", flush=True)
    check(ok is True, "verifier rejected an honest streamed proof")
    check(rejected, "verifier accepted a streamed proof against a changed public input")
    for e in (proof.A, proof.B, proof.C):
        check(tuple(e.c0.shape) == (ring.L, ectx.floor_limbs, ectx.n_inner),
              f"proof element shape {tuple(e.c0.shape)}")
    _launch_check(counts, M, "streamed")
    # primary is a view into the (M+1)-row assignment (8 GiB at M=2^18): keep a copy
    return counts, times, totals, rec.events, peak, (proof, vk, type(primary)(primary.ctx, primary.res.clone()))


def rinocchio_path(params, cfg):
    """Phase 8: stream_prove_rinocchio -> rinocchio.verifier (+ tampered)."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import rinocchio, streamed
    from ringsnark_tpu_torch.utils import prng

    ring, ectx = params.ring, params.enc
    M = 1 << cfg["log_m"]
    print(f"  config: ring N={ring.N} L={ring.L}, M=2^{cfg['log_m']}, N'={ectx.n_inner} "
          f"L'={ectx.L_inner} floor={ectx.floor_limbs}, slab {cfg['slab']}, "
          f"phase_rows {cfg['phase_rows']}", flush=True)
    times = {}
    stage = make_stage(times)
    comp, primary, aux = stage(
        "circuit", lambda: build_synthetic_square_chain(ring, M, np.random.default_rng(2)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rec = streamed.StreamRecord(sync=True)
    proof, vk, _ = stage("setup_prove", lambda: streamed.stream_prove_rinocchio(
        comp, params, primary, aux, np.random.default_rng(3), prng.key(4), slab=cfg["slab"],
        phase_rows=cfg["phase_rows"], record=rec))
    ok = stage("verify", lambda: rinocchio.verifier(vk, primary, proof))
    rejected = not stage("verify_tampered", lambda: rinocchio.verifier(vk, primary + 1, proof))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    totals = {k: rec.total(k) for k in ("setup", "prove", "stream")}
    print(f"  record totals {totals}; peak allocated {peak / 2**30:.3f} GiB; launches {counts}",
          flush=True)
    check(proof.F is not None, "Rinocchio proof without F despite auxiliary inputs")
    check(ok is True, "verifier rejected an honest Rinocchio proof")
    check(rejected, "verifier accepted a Rinocchio proof against a changed public input")
    _launch_check(counts, M, "streamed Rinocchio")
    return counts, times, totals, peak


def small_streamed_cross_check():
    """Phase 9: streamed proofs on the card == the CPU's, bit for bit."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import amplify, groth16, rinocchio, streamed
    from ringsnark_tpu_torch.snark.api import KeyPair
    from ringsnark_tpu_torch.utils import interop, prng

    plan = dict(slab=16, phase_rows=32)

    def prove(params, which):
        comp, primary, aux = build_synthetic_square_chain(params.ring, 64,
                                                          np.random.default_rng(11))
        fn = streamed.stream_prove if which == "groth16" else streamed.stream_prove_rinocchio
        proof, vk, _ = fn(comp, params, primary, aux, np.random.default_rng(12), prng.key(13),
                          **plan)
        return proof, vk, comp, primary, aux

    for L in (1, 2):
        cfg = dict(SMALL, L=L, log_m=6)
        p_gpu, p_cpu = make_params(cfg, "cuda"), make_params(cfg, "cpu")
        for which in ("groth16", "rinocchio"):
            proof, _, comp, primary, aux = prove(p_gpu, which)
            again = interop.proof_to_numpy(prove(p_gpu, which)[0])
            proof_cpu, vk_cpu, _, primary_c, _ = prove(p_cpu, which)
            got = interop.proof_to_numpy(proof)
            for g, a, c in zip(got, again, interop.proof_to_numpy(proof_cpu)):
                check(all(x is None for x in (g, a, c)) or (
                    g[2] == a[2] == c[2] and np.array_equal(g[0], a[0])
                    and np.array_equal(g[1], a[1]) and np.array_equal(g[0], c[0])
                    and np.array_equal(g[1], c[1])),
                    f"L={L} {which}: card proofs differ from each other or from the CPU's")
            verify = groth16.verifier if which == "groth16" else rinocchio.verifier
            check(verify(vk_cpu, primary_c, interop.proof_from_numpy(p_cpu, got)),
                  f"L={L} {which}: CPU verifier rejected the card's streamed proof")
            check(which == "groth16" or proof.F is not None, "small Rinocchio proof without F")
        rp = amplify.prove_repeated(comp, p_gpu, primary, aux, np.random.default_rng(14),
                                    prng.key(15), 2, **plan)
        check(amplify.verify_repeated(rp, primary), f"L={L}: repeated proofs rejected")
        check(not amplify.verify_repeated(rp, primary + 1),
              f"L={L}: repeated proofs accepted a changed public input")
        # the card's streamed vk survives the trip to the CPU
        vk_c = interop.keypair_from_numpy(p_cpu, interop.keypair_to_numpy(
            KeyPair(pk=rp.vks[0].pk, vk=rp.vks[0]))).vk
        check(groth16.verifier(vk_c, primary_c, interop.proof_from_numpy(
            p_cpu, interop.proof_to_numpy(rp.proofs[0]))), f"L={L}: carried vk rejected")
        print(f"  small streamed input (L={L}, N={cfg['N']}, N'={cfg['n_inner']}, "
              f"M=2^{cfg['log_m']}, slab 16): card proofs == CPU proofs (ringGroth16, "
              "Rinocchio), repeatable, CPU verifiers accept; amplify K=2 verifies", flush=True)


def _proof_elements(proof):
    names = ("A", "B", "C") if not hasattr(proof, "A_prime") else (
        "A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")
    return [getattr(proof, n) for n in names]


def _crs_bytes(pk) -> int:
    """Device bytes of a resident CRS: c0 and c1 of every encoding of the key."""
    from ringsnark_tpu_torch.encoding import Encoding

    return sum((e.c0.numel() + e.c1.numel()) * e.c0.element_size()
               for e in vars(pk).values() if isinstance(e, Encoding))


def frontend_path(circuits, kernel_report, mesh, card):
    """Phase 10: Protoboard -> generator -> prover x2 -> verifier (+ tampered),
    both proof systems with a resident CRS, for every circuit; after each
    circuit's launch counts are read, the kernels are held to their plain
    twins at that circuit's shapes (into `kernel_report`).  On logistic
    regression's Rinocchio keypair the sharded prover runs on `mesh`
    (phase 13), its launches counted apart: the circuit's counts are read
    before it and set to 0 after it.  Returns (counts, report, sharded
    (counts, seconds))."""
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.utils import prng

    total = {m: 0 for m in read_counts()}
    report = {}
    for name, cfg in circuits.items():
        params = make_circuit_params(cfg, "cuda")
        ring, ectx = params.ring, params.enc
        print(f"  {name}: ring N={ring.N} L={ring.L} primes={ring.primes}, N'={ectx.n_inner} "
              f"L'={ectx.L_inner} floor={ectx.floor_limbs}, logT={cfg['log_t']}, "
              f"features={cfg['features']}", flush=True)
        times = {}
        stage = make_stage(times)
        carried = {}  # the circuit's counts read before the sharded prove
        reset_counts()
        pb = stage("build", lambda: build_circuit(name, cfg, ring, 0))
        check(stage("is_satisfied", pb.is_satisfied) is True, f"{name}: witness invalid")
        cs = pb.get_constraint_system()
        primary, aux = pb.primary_input(), pb.auxiliary_input()
        bad = [primary[0] + 1] + primary[1:]
        entry = {"config": cfg, "constraints": cs.num_constraints(),
                 "variables": cs.num_variables(), "inputs": cs.num_inputs(),
                 "build_s": times["build"], "is_satisfied_s": times["is_satisfied"]}
        for sname, system in (("rinocchio", rinocchio), ("groth16", groth16)):
            print(f"  {name}/{sname}:", flush=True)
            st = {}
            stage = make_stage(st)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kp = stage("setup", lambda: system.generator(cs, params, np.random.default_rng(1),
                                                         prng.key(1)))
            prove = lambda: system.prover(kp.pk, primary, aux, np.random.default_rng(7))  # noqa: E731
            proof = stage("prove_cold", prove)
            proof2 = stage("prove_warm", prove)
            ok = stage("verify", lambda: system.verifier(kp.vk, primary, proof))
            rejected = not stage("verify_tampered", lambda: system.verifier(kp.vk, bad, proof))
            peak = torch.cuda.max_memory_allocated()
            crs = _crs_bytes(kp.pk)
            entry["nnz"] = sum(int(r.numel()) for r in kp.pk.compiled.rows)
            entry["domain"] = kp.pk.domain.m
            entry[sname] = {"stage_s": st, "crs_gib": crs / 2**30,
                            "peak_allocated_gib": peak / 2**30,
                            "proof_bits": proof.size_in_bits()}
            print(f"    {cs.num_constraints()} constraints, {cs.num_variables()} variables, "
                  f"nnz {entry['nnz']}, domain {kp.pk.domain.m}; CRS {crs / 2**30:.3f} GiB; "
                  f"peak allocated {peak / 2**30:.3f} GiB; proof {proof.size_in_bits()} bits",
                  flush=True)
            check(ok is True, f"{name}/{sname}: verifier rejected an honest proof")
            check(rejected, f"{name}/{sname}: verifier accepted a changed public input")
            check(all(a == b for a, b in zip(_proof_elements(proof), _proof_elements(proof2))),
                  f"{name}/{sname}: cold and warm proofs differ")
            for e in _proof_elements(proof):
                check(e is None or tuple(e.c0.shape) == (ring.L, ectx.floor_limbs, ectx.n_inner),
                      f"{name}/{sname}: proof element shape")
            if sname == "rinocchio":
                check((proof.F is not None) == (len(aux) > 0),
                      f"{name}: F must be present exactly with auxiliary wires")
            if sname == "rinocchio" and name == "logreg":
                add_counts(carried, read_counts())
                sharded = sharded_rinocchio(kp, primary, aux, proof, mesh, 7, card)
                reset_counts()
            del kp, proof, proof2, prove
        counts = add_counts(read_counts(), carried)
        print(f"  {name}: launches {counts}", flush=True)
        for mode in ("negacyclic_fwd", "negacyclic_inv", "prng_lift", "prng_encrypt", "mac"):
            check(counts[mode] > 0, f"kernel mode {mode} never launched for {name}")
        entry["launches"] = counts
        for m, c in counts.items():
            total[m] += c
        circuit_kernels_vs_plain(params, entry["domain"], cfg["features"], kernel_report, 1000)
        report[name] = entry
        del pb, cs, primary, aux, bad
        torch.cuda.empty_cache()
    return total, report, sharded


def small_frontend_cross_check(kernel_report):
    """Phase 11: the card's frontend proofs == the CPU's from the carried
    keypair; the kernels == their plain twins at these small shapes too."""
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.utils import interop, prng

    systems = (
        ("rinocchio", rinocchio, interop.rinocchio_keypair_to_numpy,
         interop.rinocchio_keypair_from_numpy),
        ("groth16", groth16, interop.keypair_to_numpy, interop.keypair_from_numpy),
    )
    for name, cfg in (("logreg", dict(N=16, n_inner=512, log_t=16, features=4)),
                      ("plaintext_check", dict(N=16, n_inner=512, log_t=32, features=4))):
        p_gpu, p_cpu = make_circuit_params(cfg, "cuda"), make_circuit_params(cfg, "cpu")
        pb, pb_c = build_circuit(name, cfg, p_gpu.ring, 20), build_circuit(name, cfg, p_cpu.ring, 20)
        check(pb.is_satisfied() and pb_c.is_satisfied(), f"small {name}: witness invalid")
        for sname, system, to_np, from_np in systems:
            kp = system.generator(pb.get_constraint_system(), p_gpu, np.random.default_rng(21),
                                  prng.key(22))
            proof = system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                                  np.random.default_rng(23))
            kp_c = from_np(p_cpu, to_np(kp))
            proof_c = system.prover(kp_c.pk, pb_c.primary_input(), pb_c.auxiliary_input(),
                                    np.random.default_rng(23))
            got = interop.proof_to_numpy(proof)
            for g, c in zip(got, interop.proof_to_numpy(proof_c)):
                check((g is None and c is None) or (
                    g[2] == c[2] and np.array_equal(g[0], c[0]) and np.array_equal(g[1], c[1])),
                    f"small {name}/{sname}: card proof != CPU proof")
            check(system.verifier(kp_c.vk, pb_c.primary_input(),
                                  interop.proof_from_numpy(p_cpu, got)),
                  f"small {name}/{sname}: CPU verifier rejected the card's proof")
            check(system.verifier(kp.vk, pb.primary_input(), proof),
                  f"small {name}/{sname}: card verifier rejected its own proof")
        circuit_kernels_vs_plain(p_gpu, kp.pk.domain.m, cfg["features"], kernel_report, 1100)
        print(f"  small {name} (N={cfg['N']}, N'={cfg['n_inner']}, L=2): card proofs == CPU "
              "proofs (Rinocchio, ringGroth16), CPU verifiers accept", flush=True)


KEYS_DIR = Path(__file__).resolve().parent / "keys_out"  # listed in .gitignore
DISK_MARGIN = 2 << 30


def check_disk(need_bytes: int, what: str):
    """Refuse to write `need_bytes` into KEYS_DIR unless that much and a
    margin are free there."""
    free = shutil.disk_usage(KEYS_DIR).free
    if free < need_bytes + DISK_MARGIN:
        raise RuntimeError(f"{what}: {free / 2**30:.2f} GiB free in {KEYS_DIR}, need "
                           f"{need_bytes / 2**30:.2f} GiB and a margin of "
                           f"{DISK_MARGIN / 2**30:.0f} GiB")


def timed(times: dict, name: str, fn):
    """fn() timed with `profiling.timer` (synchronizing the card at both
    ends), into times[name]."""
    from ringsnark_tpu_torch.utils import profiling

    with profiling.timer(name, "cuda") as rec:
        out = fn()
    times[name] = rec.seconds
    print(f"  {name}: {rec.seconds:.3f} s", flush=True)
    return out


def _file_bytes(*paths) -> int:
    return sum(os.path.getsize(p) for p in paths)


def _proofs_equal(a, b) -> bool:
    return all((x is None and y is None) or (x is not None and y is not None and x == y)
               for x, y in zip(_proof_elements(a), _proof_elements(b)))


def keys_on_disk(cfg, north_star):
    """Phase 12: logistic regression at its published shape, resident
    Rinocchio then ringGroth16: generate, prove from memory, save_vk (the pk
    and its constraint system with it), drop the keypair, load_vk onto the
    card, prove from the loaded pk (== the proof from memory, bit for bit),
    save_proof / load_proof, verify with the loaded vk (True; False with a
    changed public input), delete the files.  Part of the Rinocchio pk is
    also written with np.savez_compressed (the JAX package's writer), beside
    np.savez (the port's).  Then phase 7's north-star vk (a CRS-less stub) is
    saved and loaded, and verifies phase 7's proof.  Returns the launch
    counts of the whole phase (set to 0 at its start) and the report."""
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.utils import prng
    from ringsnark_tpu_torch.utils import serialization as ser

    KEYS_DIR.mkdir(exist_ok=True)
    reset_counts()
    params = make_circuit_params(cfg, "cuda")
    pb = build_circuit("logreg", cfg, params.ring, 0)
    cs = pb.get_constraint_system()
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    bad = [primary[0] + 1] + primary[1:]
    report = {}
    for sname, system in (("rinocchio", rinocchio), ("groth16", groth16)):
        print(f"  logreg/{sname}:", flush=True)
        t = {}
        paths = {k: str(KEYS_DIR / f"{sname}_{k}") for k in
                 ("vk.npz", "pk.npz", "cs.json", "proof.npz")}
        kp = timed(t, "setup", lambda: system.generator(cs, params, np.random.default_rng(1),
                                                        prng.key(1)))
        proof_mem = timed(t, "prove_from_memory", lambda: system.prover(
            kp.pk, primary, aux, np.random.default_rng(7)))
        crs = _crs_bytes(kp.pk)
        check_disk(crs, f"logreg/{sname} keys")
        timed(t, "save_vk", lambda: ser.save_vk(paths["vk.npz"], kp.vk, paths["pk.npz"],
                                                 paths["cs.json"]))
        file_bytes = _file_bytes(paths["vk.npz"], paths["pk.npz"], paths["cs.json"])
        del kp
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        vk = timed(t, "load_vk", lambda: ser.load_vk(paths["vk.npz"]))
        load_peak = torch.cuda.max_memory_allocated()
        check(vk.pk.s_pows.c0.is_cuda and vk.sk_enc.s_ntt.is_cuda, "load_vk left the card")
        check(_crs_bytes(vk.pk) == crs, f"logreg/{sname}: the loaded CRS has another size")
        proof = timed(t, "prove_from_loaded", lambda: system.prover(
            vk.pk, primary, aux, np.random.default_rng(7)))
        check(_proofs_equal(proof, proof_mem),
              f"logreg/{sname}: proof from the loaded key != proof from the key in memory")
        check_disk(proof.size_in_bits() // 8, f"logreg/{sname} proof")
        timed(t, "save_proof", lambda: ser.save_proof(paths["proof.npz"], proof, params.enc))
        proof_bytes = _file_bytes(paths["proof.npz"])
        loaded = timed(t, "load_proof", lambda: ser.load_proof(paths["proof.npz"], system.Proof))
        check(_proofs_equal(loaded, proof), f"logreg/{sname}: load_proof changed the proof")
        check(timed(t, "verify_loaded", lambda: system.verifier(vk, primary, loaded)) is True,
              f"logreg/{sname}: the loaded vk rejected the loaded proof")
        check(not system.verifier(vk, bad, loaded),
              f"logreg/{sname}: the loaded vk accepted a changed public input")
        entry = {"stage_s": t, "crs_gib": crs / 2**30, "files_gib": file_bytes / 2**30,
                 "proof_file_mib": proof_bytes / 2**20, "load_held_gib": held / 2**30,
                 "load_peak_allocated_gib": load_peak / 2**30}
        if sname == "rinocchio":
            entry["compressed"] = stored_vs_compressed(paths["pk.npz"], t)
        for p in paths.values():
            if os.path.exists(p):
                os.remove(p)
        print(f"    CRS {crs / 2**30:.3f} GiB; files {file_bytes / 2**30:.3f} GiB (vk + pk + cs); "
              f"proof file {proof_bytes / 2**20:.1f} MiB; load peak allocated "
              f"{load_peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before); proof "
              "from the loaded key == proof from memory", flush=True)
        report[sname] = entry
        del vk, proof, proof_mem, loaded
        torch.cuda.empty_cache()

    # phase 7's north-star vk: a CRS-less stub (gamma_io and the compiled arrays)
    proof7, vk7, primary7 = north_star
    t = {}
    paths = [str(KEYS_DIR / f"north_star_{k}") for k in ("vk.npz", "pk.npz", "cs.json")]
    check_disk(vk7.pk.gamma_io.c0.numel() * 8 + (64 << 20), "the north-star vk")
    timed(t, "save_vk", lambda: ser.save_vk(paths[0], vk7, paths[1], paths[2]))
    file_bytes = _file_bytes(*paths[:2])
    vk = timed(t, "load_vk", lambda: ser.load_vk(paths[0]))
    check(vk.pk.s_pows is None and vk.pk.gamma_io == vk7.pk.gamma_io,
          "the north-star stub did not load as it was saved")
    check(timed(t, "verify", lambda: groth16.verifier(vk, primary7, proof7)) is True,
          "the reloaded north-star vk rejected phase 7's proof")
    check(not groth16.verifier(vk, primary7 + 1, proof7),
          "the reloaded north-star vk accepted a changed public input")
    for p in paths[:2]:
        os.remove(p)
    print(f"  north-star vk (M=2^18 stub): files {file_bytes / 2**20:.1f} MiB; the reloaded vk "
          "verifies phase 7's proof", flush=True)
    report["north_star_vk"] = {"stage_s": t, "files_mib": file_bytes / 2**20}
    counts = read_counts()
    print(f"  launches {counts}", flush=True)
    for mode in ("negacyclic_fwd", "negacyclic_inv", "cyclic_fwd", "cyclic_inv", "prng_lift",
                 "prng_encrypt", "mac"):
        check(counts[mode] > 0, f"kernel mode {mode} never launched on the keys path")
    return counts, report


# a quarter of s_pows_c0's rows: 0.25 GiB of the 8.0 GiB of logreg's Rinocchio pk
COMPRESSION_ARRAYS = ("s_pows_c0",)
COMPRESSION_SHARE = 4


def stored_vs_compressed(pk_path: str, t: dict) -> dict:
    """The port's writer (np.savez, stored) against the JAX package's
    (np.savez_compressed, deflate) on the first 1/COMPRESSION_SHARE of the
    rows of COMPRESSION_ARRAYS of a saved pk: the seconds to write each file
    and to read it back on the host, and its size; what is read back must
    equal what was written."""
    with np.load(pk_path) as data:
        store = {k: data[k][:(data[k].shape[0] + COMPRESSION_SHARE - 1) // COMPRESSION_SHARE]
                 for k in COMPRESSION_ARRAYS}
    nbytes = sum(a.nbytes for a in store.values())
    out = {"arrays": list(COMPRESSION_ARRAYS), "array_gib": nbytes / 2**30}
    for kind, writer in (("stored", np.savez), ("compressed", np.savez_compressed)):
        path = KEYS_DIR / f"compare_{kind}.npz"
        check_disk(nbytes, f"the {kind} comparison file")
        timed(t, f"save_{kind}", lambda: writer(path, **store))  # noqa: B023
        with np.load(path) as data:
            back = timed(t, f"load_{kind}", lambda: {k: data[k] for k in data.files})  # noqa: B023
        check(all(np.array_equal(back[k], store[k]) for k in store),
              f"the {kind} file reads back other arrays")
        out[kind] = {"gib": path.stat().st_size / 2**30, "save_s": t[f"save_{kind}"],
                     "load_s": t[f"load_{kind}"]}
        path.unlink()
        del back
    print(f"    {nbytes / 2**30:.3f} GiB of the pk ({', '.join(COMPRESSION_ARRAYS)}): stored "
          f"{out['stored']['gib']:.4f} GiB, compressed {out['compressed']['gib']:.4f} GiB "
          f"({100 * out['compressed']['gib'] / out['stored']['gib']:.2f} %)", flush=True)
    return out


def small_keys_cross_check():
    """Phase 12b: a key and a proof saved by the port on the card load in the
    port on the CPU; the CPU's proof from the loaded key equals the card's
    bit for bit, and the CPU verifier accepts the card's proof, loaded from
    its file."""
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.utils import prng
    from ringsnark_tpu_torch.utils import serialization as ser

    KEYS_DIR.mkdir(exist_ok=True)
    cfg = dict(N=16, n_inner=512, log_t=16, features=4)
    p_gpu, p_cpu = make_circuit_params(cfg, "cuda"), make_circuit_params(cfg, "cpu")
    pb, pb_c = build_circuit("logreg", cfg, p_gpu.ring, 30), build_circuit("logreg", cfg,
                                                                          p_cpu.ring, 30)
    for sname, system in (("rinocchio", rinocchio), ("groth16", groth16)):
        paths = [str(KEYS_DIR / f"small_{sname}_{k}") for k in
                 ("vk.npz", "pk.npz", "cs.json", "proof.npz")]
        check_disk(1 << 26, "the small keys")
        kp = system.generator(pb.get_constraint_system(), p_gpu, np.random.default_rng(31),
                              prng.key(32))
        proof = system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                              np.random.default_rng(33))
        ser.save_vk(paths[0], kp.vk, paths[1], paths[2])
        ser.save_proof(paths[3], proof, p_gpu.enc)
        vk_c = ser.load_vk(paths[0], device="cpu")
        check(vk_c.pk.s_pows.c0.device.type == "cpu", "load_vk(device='cpu') left the CPU")
        proof_c = system.prover(vk_c.pk, pb_c.primary_input(), pb_c.auxiliary_input(),
                                np.random.default_rng(33))
        loaded = ser.load_proof(paths[3], system.Proof, device="cpu")
        check(all((a is None and b is None) or torch.equal(a.c0.cpu(), b.c0)
                  and torch.equal(a.c1.cpu(), b.c1) and a.level == b.level
                  for a, b in zip(_proof_elements(proof), _proof_elements(proof_c))),
              f"small {sname}: the CPU proof from the loaded key != the card's proof")
        check(system.verifier(vk_c, pb_c.primary_input(), loaded),
              f"small {sname}: the CPU verifier rejected the card's proof from its file")
        for p in paths:
            os.remove(p)
    print(f"  small logreg (N={cfg['N']}, N'={cfg['n_inner']}, L=2): keys and proofs saved on "
          "the card load on the CPU; CPU proofs == card proofs (Rinocchio, ringGroth16)",
          flush=True)


HELD_ELEMS = 1 << 27  # phase 14: the largest batch a recorded shape is held at (512 MiB)


@contextlib.contextmanager
def recorded_shapes():
    """Every shape the dispatcher (`ops.ntt`) hands the two kernel wrappers
    while the block runs, as {(route, shape, primes, inverse, negacyclic,
    scale): calls}; the wrappers run, and count, as they do without it."""
    from ringsnark_tpu_torch.ops import cuda_ntt

    seen = {}
    saved = {"ntt": cuda_ntt.ntt, "split": cuda_ntt.ntt_split}

    def recording(route):
        def call(x, plan, inverse, negacyclic, scale=True, **kw):
            key = (route, tuple(x.shape), plan.primes, inverse, negacyclic, scale)
            seen[key] = seen.get(key, 0) + 1
            return saved[route](x, plan, inverse=inverse, negacyclic=negacyclic, scale=scale,
                                **kw)
        return call

    cuda_ntt.ntt, cuda_ntt.ntt_split = recording("ntt"), recording("split")
    try:
        yield seen
    finally:
        cuda_ntt.ntt, cuda_ntt.ntt_split = saved["ntt"], saved["split"]


def hold_recorded_shapes(label, seen, report, split_report, seed):
    """Each shape of `seen` (from `recorded_shapes`) held against the plain
    versions on random residues below its primes: the shared-memory kernel
    == its plain twin; the split route == `ntt_split_plain` == the
    full-size twin; the cyclic inverse unscaled where the path asked for it.
    A batch above HELD_ELEMS residues is held at fewer rows.  The largest
    difference goes into report / split_report[mode]["max_abs_err"]."""
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for (route, shape, primes, inverse, nega, scale), calls in sorted(seen.items(), key=str):
        M, L = shape[-1], len(primes)
        rows = math.prod(shape[:-2])
        held = max(1, min(rows, HELD_ELEMS // (L * M)))
        plan = nttm.get_plan(primes, M, negacyclic=nega)
        x = torch.cat([torch.randint(0, p, (held, 1, M), generator=gen, dtype=torch.int32,
                                     device="cuda") for p in primes], dim=1)
        full = (nttm.PLAIN_TWINS[(inverse, nega)](x, plan) if scale
                else nttm.cyclic_intt_nat_plain(x, plan, scale=False))
        mode = cuda_ntt.mode_name(inverse, nega)
        if route == "ntt":
            got = cuda_ntt.ntt(x, plan, inverse, nega, scale=scale)
            wants, rep = (full,), report[mode]
        else:
            mode = "split_" + mode
            got = cuda_ntt.ntt_split(x, plan, inverse, nega, scale=scale)
            wants = (nttm.ntt_split_plain(x, plan, inverse, nega, scale=scale), full)
            rep = split_report[mode]
        err = max(int((got.to(torch.int64) - w.to(torch.int64)).abs().max()) for w in wants)
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        dims = ", ".join(map(str, shape))
        check(all(torch.equal(got, w) for w in wants),
              f"{label}: {mode} kernel != plain at [{dims}], primes {primes}")
        print(f"  equal  {mode:21s} {label} [{dims}] L={L}{'' if scale else ' unscaled'} "
              f"({calls} call(s)), held at {held} of {rows} rows", flush=True)
        del x, full, got, wants
    torch.cuda.empty_cache()


def _script(label, main_fn, argv):
    """One entry point called in-process as `python -m` would call it."""
    print(f"  {label}: main({' '.join(argv)})", flush=True)
    t0 = time.perf_counter()
    out = main_fn(argv)
    torch.cuda.synchronize()
    print(f"  {label}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def bench_ntt(small: bool):
    """14a: scripts/bench, the north-star NTT [32, 6, 8192]: the kernel ==
    its plain twin in both directions and == the native C++ output (the
    script raises otherwise), timed beside the bound and the CPU legs."""
    from ringsnark_tpu_torch.scripts import bench

    row = _script("14a bench", bench.main, ["--batch", "4", "--rep", "2"] if small else [])
    print(f"  [{', '.join(map(str, row['shape']))}]: kernel {row['kernel_us']:.3f} us a batch "
          f"({row['us_per_transform']:.4f} us a transform, {row['value']:.0f} NTT/s, "
          f"{100 * row['kernel_share_of_bound']:.1f} % of the bound {row['bound_us']:.3f} us); "
          f"inverse {row['kernel_inv_us']:.3f} us ({100 * row['kernel_inv_share_of_bound']:.1f} %)"
          f"; from the host {row['kernel_eager_us']:.3f} / {row['kernel_inv_eager_us']:.3f} us; "
          f"plain twin {row['plain_us']:.3f} / {row['plain_inv_us']:.3f} us; CPU "
          f"{row['cpu_ntts_1core']:.1f} NTT/s on 1 thread ({row['cpu_rows_1core']} rows), "
          f"{row['cpu_ntts_socket']:.1f} on {row['cpu_threads']} ({row['cpu_rows_socket']} rows, "
          f"{row['cpu_model']}): {row['vs_baseline']:.1f}x the socket; max |kernel - twin| "
          f"{row['max_abs_err']}",
          flush=True)
    return row


def zq_streamed(small: bool, report, split_report):
    """14b: scripts/bench_prover, streamed ringGroth16 over Z_q (N=1, L=3,
    N'=4096, M=2^18, margin 4: L'=3, floor 2), one cold pass (the benchmark's
    zq3_g16_streamed_2e18 cell times it warm): it
    verifies and rejects a changed public input (the script raises
    otherwise); launches counted from 0 over the call, path `zq`; then
    every shape the call gave the kernels held against the plain versions
    (encryption at N'=4096 over L'=3, the inverse mod t over the three Z_q
    primes, the split cyclic transforms on [1, 3, 2^18] and [1, 3, 2^19])."""
    from ringsnark_tpu_torch.scripts import bench_prover

    log_m = 11 if small else 18
    argv = ["--ring", "zq", "--L", "3", "--n-inner", "512" if small else "4096",
            "--log-m", str(log_m), "--phased", "--margin", "4", "--passes", "1",
            "--cpu-slabs", "1" if small else "2"]
    if small:
        argv += ["--slab", "256", "--phase-chunk", "1024"]
    reset_counts()
    with recorded_shapes() as seen:
        row = _script("14b bench_prover", bench_prover.main, argv)
    counts = read_counts()
    cfg = row["config"]
    print(f"  Z_q N=1 L=3 M=2^{log_m} streamed: L'={cfg['L_inner']} floor={cfg['floor']}; cold "
          f"pass {row['combined_cold_s']:.3f} s, peak {row['peak_gib']:.3f} GiB; verify "
          f"{row['verify_s']:.3f} s"
          f"; the native MAC alone ~{row['cpu_mac_s']:.3f} s on {row['cpu_threads']} threads (a "
          f"lower bound without encryption or witness map); launches {counts}", flush=True)
    check(row["verified"] and row["tampered_rejected"], "Z_q streamed verification")
    _launch_check(counts, 1 << log_m, "zq")
    check(counts["split_negacyclic_fwd"] == counts["split_negacyclic_inv"] == 0,
          "the Z_q path launched an outer negacyclic split transform")
    hold_recorded_shapes("14b", seen, report, split_report, 1401)
    return counts, row


def small_zq_cross_check():
    """14c: Z_q, N=1, L=3 at M=2^6, N'=512 (the streamed prover's branch that
    does not recurse per limb): the card's streamed and seeded proofs equal
    the CPU's bit for bit and verify on both."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, seeded, streamed
    from ringsnark_tpu_torch.utils import interop, prng

    cfg = dict(L=3, N=1, n_inner=512, log_m=6)
    out = {}
    for dev in ("cuda", "cpu"):
        params = make_params(cfg, dev)
        comp, primary, aux = build_synthetic_square_chain(params.ring, 64,
                                                          np.random.default_rng(21))
        proof, vk, _ = streamed.stream_prove(comp, params, primary, aux,
                                             np.random.default_rng(22), prng.key(23),
                                             slab=16, phase_rows=32)
        kp = seeded.generator_seeded(comp, params, np.random.default_rng(24), prng.key(25),
                                     slab=16)
        sproof = seeded.prover_seeded(kp.pk, primary, aux)
        check(groth16.verifier(vk, primary, proof) and groth16.verifier(kp.vk, primary, sproof),
              f"small Z_q L=3 proofs rejected on {dev}")
        out[dev] = (interop.proof_to_numpy(proof), interop.proof_to_numpy(sproof))
    for kind, got, want in zip(("streamed", "seeded"), out["cuda"], out["cpu"]):
        check(all(g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
                  for g, w in zip(got, want)),
              f"small Z_q L=3 {kind} proof: card != CPU")
    print("  small Z_q (N=1, L=3, N'=512, M=2^6, slab 16): streamed and seeded proofs on the "
          "card == the CPU's, verify", flush=True)


def zq_seeded(small: bool, report, split_report):
    """14d: scripts/bench_prover, the seeded prover over Z_q (L=3, N'=4096,
    margin 6: L'=3) at M=2^14 (at 2^16, c0 27 GiB, it takes ~51 s and the
    whole script runs past 650 s); launches counted over the call, path
    `zq_seeded`; then every shape the call gave the kernels held against
    the plain versions."""
    from ringsnark_tpu_torch.scripts import bench_prover

    log_m = 9 if small else 14
    argv = ["--ring", "zq", "--L", "3", "--n-inner", "512" if small else "4096",
            "--log-m", str(log_m), "--margin", "6", "--cpu-slabs", "1"]
    if small:
        argv += ["--slab", "64"]
    reset_counts()
    with recorded_shapes() as seen:
        row = _script("14d bench_prover", bench_prover.main, argv)
    counts = read_counts()
    print(f"  Z_q N=1 L=3 M=2^{log_m} seeded: c0 {row['pk_c0_gib']:.3f} GiB; setup "
          f"{row['setup_s']:.3f} s (cold {row['setup_cold_s']:.3f} s), prove {row['value']:.3f} s "
          f"(cold {row['prove_cold_s']:.3f} s), peak {row['peak_gib']:.3f} GiB; launches {counts}",
          flush=True)
    check(row["verified"] and row["tampered_rejected"], "Z_q seeded verification")
    _launch_check(counts, 1 << log_m, "zq_seeded", macs=SEEDED_MAC)
    hold_recorded_shapes("14d", seen, report, split_report, 1402)
    return counts, row


def examples(small: bool, report, split_report):
    """14e: the four examples at their defaults (example_poly_ring at N=4096,
    N'=8192, L=3; microbench at N=8192, L=6); each proof verifies (the
    examples raise otherwise); launches counted over the four, path
    `examples`; then every shape they gave the kernels held against the
    plain versions."""
    from ringsnark_tpu_torch.examples import (example_int_ring, example_plaintext_check,
                                              example_poly_ring, microbench)

    reset_counts()
    out = {}
    with recorded_shapes() as seen:
        for name, mod, argv in (
            ("example_int_ring", example_int_ring, []),
            ("example_poly_ring", example_poly_ring, ["--small"] if small else []),
            ("example_plaintext_check", example_plaintext_check, []),
            ("microbench", microbench, ["--N", "256", "--L", "2", "--n-inner", "512"]
             if small else []),
        ):
            res = _script(f"14e {name}", mod.main, argv)
            if "systems" in res:
                check(all(s["verified"] is True for s in res["systems"].values()),
                      f"{name}: a proof was rejected")
                out[name] = {s: {k: v for k, v in r.items() if k != "proof"}
                             for s, r in res["systems"].items()}
            else:
                out[name] = {k: v for k, v in res.items() if k != "card"}
    counts = read_counts()
    print(f"  examples: all verify; launches {counts}", flush=True)
    for mode in ("negacyclic_fwd", "negacyclic_inv", "prng_lift", "prng_encrypt", "mac"):
        check(counts[mode] > 0, f"kernel mode {mode} never launched by the examples")
    hold_recorded_shapes("14e", seen, report, split_report, 1403)
    return counts, out


def other_scripts(small: bool, report, split_report):
    """14f-14i: bench_circuits (the plaintext check at its reference shape,
    both systems; logreg's ringGroth16 for the FHE side), bench_encode_profile,
    bench_cpu_full, bench_scaling at world size 1 over NCCL; then every
    shape they gave the kernels held against the plain versions."""
    from ringsnark_tpu_torch.scripts import (bench_circuits, bench_cpu_full,
                                             bench_encode_profile, bench_scaling)

    circ = (["--N", "64", "--n-inner", "512", "--features", "4"] if small
            else ["--preset", "reference"])
    out = {"circuits": []}
    with recorded_shapes() as seen:
        for argv in (circ + ["--circuit", "plaintext_check"],
                     circ + ["--circuit", "logreg", "--system", "groth16"]):
            rows = _script("14f bench_circuits", bench_circuits.main, argv)["rows"]
            out["circuits"] += [{k: v for k, v in r.items() if k not in ("proof", "card")}
                                for r in rows]
        check(any(r["metric"] == "logreg_fhe_side" for r in out["circuits"]), "no FHE-side row")
        out["encode_profile"] = _script(
            "14g bench_encode_profile", bench_encode_profile.main,
            ["--rows", "256", "--slab", "64", "--n-inner", "512", "--reps", "1"] if small else [])
        out["cpu_full"] = _script("14h bench_cpu_full", bench_cpu_full.main,
                                  ["--log-m", "6" if small else "12"])
        out["scaling"] = _script("14i bench_scaling", bench_scaling.main, ["--D", "1"])["rows"]
    check(all(r["backend"] == "nccl" for r in out["scaling"]), "bench_scaling not over NCCL")
    hold_recorded_shapes("14f-i", seen, report, split_report, 1404)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true", help="small main-path size, for debugging")
    args = ap.parse_args()
    cfg = SMALL if args.small else FULL

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    from ringsnark_tpu_torch.ops import cuda_ntt

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    nvcc = cuda_ntt._find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    card = gpu_line()
    print(f"nvcc {nvcc}: {ver}", flush=True)
    print(f"gpu: {card}", flush=True)
    phase(0, "environment", t0)

    t0 = time.perf_counter()
    build_kernels()
    phase(1, "build", t0)

    params = make_params(cfg, "cuda")
    t0 = time.perf_counter()
    report = kernel_vs_plain(params, cfg)
    phase(2, "kernel vs plain twin", t0)

    t0 = time.perf_counter()
    cfg5 = SMALL_SEEDED if args.small else FULL_SEEDED
    cfg7 = SMALL_STREAMED if args.small else FULL_STREAMED
    cfg8 = SMALL_RINOCCHIO if args.small else FULL_RINOCCHIO
    params5, params7 = make_params(cfg5, "cuda"), make_params(cfg7, "cuda")
    split_report, orders = split_vs_plain(params5, params7, cfg5, args.small)
    phase("2b", "split kernel vs plain, CTA orders", t0)

    t0 = time.perf_counter()
    large_split_vs_plain(split_report)
    phase("2c", "split kernel past 2^19 vs plain", t0)

    t0 = time.perf_counter()
    prng_report = prng_vs_plain(args.small)
    phase("2d", "draw and encryption kernels vs plain", t0)

    t0 = time.perf_counter()
    mac_report = mac_vs_plain(args.small)
    phase("2e", "MAC kernels vs plain", t0)

    t0 = time.perf_counter()
    meshes = open_world(card)
    phase("13a", "world of one rank over NCCL, meshes", t0)
    try:
        with one_ntt_per_encryption() as encryptions:
            return run_phases(args, (cfg, cfg5, cfg7, cfg8), (params, params5, params7), report,
                              split_report, prng_report, mac_report, orders, meshes, card,
                              encryptions)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def north_star_entry(row: dict, mode: str) -> dict:
    """14a's numbers for the negacyclic modes' entries of the kernels line."""
    legs = {"negacyclic_fwd": ("kernel", "plain"), "negacyclic_inv": ("kernel_inv", "plain_inv")}
    if mode not in legs:
        return {}
    tag, plain = legs[mode]
    ms, gms, bms = (row[f"{tag}_eager_us"] / 1e3, row[f"{tag}_us"] / 1e3,
                    row["bound_us"] / 1e3)
    return {"north_star": {"shape": row["shape"], "ms": ms, "graph_ms": gms,
                           "plain_ms": row[f"{plain}_us"] / 1e3,
                           "bound_ms": bms, "bound_by": "bytes", "share_of_bound": bms / ms,
                           "graph_share_of_bound": bms / gms,
                           "max_abs_err": row["max_abs_err"]}}


def run_phases(args, cfgs, params_all, report, split_report, prng_report, mac_report, orders,
               meshes, card, encryptions) -> int:
    """Phases 3 to 14 on the world of one rank (every encryption on the card
    checked by `one_ntt_per_encryption` into `encryptions`); the last lines
    of output."""
    from ringsnark_tpu_torch.ops import cuda_mac, cuda_ntt, cuda_prng

    cfg, cfg5, cfg7, cfg8 = cfgs
    params, params5, params7 = params_all
    sharded = {}  # the sharded checks' launch counts (path "sharded")
    sharded_s = {}
    t0 = time.perf_counter()
    counts, times, crs_bytes, peak, c3, sharded_s["groth16"] = main_path(params, cfg, meshes, card)
    add_counts(sharded, c3)
    phase(3, "main path, sharded ringGroth16 on both meshes", t0)

    t0 = time.perf_counter()
    small_cross_check()
    phase(4, "small-input cross-check", t0)

    torch.cuda.empty_cache()  # the resident CRS of phase 3 is gone with its keypair
    t0 = time.perf_counter()
    counts5, times5, crs5, peak5 = seeded_path(params5, cfg5)
    phase(5, "seeded main path", t0)

    t0 = time.perf_counter()
    small_seeded_cross_check()
    phase(6, "small seeded cross-check", t0)

    torch.cuda.empty_cache()  # phase 5's seeded CRS is gone with its keypair
    t0 = time.perf_counter()
    counts7, times7, rec7, events7, peak7, north_star = streamed_path(params7, cfg7)
    c7, sharded_s["stream_chunk"], sharded_s["stream_chunk_reference"] = sharded_stream_chunk(
        params7, cfg7, meshes["limb x data"], card)
    add_counts(sharded, c7)
    torch.cuda.empty_cache()
    phase(7, "streamed main path, sharded streamed chunk", t0)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts8, times8, rec8, peak8 = rinocchio_path(make_params(cfg8, "cuda"), cfg8)
    phase(8, "streamed Rinocchio", t0)

    t0 = time.perf_counter()
    small_streamed_cross_check()
    phase(9, "small streamed cross-check", t0)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts10, frontend, (c10, sharded_s["rinocchio_logreg"]) = frontend_path(
        SMALL_CIRCUITS if args.small else REFERENCE_CIRCUITS, report, meshes["limb x data"], card)
    add_counts(sharded, c10)
    phase(10, "circuit frontend, reference circuits, sharded Rinocchio", t0)

    t0 = time.perf_counter()
    small_frontend_cross_check(report)
    phase(11, "small frontend cross-check", t0)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts12, keys = keys_on_disk(
        (SMALL_CIRCUITS if args.small else REFERENCE_CIRCUITS)["logreg"], north_star)
    del north_star
    phase(12, "keys on disk: logreg Rinocchio and ringGroth16, the north-star vk", t0)

    t0 = time.perf_counter()
    small_keys_cross_check()
    phase("12b", "small keys cross-check, card to CPU", t0)

    t0 = time.perf_counter()
    c13, sharded_s["ntt_ms"], unscaled = sharded_ntt_phase(
        meshes, *SHARDED_NTT["small" if args.small else "full"], report, split_report, card)
    add_counts(sharded, c13)
    for mode in ("split_cyclic_fwd", "split_cyclic_inv", "negacyclic_fwd", "negacyclic_inv",
                 "prng_lift", "prng_encrypt", "mac"):
        check(sharded[mode] > 0, f"kernel mode {mode} never launched on the sharded path")
    print(f"  sharded path: launches {sharded}; seconds {sharded_s}", flush=True)
    phase(13, "multi-device layer: sharded NTT, unscaled inverse", t0)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    north_star_ntt = bench_ntt(args.small)
    phase("14a", "scripts/bench: the north-star NTT [32, 6, 8192]", t0)
    t0 = time.perf_counter()
    counts14, zq = zq_streamed(args.small, report, split_report)
    phase("14b", "scripts/bench_prover: Z_q N=1 L=3 streamed", t0)
    t0 = time.perf_counter()
    small_zq_cross_check()
    phase("14c", "small Z_q L=3 cross-check, card to CPU", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts14d, zq_sd = zq_seeded(args.small, report, split_report)
    phase("14d", "scripts/bench_prover: Z_q N=1 L=3 seeded", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts14e, example_rows = examples(args.small, report, split_report)
    phase("14e", "the four examples", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    script_rows = other_scripts(args.small, report, split_report)
    phase("14f-i", "bench_circuits, bench_encode_profile, bench_cpu_full, bench_scaling", t0)

    print(f"  {len(encryptions)} encryptions on the card, each one forward NTT, one lift and "
          "one encrypt launch", flush=True)
    check(encryptions, "no encryption ran on the card")
    by_path = {m: {"resident": counts[m], "seeded": counts5[m], "streamed": counts7[m],
                   "streamed_rinocchio": counts8[m], "frontend": counts10[m],
                   "keys": counts12[m], "sharded": sharded.get(m, 0), "zq": counts14[m],
                   "zq_seeded": counts14d[m], "examples": counts14e[m]} for m in counts}

    def bounds(r):  # no PyTorch call computes an NTT modulo a prime: library_ms is null
        return {"bound_ms": r["bound_ms"], "bound_by": "bytes",
                "share_of_bound": r["bound_ms"] / r["ms"], "library_ms": None,
                "graph_ms": None, "graph_share_of_bound": None}  # phases 2-2c time eagerly

    kernels = [
        {"name": f"ntt_{m}", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": sum(by_path[m].values()), "launches_by_path": by_path[m],
         "max_abs_err": report[m]["max_abs_err"],
         "ms": report[m]["ms"], "plain_ms": report[m]["plain_ms"], **bounds(report[m]),
         "shape": report[m]["shape"], **north_star_entry(north_star_ntt, m)}
        for m in cuda_ntt.MODES
    ] + [
        {"name": f"ntt_{m}", "route": "cuda", "source": SOURCE, "replaces": REPLACES_SPLIT,
         "launches": sum(by_path[m].values()), "launches_by_path": by_path[m],
         "max_abs_err": split_report[m]["max_abs_err"],
         "ms": split_report[m]["ms"], "plain_ms": split_report[m]["plain_ms"],
         **bounds(split_report[m]),
         "full_twin_ms": split_report[m]["full_twin_ms"], "shape": split_report[m]["shape"],
         "streamed_shape": split_report[m]["streamed"],
         "large_shapes": split_report[m].get("large")}
        for m in cuda_ntt.SPLIT_MODES
    ] + [
        {"name": f"prng_{k}", "route": "cuda", "source": PRNG_SOURCE, "replaces": PRNG_REPLACES[k],
         "launches": sum(by_path[f"prng_{k}"].values()), "launches_by_path": by_path[f"prng_{k}"],
         **{key: prng_report[k][key] for key in ("max_abs_err", "ms", "graph_ms", "plain_ms",
                                                  "bound_ms", "bound_by", "share_of_bound",
                                                  "graph_share_of_bound", "shape", "shapes")},
         "library_ms": None}
        for k in cuda_prng.KERNELS
    ] + [
        # no single PyTorch call computes sum (c * pt mod Q_j): library_ms is null
        {"name": k, "route": "cuda", "source": MAC_SOURCE, "replaces": MAC_REPLACES[k],
         "launches": sum(by_path[k].values()), "launches_by_path": by_path[k],
         **{key: mac_report[k][key] for key in ("max_abs_err", "ms", "graph_ms", "plain_ms",
                                                 "bound_ms", "bound_by", "share_of_bound",
                                                 "graph_share_of_bound", "shape", "shapes")},
         "library_ms": None}
        for k in cuda_mac.KERNELS
    ]
    summary = {"resident": {"config": cfg, "stage_s": times, "crs_gib": crs_bytes / 2**30,
                            "peak_allocated_gib": peak / 2**30},
               "seeded": {"config": cfg5, "stage_s": times5, "crs_c0_gib": crs5 / 2**30,
                          "peak_allocated_gib": peak5 / 2**30},
               "streamed": {"config": cfg7, "stage_s": times7, "record_s": rec7,
                            "sections": events7, "peak_allocated_gib": peak7 / 2**30},
               "streamed_rinocchio": {"config": cfg8, "stage_s": times8, "record_s": rec8,
                                      "peak_allocated_gib": peak8 / 2**30},
               "frontend": frontend,
               "keys_on_disk": keys,
               "sharded": {"seconds": sharded_s, "unscaled_inverse": unscaled},
               "cta_order": orders,
               "encryptions_checked": len(encryptions),
               "scripts": {"bench": north_star_ntt, "zq_streamed": zq, "zq_seeded": zq_sd,
                           "examples": example_rows, **script_rows}}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
