"""The Hopper NTT kernels of ringsnark_tpu_torch on the card, and the paths
that run them (streamed provers, the circuit frontend) against the CPU.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  This file imports no jax, so it also runs on a machine with
only PyTorch:  python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from ringsnark_tpu_torch.ops import cuda_ntt
from ringsnark_tpu_torch.ops import ntt as tntt
from ringsnark_tpu_torch.ops.primes import find_ntt_primes

DISPATCH = {
    (False, False): tntt.cyclic_ntt_rev,
    (True, False): tntt.cyclic_intt_nat,
    (False, True): tntt.negacyclic_ntt_rev,
    (True, True): tntt.negacyclic_intt_nat,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NTT kernel has no CPU mode")
    return torch.device("cuda")


def _residues(primes, M, rows, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.cat([torch.randint(0, p, (rows, 1, M), generator=g, dtype=torch.int32,
                                    device=device) for p in primes], dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("M", [1 << k for k in range(1, 16)])
def test_kernel_equals_twin(cuda, M, inverse, negacyclic):
    """Every size of the shared-memory kernel (register groups of E = M
    below 16, several transforms per CTA below 4096, one buffer at 32768),
    in both CTA orders, on a batch that leaves the last tile part-full."""
    primes = tuple(find_ntt_primes(2, 1 << 16))
    plan = tntt.get_plan(primes, M, negacyclic=negacyclic)
    x = _residues(primes, M, 3 + 257 // M, cuda, seed=M)
    want = tntt.PLAIN_TWINS[(inverse, negacyclic)](x, plan)
    before = dict(cuda_ntt.launch_counts)
    got = DISPATCH[(inverse, negacyclic)](x, plan)
    torch.cuda.synchronize()
    mode = cuda_ntt.mode_name(inverse, negacyclic)
    assert cuda_ntt.launch_counts[mode] == before[mode] + 1
    assert torch.equal(got, want)
    assert torch.equal(cuda_ntt.ntt(x, plan, inverse, negacyclic, order="limb"), want)
    back = cuda_ntt.ntt(got, plan, not inverse, negacyclic)
    assert torch.equal(back, x)


@pytest.mark.gpu
@pytest.mark.parametrize("order", cuda_ntt.CTA_ORDERS)
@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_cta_orders_equal_twin(cuda, inverse, negacyclic, order):
    primes = tuple(find_ntt_primes(3, 1 << 15))
    plan = tntt.get_plan(primes, 16384, negacyclic=negacyclic)
    x = _residues(primes, 16384, 5, cuda, seed=1)
    got = cuda_ntt.ntt(x, plan, inverse, negacyclic, order=order)
    assert torch.equal(got, tntt.PLAIN_TWINS[(inverse, negacyclic)](x, plan))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("order", cuda_ntt.CTA_ORDERS)
@pytest.mark.parametrize("M", [16, 32, 64, 512, 1024, 2048, 16384, 32768])
def test_kernel_edges_equal_twin(cuda, M, order, S):
    """The schedule's edges: M = 16 (a thread holds a whole transform, one
    pass), 32 (one warp-wide group of 16-byte loads and stores), 64 (the
    top pass at distance 2, a one-stage last pass), 512 (the last size
    without the transposing copy), 1024 (the first with it and the last
    without a CTA-wide barrier), 2048 (the first with one), 16384 (two
    groups a thread, the second copied ahead with cp.async) and 32768 (one
    CTA of 512 threads a SM), on the split's [rows, L, S, M] view,
    with the last tile part-full, all four modes and the cyclic inverse
    unscaled."""
    primes = tuple(find_ntt_primes(2, 2 * M))
    geo = cuda_ntt.geometry(M)
    rows = (3 * geo.tile_tf) // (2 * S) + 1
    x = _residues(primes, M * S, rows, cuda, seed=M + S).reshape(rows, 2, S, M)
    for negacyclic in (False, True):
        plan = tntt.get_plan(primes, M, negacyclic=negacyclic)
        flat = x.transpose(1, 2).reshape(rows * S, 2, M)  # each (row, s) one transform row
        for inverse in (False, True):
            want = tntt.PLAIN_TWINS[(inverse, negacyclic)](flat, plan)
            want = want.reshape(rows, S, 2, M).transpose(1, 2).contiguous()
            y = torch.empty_like(x)
            cuda_ntt._launch(x, y, primes, M, inverse, negacyclic, rows, S=S, order=order)
            assert torch.equal(y, want), (negacyclic, inverse)
    plan = tntt.get_plan(primes, M)
    y = torch.empty_like(x)
    cuda_ntt._launch(x, y, primes, M, True, False, rows, S=S, scale=False, order=order)
    want = tntt.cyclic_intt_nat_plain(x.transpose(1, 2).reshape(rows * S, 2, M), plan,
                                      scale=False)
    assert torch.equal(y, want.reshape(rows, S, 2, M).transpose(1, 2).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [256, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("order", cuda_ntt.CTA_ORDERS)
def test_persistent_tiles_equal_twin(cuda, order, M):
    """More tiles than the card has CTA slots (at most 2048 threads a SM),
    so every persistent CTA walks three tiles or more and reuses its shared
    memory (a CTA-wide barrier between tiles from M = 2048, the warp's own
    words below), in both CTA orders and all four modes, with the last tile
    part-full where a tile holds several transforms."""
    geo = cuda_ntt.geometry(M)
    slots = (2048 // geo.threads) * torch.cuda.get_device_properties(cuda).multi_processor_count
    nt = geo.tile_tf * (3 * slots + 1) + geo.tile_tf // 2 + 1
    primes = tuple(find_ntt_primes(2, 1 << 16))
    x = _residues(primes, M, -(-nt // 2), cuda, seed=M + 1)
    assert -(-x.shape[0] * 2 // geo.tile_tf) > 3 * slots
    for inverse in (False, True):
        for negacyclic in (False, True):
            plan = tntt.get_plan(primes, M, negacyclic=negacyclic)
            got = cuda_ntt.ntt(x, plan, inverse, negacyclic, order=order)
            assert torch.equal(got, tntt.PLAIN_TWINS[(inverse, negacyclic)](x, plan)), (
                inverse, negacyclic)
            if not inverse:
                back = cuda_ntt.ntt(got, plan, True, negacyclic, order=order)
                assert torch.equal(back, x), negacyclic


@pytest.mark.gpu
@pytest.mark.parametrize("negacyclic", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("M", [1 << k for k in range(15, 23)])
def test_split_kernel_equals_plain(cuda, M, inverse, negacyclic):
    """The split kernel at every M = 2^15 .. 2^22 equals the plain split and
    the full-size twin and inverts itself (inner size 16384 up to 2^19,
    32768 above; 2^21 and 2^22 run the outer stages in two passes); the
    dispatcher sends every M > 32768 to it, counted once as split_<mode>."""
    primes = tuple(find_ntt_primes(2, 1 << 23))
    plan = tntt.get_plan(primes, M, negacyclic=negacyclic)
    x = _residues(primes, M, 3, cuda, seed=M)
    y = cuda_ntt.ntt_split(x, plan, inverse, negacyclic)
    torch.cuda.synchronize()
    assert torch.equal(y, tntt.ntt_split_plain(x, plan, inverse, negacyclic))
    assert torch.equal(y, tntt.PLAIN_TWINS[(inverse, negacyclic)](x, plan))
    assert torch.equal(cuda_ntt.ntt_split(y, plan, not inverse, negacyclic), x)
    if M > tntt.MAX_KERNEL_M:
        mode = cuda_ntt.mode_name(inverse, negacyclic)
        before = dict(cuda_ntt.launch_counts)
        assert torch.equal(DISPATCH[(inverse, negacyclic)](x, plan), y)
        assert cuda_ntt.launch_counts["split_" + mode] == before["split_" + mode] + 1
        assert cuda_ntt.launch_counts[mode] == before[mode]


@pytest.mark.gpu
def test_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (here a CTA of 1024 threads, not the
    kernel's 256) raises and counts nothing; nothing falls back, and the
    refusal does not leak into the next launch."""
    primes = tuple(find_ntt_primes(1, 1 << 15))
    plan = tntt.get_plan(primes, 16384)
    x = _residues(primes, 16384, 2, cuda)
    geo = cuda_ntt.geometry(16384)
    before = dict(cuda_ntt.launch_counts)
    with monkeypatch.context() as m:
        m.setattr(cuda_ntt, "geometry", lambda M: dataclasses.replace(geo, threads=1024, M=M))
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda_ntt.ntt(x, plan, False, False)
    assert cuda_ntt.launch_counts == before
    assert torch.equal(cuda_ntt.ntt(x, plan, False, False),
                       tntt.PLAIN_TWINS[(False, False)](x, plan))


@pytest.mark.gpu
def test_split_sizes_and_bad_inputs_raise(cuda):
    primes = tuple(find_ntt_primes(1, 1 << 21))
    big = tntt.get_plan(primes, 1 << 20)
    xb = _residues(primes, 1 << 20, 1, cuda)
    before = cuda_ntt.launch_counts["split_cyclic_fwd"]
    assert torch.equal(tntt.cyclic_ntt_rev(xb, big), tntt.PLAIN_TWINS[(False, False)](xb, big))
    assert cuda_ntt.launch_counts["split_cyclic_fwd"] == before + 1
    mid = tntt.get_plan(primes, 65536)
    x16 = _residues(primes, 65536, 1, cuda)
    with pytest.raises(ValueError, match="does not fit a split"):
        cuda_ntt.ntt_split(x16, mid, False, False, mi=65536)  # R = 1
    with pytest.raises(ValueError, match="does not fit a split"):
        cuda_ntt.ntt_split(x16, mid, False, False, mi=24576)  # M % mi != 0
    with pytest.raises(ValueError, match="does not fit"):
        cuda_ntt.ntt(x16, mid, False, False)  # beyond the shared-memory kernel
    plan = tntt.get_plan(primes, 256, negacyclic=True)
    x = _residues(primes, 256, 2, cuda)
    with pytest.raises(TypeError):
        cuda_ntt.ntt(x.long(), plan, False, True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ntt.ntt(x.repeat(1, 1, 2)[..., ::2], plan, False, True)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_ntt.ntt(x[..., :128].contiguous(), plan, False, True)
    with pytest.raises(ValueError, match="CTA order"):
        cuda_ntt.ntt(x, plan, False, True, order="column")


@pytest.mark.gpu
def test_from_coeffs_unreduced_words_card_equals_cpu(cuda):
    """Coefficient words in [0, 2^32), canonical or not, give one element
    on the card and on the CPU (both reduce them before the transform)."""
    import numpy as np

    from ringsnark_tpu_torch.rings.context import default_context
    from ringsnark_tpu_torch.rings.elem import RingElem

    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (3, 2, 64), dtype=np.uint64).astype(np.uint32)
    words[0, :, :4] = [0xFFFFFFFF, 1 << 31, 0, 1]
    got = {dev: RingElem.from_coeffs(default_context(L=2, N=64, order=1 << 12, device=dev),
                                     words).res.cpu() for dev in ("cuda", "cpu")}
    assert torch.equal(got["cuda"], got["cpu"])


def _small_params(L, device):
    from ringsnark_tpu_torch.encoding import EncodingContext
    from ringsnark_tpu_torch.rings.context import default_context
    from ringsnark_tpu_torch.snark.api import SnarkParams

    ring = default_context(L=L, N=64, order=1 << 12, device=device)
    inner = [q for q in find_ntt_primes(L + 3, 256) if q not in ring.primes][:3]
    ectx = EncodingContext(ring=ring, n_inner=128, inner_primes=tuple(inner))
    return SnarkParams(ring=ring, enc=ectx)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2])
def test_streamed_proofs_on_card_equal_cpu(cuda, L):
    """stream_prove and stream_prove_rinocchio on the card give the CPU's
    proofs bit for bit (L=2 takes the limb-local branch), and verify."""
    import numpy as np

    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, rinocchio, streamed
    from ringsnark_tpu_torch.utils import interop, prng

    out = {}
    for dev in ("cuda", "cpu"):
        params = _small_params(L, dev)
        comp, primary, aux = build_synthetic_square_chain(params.ring, 32,
                                                          np.random.default_rng(2))
        proof, vk, _ = streamed.stream_prove(comp, params, primary, aux,
                                             np.random.default_rng(3), prng.key(4),
                                             slab=8, phase_rows=16)
        rproof, rvk, _ = streamed.stream_prove_rinocchio(comp, params, primary, aux,
                                                         np.random.default_rng(5), prng.key(6),
                                                         slab=8, phase_rows=16)
        assert groth16.verifier(vk, primary, proof)
        assert rinocchio.verifier(rvk, primary, rproof)
        out[dev] = (interop.proof_to_numpy(proof), interop.proof_to_numpy(rproof))
    for got, want in zip(out["cuda"], out["cpu"]):
        for g, w in zip(got, want):
            assert g[2] == w[2] and np.array_equal(g[0], w[0])
            assert np.array_equal(g[1], w[1])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_tiny_domains_on_card_equal_cpu(cuda, M):
    """The witness map's cyclic transforms at the sizes of the smallest
    circuits (ct-mul has M = 4, the in-circuit NTT M = 1): interpolation,
    evaluation and the H product on the card equal the plain versions on the
    CPU.  Size 1 is the identity and launches nothing; from 2 on the kernel
    runs (the size-2M product from M = 2)."""
    from ringsnark_tpu_torch.reductions.r1cs_to_qrp import _h_main
    from ringsnark_tpu_torch.rings.context import default_context
    from ringsnark_tpu_torch.utils.domain import RootsDomain

    out = {}
    for dev in ("cuda", "cpu"):
        ring = default_context(L=2, N=16, order=1 << 12, device=dev)
        dom = RootsDomain(ring, M)
        assert dom.m == M
        x = _residues(ring.primes, M, 5, "cpu", seed=M).to(dev)
        before = dict(cuda_ntt.launch_counts)
        coeffs = dom.interpolate_arr(x)  # [n, L, M]: the map's slot-major batches
        back = dom.evaluate_arr(coeffs)
        h = _h_main(ring, coeffs, coeffs.flip(-1).contiguous(), M)
        if dev == "cuda":
            ran = 0 if M == 1 else 1
            assert cuda_ntt.launch_counts["cyclic_inv"] == before["cyclic_inv"] + 2 * ran
            assert cuda_ntt.launch_counts["cyclic_fwd"] == before["cyclic_fwd"] + 3 * ran
        assert torch.equal(back.cpu(), x.cpu())
        out[dev] = (coeffs.cpu(), h.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", ["logreg", "ct_mul", "incircuit_ntt"])
def test_frontend_proofs_on_card_equal_cpu(cuda, circuit):
    """A circuit built on a Protoboard at N = 16, L = 2: Rinocchio and
    ringGroth16 from a resident CRS made on the card give, bit for bit, the
    proofs the carried keypair gives on the CPU; both verify, and a changed
    public input is rejected.  ct-mul and the in-circuit NTT have no
    auxiliary wires (F is None) and domains of size 4 and 1."""
    import numpy as np

    from ringsnark_tpu_torch import models
    from ringsnark_tpu_torch.encoding import EncodingContext
    from ringsnark_tpu_torch.rings.context import default_context
    from ringsnark_tpu_torch.snark import groth16, rinocchio
    from ringsnark_tpu_torch.snark.api import SnarkParams
    from ringsnark_tpu_torch.utils import interop, prng

    def params(device):
        ring = default_context(L=2, N=16, order=1 << 12, device=device)
        inner = [q for q in find_ntt_primes(5, 256) if q not in ring.primes][:3]
        return SnarkParams(ring=ring, enc=EncodingContext(ring=ring, n_inner=128,
                                                          inner_primes=tuple(inner)))

    def build(ring):
        rng = np.random.default_rng(7)
        if circuit == "logreg":
            return models.build_logreg_inference(ring, rng, num_features=4, log_t=8)
        if circuit == "ct_mul":
            return models.build_ct_mul(ring, rng, log_t=8)
        return models.build_incircuit_ntt(ring, rng)

    p_gpu, p_cpu = params("cuda"), params("cpu")
    pb, pb_c = build(p_gpu.ring), build(p_cpu.ring)
    assert pb.is_satisfied() and pb_c.is_satisfied()
    assert torch.equal(pb.full_assignment_batch().res.cpu(), pb_c.full_assignment_batch().res)
    for system, to_np, from_np in (
            (rinocchio, interop.rinocchio_keypair_to_numpy, interop.rinocchio_keypair_from_numpy),
            (groth16, interop.keypair_to_numpy, interop.keypair_from_numpy)):
        before = dict(cuda_ntt.launch_counts)
        kp = system.generator(pb.get_constraint_system(), p_gpu, np.random.default_rng(8),
                              prng.key(9))
        proof = system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                              np.random.default_rng(10))
        assert cuda_ntt.launch_counts["negacyclic_fwd"] > before["negacyclic_fwd"]
        assert kp.pk.s_pows.c0.is_cuda and proof.A.c0.is_cuda
        kp_c = from_np(p_cpu, to_np(kp))
        proof_c = system.prover(kp_c.pk, pb_c.primary_input(), pb_c.auxiliary_input(),
                                np.random.default_rng(10))
        got, want = interop.proof_to_numpy(proof), interop.proof_to_numpy(proof_c)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        if system is rinocchio:
            assert (proof.F is None) == (circuit != "logreg")
        prim = pb.primary_input()
        assert system.verifier(kp.vk, prim, proof)
        assert not system.verifier(kp.vk, [prim[0] + 1] + prim[1:], proof)
        assert system.verifier(kp_c.vk, pb_c.primary_input(),
                               interop.proof_from_numpy(p_cpu, got))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1 << 10, 1 << 14, 1 << 15, 1 << 16, 1 << 18])
def test_unscaled_cyclic_inverse_equals_twin(cuda, M):
    """cyclic_intt_nat(scale=False) on the shared-memory route (M <= 32768)
    and on the split route (the outer kernel without its M^-1) == the twin;
    scaled back by M^-1 it is the scaled inverse."""
    primes = tuple(find_ntt_primes(2, 1 << 19))
    plan = tntt.get_plan(primes, M)
    x = _residues(primes, M, 3, cuda, seed=M + 1)
    route = "cyclic_inv" if M <= tntt.MAX_KERNEL_M else "split_cyclic_inv"
    before = cuda_ntt.launch_counts[route]
    got = tntt.cyclic_intt_nat(x, plan, scale=False)
    assert cuda_ntt.launch_counts[route] == before + 1
    assert torch.equal(got, tntt.cyclic_intt_nat_plain(x, plan, scale=False))
    minv = torch.as_tensor(plan.minv.astype("int64"), device=x.device)
    p = torch.as_tensor(plan.p.astype("int64"), device=x.device)
    assert torch.equal(torch.remainder(got.to(torch.int64) * minv, p).to(torch.int32),
                       tntt.cyclic_intt_nat(x, plan))
    with pytest.raises(ValueError, match="cyclic inverse only"):
        cuda_ntt.ntt(x[..., :1024].contiguous(), tntt.get_plan(primes, 1024), False, False,
                     scale=False)


@pytest.mark.gpu
def test_world_one_nccl_sharded_ntt_equals_ops_ntt(cuda):
    """A world of one rank over NCCL: sharded_ntt on the coeff dimension of
    a (1, 1, 1) mesh in all four modes == ops.ntt (the local transforms are
    the kernels; no exchange stage at D = 1)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ringsnark_tpu_torch.parallel import mesh as pmesh
    from ringsnark_tpu_torch.parallel import sharded_ntt

    pmesh.init_single_process("cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=("limb", "coeff", "data"))
        for M in (1 << 12, 1 << 17):
            primes = tuple(find_ntt_primes(2, 2 * M))
            x = _residues(primes, M, 4, cuda, seed=M)
            plan = tntt.get_plan(primes, M, negacyclic=True)
            for (inverse, negacyclic), fn in DISPATCH.items():
                got = sharded_ntt(x, plan, mesh, negacyclic=negacyclic, inverse=inverse)
                assert torch.equal(got, fn(x, plan)), (M, inverse, negacyclic)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_dryrun_multichip_on_one_gpu(cuda):
    """dryrun_multichip(1) spawns one NCCL rank on the GPU: the sharded
    proof verifies and equals the single-device proof."""
    from ringsnark_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(1)
    assert report["backend"] == "nccl" and report["ranks"] == 1
    assert report["proof_equals_single_device"] and report["verified"]


@pytest.mark.gpu
def test_zq_three_limbs_on_card_equal_cpu(cuda):
    """Z_q (N=1) with L=3 outer limbs, M=2^6, N'=512 (bench_prover's
    parameters): the streamed prover's branch that keeps all limbs in one
    witness map, and the seeded prover, give the CPU's proofs bit for bit on
    the card, and verify there."""
    import numpy as np

    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.scripts.common import bench_params
    from ringsnark_tpu_torch.snark import groth16, seeded, streamed
    from ringsnark_tpu_torch.utils import interop, prng

    out = {}
    for dev in ("cuda", "cpu"):
        params = bench_params(3, 1, 512, 6, 10, dev)
        comp, primary, aux = build_synthetic_square_chain(params.ring, 64,
                                                          np.random.default_rng(21))
        proof, vk, _ = streamed.stream_prove(comp, params, primary, aux,
                                             np.random.default_rng(22), prng.key(23),
                                             slab=16, phase_rows=32)
        kp = seeded.generator_seeded(comp, params, np.random.default_rng(24), prng.key(25),
                                     slab=16)
        sproof = seeded.prover_seeded(kp.pk, primary, aux)
        assert groth16.verifier(vk, primary, proof)
        assert groth16.verifier(kp.vk, primary, sproof)
        assert not groth16.verifier(vk, primary + 1, proof)
        out[dev] = (interop.proof_to_numpy(proof), interop.proof_to_numpy(sproof))
    for got, want in zip(out["cuda"], out["cpu"]):
        for g, w in zip(got, want):
            assert g[2] == w[2] and np.array_equal(g[0], w[0])
            assert np.array_equal(g[1], w[1])


# The draws, the lift and the encryption (csrc/prng.cu, ops/cuda_prng.py)
# against their plain torch-op versions on the card, bit for bit, at the
# shapes the paths give them (chip_smoke.py phase 2d): the north star's
# encryption sub-chunk (rows 1024-1536 of a 4096-row slab, L=1, L'=4,
# N'=16384), Z_q's short last sub-chunk (rows 2730-4096, L=1, L'=3,
# N'=4096), logistic regression's encode chunk (L=2, L'=4, N'=16384).
PRNG_SHAPES = {
    "north_star": dict(params=(1, 8192, 16384, 18, 10), slab=4096, rows=(1024, 1536), L_inner=4),
    "zq": dict(params=(1, 1, 4096, 18, 4), slab=4096, rows=(2730, 4096), L_inner=3),
    "logreg": dict(circuit=(2048, 16384, 2050), slab=32, rows=None, L_inner=4),
}


def _prng_params(shape):
    import numpy as np

    from ringsnark_tpu_torch.encoding import keygen
    from ringsnark_tpu_torch.scripts.bench_circuits import make_params as circuit_params
    from ringsnark_tpu_torch.scripts.common import bench_params

    cfg = PRNG_SHAPES[shape]
    params = (bench_params(*cfg["params"], "cuda") if "params" in cfg
              else circuit_params(*cfg["circuit"], "cuda"))
    assert params.enc.L_inner == cfg["L_inner"]
    _, sk = keygen(params.enc, np.random.default_rng(31))
    return params, sk, cfg


# kernel as a test names it -> its launch count
PRNG_COUNTS = {"uniform": "uniform", "cbd_error": "cbd_error", "lift": "lift",
               "lift_error": "lift", "encrypt": "encrypt", "encrypt_c0": "encrypt"}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(PRNG_COUNTS))
@pytest.mark.parametrize("shape", list(PRNG_SHAPES))
def test_prng_kernels_equal_plain(cuda, shape, kernel):
    """Each kernel of csrc/prng.cu against its plain version on the same
    inputs: the draws; the lift alone (the plaintext operand's: Z_q's slots
    of width 1) and with the error (the encryption's: Z_q's slot lifted to
    N' coefficients); `bgv.encrypt` (lift, NTT, encrypt) against the plain
    schedule, with c1 and with c0 alone written into a given tensor."""
    from ringsnark_tpu_torch.encoding import bgv
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.utils import prng

    params, sk, cfg = _prng_params(shape)
    ctx = params.enc
    key, batch, rows = prng.key(32), (cfg["slab"],), cfg["rows"]
    n = cfg["slab"] if rows is None else rows[1] - rows[0]
    k_a, k_e = prng.split(key)
    g = torch.Generator(device=cuda).manual_seed(33)
    slots = torch.cat([torch.randint(0, p, (n, 1, ctx.ring.N), generator=g,
                                     dtype=torch.int32, device=cuda)
                       for p in ctx.ring.primes], dim=1)
    pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
    count = PRNG_COUNTS[kernel]
    before = dict(cuda_prng.launch_counts)
    if kernel == "uniform":
        got = bgv._sample_uniform(ctx, key, batch, rows)
        want = bgv._uniform_plain(ctx, key, batch, rows)
    elif kernel == "cbd_error":
        got = bgv._sample_error_coeffs(ctx, key, batch, rows)
        want = bgv._error_coeffs_plain(ctx, key, batch, rows)
    elif kernel == "lift":
        got = bgv._lift(ctx, pt, 0)
        want = bgv._lift_centered(ctx, pt, 0).to(torch.int32)
    elif kernel == "lift_error":
        got = bgv._lift_error(ctx, pt, k_e, batch, rows)
        want = bgv._lift_error_plain(ctx, pt, k_e, batch, rows)
    else:
        lo = 0 if rows is None else rows[0]
        u = tntt.negacyclic_ntt_rev(bgv._lift_error_plain(ctx, pt, k_e, batch, rows),
                                    ctx.inner_plan(0))
        want = bgv._encrypt_from_u(ctx, sk.s_ntt, u, bgv._uniform_plain(ctx, k_a, batch, rows))
        if kernel == "encrypt":
            got = torch.stack(bgv.encrypt(ctx, sk, slots, key, draw_rows=cfg["slab"], lo=lo))
            want = torch.stack(want)
        else:
            out = torch.full_like(want[0], -1)
            got, c1 = bgv.encrypt(ctx, sk, slots, key, draw_rows=cfg["slab"], lo=lo, c0_out=out)
            assert c1 is None and got is out
            want = want[0]
    torch.cuda.synchronize()
    assert cuda_prng.launch_counts[count] == before[count] + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["north_star", "zq", "short_lines"])
def test_lift_error_two_words_a_side_equals_plain(cuda, shape):
    """lift_kernel's general draw, two words a side (k = 50 at sigma = 5:
    a context with a larger sigma), against `_lift_error_plain` on the card:
    lines of many CTA blocks (the north star's N' = 16384, 64 rows of its
    slab; Z_q's slot at N' = 4096) and lines shorter than one (N' = 128)."""
    import dataclasses

    from ringsnark_tpu_torch.encoding import bgv
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.utils import prng

    if shape == "short_lines":
        ctx, batch, rows = _small_params(2, "cuda").enc, (40,), (3, 37)
    else:
        params, _, cfg = _prng_params(shape)
        ctx, batch, rows = params.enc, (cfg["slab"],), (cfg["rows"][0], cfg["rows"][0] + 64)
    ctx = dataclasses.replace(ctx, error_stddev=5.0)
    assert bgv._cbd_k(ctx.error_stddev) > 32
    g = torch.Generator(device=cuda).manual_seed(36)
    n = rows[1] - rows[0]
    slots = torch.cat([torch.randint(0, p, (n, 1, ctx.ring.N), generator=g,
                                     dtype=torch.int32, device=cuda)
                       for p in ctx.ring.primes], dim=1)
    pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
    key = prng.key(37)
    before = cuda_prng.launch_counts["lift"]
    got = bgv._lift_error(ctx, pt, key, batch, rows)
    want = bgv._lift_error_plain(ctx, pt, key, batch, rows)
    torch.cuda.synchronize()
    assert cuda_prng.launch_counts["lift"] == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("maxval,minval", [(7, -6), (1 << 16, 0), (2147352577, 0),
                                           ((1 << 31) + 99, 100), (0, None)],
                         ids=["fhe_signed_13", "span_2e16", "prime", "past_2e31", "bits"])
def test_prng_draws_equal_plain(cuda, maxval, minval):
    """prng.randint and prng.bits on the card (models/fhe.py's signed span
    13 at logreg's N, B=3) equal their plain versions, rows and all."""
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.utils import prng

    shape, rows = (5, 1, 2048), (2, 5)
    before = cuda_prng.launch_counts["uniform"]
    if minval is None:
        got = prng.bits(prng.key(34), shape, "cuda", rows=rows)
        want = prng.bits_plain(prng.key(34), shape, "cuda", rows=rows)
    else:
        got = prng.randint(prng.key(34), shape, maxval, "cuda", rows=rows, minval=minval)
        want = prng.randint_plain(prng.key(34), shape, maxval, "cuda", rows=rows, minval=minval)
    torch.cuda.synchronize()
    assert cuda_prng.launch_counts["uniform"] == before + 1
    assert got.dtype == want.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.gpu
def test_prng_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (rows past the end of their axis)
    raises and counts nothing; nothing falls back, and the refusal does not
    leak into the next launch."""
    from ringsnark_tpu_torch.ops import cuda_prng
    from ringsnark_tpu_torch.utils import prng

    geo = cuda_prng.geometry((8, 64), (2, 6), 0)
    before = dict(cuda_prng.launch_counts)
    with monkeypatch.context() as m:
        m.setattr(cuda_prng, "geometry",
                  lambda *a: cuda_prng.Geometry(geo.outer, geo.n_axis, 6, 4, geo.A, geo.I))
        with pytest.raises(RuntimeError, match="launch failed"):
            prng.bits(prng.key(35), (8, 64), "cuda", rows=(2, 6))
    assert cuda_prng.launch_counts == before
    assert torch.equal(prng.bits(prng.key(35), (8, 64), "cuda", rows=(2, 6)),
                       prng.bits_plain(prng.key(35), (8, 64), "cuda", rows=(2, 6)))


# The MAC (csrc/mac.cu, ops/cuda_mac.py) against encoding.mac.mac_plain on
# the card, bit for bit, at the shapes the paths give it: the north star's
# row sub-chunk (512 rows, L=1, L'=4, N'=16384) with A and B together and
# with one operand (the seeded prove's delta_ts and delta_mid), Z_q's
# seeded sub-chunk with its broadcast operand (910 rows at L=3, L'=3,
# N'=4096), logistic regression's resident chunk (128 rows, L=2, L'=4,
# N'=16384); and at level 1 with five operands (two launches) of unequal rows.
MAC_SHAPES = {
    "north_star": dict(params=(1, 8192, 16384, 18, 10), rows=(512, 512), L_inner=4),
    "north_star_P1": dict(params=(1, 8192, 16384, 18, 10), rows=(512,), L_inner=4),
    "zq": dict(params=(3, 1, 4096, 18, 4), rows=(910, 910), L_inner=3),
    "logreg": dict(circuit=(2048, 16384, 2050), rows=(128,), L_inner=4),
    "level1_five": dict(params=(2, 64, 4096, 6, 4), rows=(300, 300, 299, 5, 1), L_inner=3,
                        level=1),
}


def _mac_inputs(shape, seed=0):
    from ringsnark_tpu_torch.encoding import bgv
    from ringsnark_tpu_torch.scripts.bench_circuits import make_params as circuit_params
    from ringsnark_tpu_torch.scripts.common import bench_params

    cfg = MAC_SHAPES[shape]
    params = (bench_params(*cfg["params"], "cuda") if "params" in cfg
              else circuit_params(*cfg["circuit"], "cuda"))
    ring, ctx = params.ring, params.enc
    assert ctx.L_inner == cfg["L_inner"]
    level = cfg.get("level", 0)
    n, primes = cfg["rows"][0], ctx.level_primes(level)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def residues(rows, ps, last):
        return torch.cat([torch.randint(0, p, (rows, 1, last), generator=g, dtype=torch.int32,
                                        device="cuda") for p in ps], dim=1)

    c0, c1 = (residues(n * ctx.L, primes, ctx.n_inner).reshape(
        n, ctx.L, len(primes), ctx.n_inner).contiguous() for _ in range(2))
    pts = [bgv.plain_to_inner_ntt(ctx, residues(r, ring.primes, ring.N), level)
           for r in cfg["rows"]]
    return ctx, level, c0, c1, pts


def _mac_accs(ctx, level, P):
    shape = (ctx.L, ctx.L_inner - level, ctx.n_inner)
    return [tuple(torch.full(shape, 7, dtype=torch.int64, device="cuda") for _ in range(2))
            for _ in range(P)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,drawn", [
    (shape, drawn) for shape in MAC_SHAPES for drawn in (False, True)
    if not (drawn and MAC_SHAPES[shape].get("level"))  # a drawn c1 is at level 0
], ids=lambda v: {False: "mac", True: "mac_drawn"}.get(v, v) if isinstance(v, bool) else v)
def test_mac_kernels_equal_plain(cuda, shape, drawn):
    """mac_rows on the card (one launch per four operands of a kind) adds
    the sums mac_plain adds, bit for bit; the Z_q operand stays a broadcast."""
    from ringsnark_tpu_torch.encoding import mac
    from ringsnark_tpu_torch.ops import cuda_mac
    from ringsnark_tpu_torch.utils import prng

    ctx, level, c0, c1, pts = _mac_inputs(shape, seed=len(shape))
    if drawn:
        n = c0.shape[0]
        c1 = mac.Drawn(prng.key(48), (4096,), (4096 - n, 4096))
    got, want = _mac_accs(ctx, level, len(pts)), _mac_accs(ctx, level, len(pts))
    kernel = "mac_drawn" if drawn else "mac"
    before = cuda_mac.launch_counts[kernel]
    mac.mac_rows(ctx, level, c0, c1, pts, got)
    torch.cuda.synchronize()
    assert cuda_mac.launch_counts[kernel] == before + -(-len(pts) // cuda_mac.MAX_OPERANDS)
    mac.mac_plain(ctx, level, c0, c1, pts, want)
    if shape == "zq":
        assert all(pt.stride(-1) == 0 for pt in pts)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert torch.equal(g0, w0) and torch.equal(g1, w1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["north_star", "zq", "logreg"])
def test_mac_takes_its_producers_words(cuda, shape):
    """The kernels' reduction is exact only for canonical words (csrc/mac.cu's
    head): the operands as plain_to_inner_ntt gives them and c0, c1 as the
    encryption gives them, at the paths' full shapes, lie in [0, Q_j), and
    the kernels' sums over them are mac_plain's.  A lazily reduced NTT or
    encryption fails here, not in a proof."""
    import numpy as np

    from ringsnark_tpu_torch.encoding import bgv, keygen, mac
    from ringsnark_tpu_torch.utils import prng

    ctx, level, _, _, pts = _mac_inputs(shape, seed=11)
    n, ring = pts[0].shape[0], ctx.ring
    g = torch.Generator(device="cuda").manual_seed(12)
    slots = torch.cat([torch.randint(0, p, (n, 1, ring.N), generator=g, dtype=torch.int32,
                                     device="cuda") for p in ring.primes], dim=1)
    _, sk = keygen(ctx, np.random.default_rng(13))
    c0, c1 = bgv.encrypt(ctx, sk, slots, prng.key(14))
    Q = torch.tensor(ctx.level_primes(level), dtype=torch.int32, device="cuda")[:, None]
    for x in (*pts, c0, c1):
        assert bool((x >= 0).all()) and bool((x < Q).all())
    got, want = _mac_accs(ctx, level, len(pts)), _mac_accs(ctx, level, len(pts))
    mac.mac_rows(ctx, level, c0, c1, pts, got)
    mac.mac_plain(ctx, level, c0, c1, pts, want)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert torch.equal(g0, w0) and torch.equal(g1, w1)


@pytest.mark.gpu
def test_mac_drawn_equals_mac_over_the_uniform_draw(cuda):
    """The c1 that mac_drawn draws in registers is cuda_prng.uniform's: the
    same sums as mac over the draw_kernel's words."""
    from ringsnark_tpu_torch.encoding import mac
    from ringsnark_tpu_torch.ops import cuda_mac, cuda_prng
    from ringsnark_tpu_torch.utils import prng

    ctx, level, c0, _, pts = _mac_inputs("north_star", seed=9)
    n, key = c0.shape[0], prng.key(49)
    c1 = cuda_prng.uniform(ctx, key, (4096,), (1024, 1024 + n))
    drawn, given = _mac_accs(ctx, level, len(pts)), _mac_accs(ctx, level, len(pts))
    cuda_mac.mac_drawn(ctx, level, c0, mac.Drawn(key, (4096,), (1024, 1024 + n)), pts, drawn)
    cuda_mac.mac(ctx, level, c0, c1, pts, given)
    for (d0, d1), (g0, g1) in zip(drawn, given):
        assert torch.equal(d0, g0) and torch.equal(d1, g1)


@pytest.mark.gpu
def test_mac_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (a Barrett constant that is not
    floor(2^64 / Q_j)) raises and counts nothing; nothing falls back, and
    the refusal does not leak into the next launch."""
    from ringsnark_tpu_torch.encoding import mac
    from ringsnark_tpu_torch.ops import cuda_mac

    ctx, level, c0, c1, pts = _mac_inputs("logreg", seed=3)
    q, mu = cuda_mac.barrett(ctx.level_primes(level))
    before = dict(cuda_mac.launch_counts)
    with monkeypatch.context() as m:
        m.setattr(cuda_mac, "barrett", lambda moduli: (q, mu - 1))
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda_mac.mac(ctx, level, c0, c1, pts, _mac_accs(ctx, level, 1))
    assert cuda_mac.launch_counts == before
    got, want = _mac_accs(ctx, level, 1), _mac_accs(ctx, level, 1)
    cuda_mac.mac(ctx, level, c0, c1, pts, got)
    mac.mac_plain(ctx, level, c0, c1, pts, want)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("field", [5, 7], ids=["multiplier", "minval"])
def test_mac_drawn_launcher_refuses_a_two_word_column(cuda, monkeypatch, field):
    """The C launcher takes only key columns drawn with one word and no
    offset (every inner prime's): a table that slips past the wrapper with
    a multiplier or a minval raises and counts nothing."""
    from ringsnark_tpu_torch.encoding import mac
    from ringsnark_tpu_torch.ops import cuda_mac
    from ringsnark_tpu_torch.utils import prng

    ctx, level, c0, _, pts = _mac_inputs("logreg", seed=4)
    n = c0.shape[0]
    table = cuda_mac._drawn_table(tuple(ctx.inner_primes), tuple(prng.key(53))).copy()
    table[0, field] = 225
    before = dict(cuda_mac.launch_counts)
    monkeypatch.setattr(cuda_mac, "_drawn_table", lambda primes, key: table)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_mac.mac_drawn(ctx, level, c0, mac.Drawn(prng.key(53), (n,), (0, n)), pts,
                           _mac_accs(ctx, level, 1))
    assert cuda_mac.launch_counts == before


@pytest.mark.gpu
def test_seeded_prove_draws_c1_in_the_mac(cuda):
    """The seeded prove launches mac_drawn and no uniform draw (c1 is never
    written), and its proof is the CPU's."""
    import numpy as np

    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.ops import cuda_mac, cuda_prng
    from ringsnark_tpu_torch.snark import groth16, seeded
    from ringsnark_tpu_torch.utils import interop, prng

    out = {}
    for dev in ("cuda", "cpu"):
        params = _small_params(2, dev)
        comp, primary, aux = build_synthetic_square_chain(params.ring, 32,
                                                          np.random.default_rng(50))
        kp = seeded.generator_seeded(comp, params, np.random.default_rng(51), prng.key(52),
                                     slab=16)
        before = dict(cuda_prng.launch_counts), dict(cuda_mac.launch_counts)
        proof = seeded.prover_seeded(kp.pk, primary, aux)
        if dev == "cuda":
            assert cuda_prng.launch_counts["uniform"] == before[0]["uniform"]
            assert cuda_mac.launch_counts["mac_drawn"] > before[1]["mac_drawn"]
            assert cuda_mac.launch_counts["mac"] == before[1]["mac"]
            assert groth16.verifier(kp.vk, primary, proof)
        out[dev] = interop.proof_to_numpy(proof)
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


# ---------------------------------------------------------------------------
# The witness map (csrc/witness.cu, ops/cuda_witness.py) against its plain
# versions: the int64 spmv (CompiledR1CS._evaluate_plain) and modops
# ---------------------------------------------------------------------------

def _chain(N: int, L: int, M: int, device: str, seed: int = 0):
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.rings.context import default_context

    ring = default_context(L=L, N=N, order=1 << 12, device=device)
    return (ring, *build_synthetic_square_chain(ring, M, __import__("numpy").random
                                                .default_rng(seed)))


# (ring slots N, limbs L, the window's first slot and width)
SPMV_CASES = {"n1_L3": (1, 3, 0, None), "window_1024": (2048, 1, 1024, 1024),
              "unaligned_1000": (1024, 2, 1, 1000), "narrow_16": (16, 2, 0, None),
              "narrow_unaligned_6": (8, 1, 1, 6)}


@pytest.mark.gpu
@pytest.mark.parametrize("slot_major", [False, True], ids=["rows", "slot_major"])
@pytest.mark.parametrize("case", SPMV_CASES)
def test_spmv_kernel_equals_plain(cuda, case, slot_major):
    """A, B, C of the squaring chain (M = 2048) on the card, one launch, ==
    the plain int64 spmv on the same tensors, the assignment read in place
    as three row blocks over a slot window (Z_q's L = 3 at n = 1; 1024 of
    2048 slots; the unaligned window [1, 1001): 4-byte words; 16 slots and
    the window [1, 7): warp tiles narrower than their 32 slots, 16-byte and
    4-byte words), in both layouts; and, again one launch, a system with a long row of 3000
    nonzeros gathering from all three blocks, a row of exactly LONG_ROW
    nonzeros and one of LONG_ROW + 1, and the constant column in every
    constraint (a long row of the transposed instance map)."""
    from ringsnark_tpu_torch.ops import cuda_witness
    from ringsnark_tpu_torch.relations.r1cs import LONG_ROW, CompiledR1CS

    N, L, lo, width = SPMV_CASES[case]
    ring, comp, primary, aux = _chain(N, L, 2048, "cuda")
    one = torch.ones((1, L, 1), dtype=torch.int32, device="cuda")
    blocks = (one, primary.res, aux.res)
    before = cuda_witness.launch_counts["spmv"]
    got = comp.evaluate(blocks, 2048 + 64, (0, 1, 2), lo, width, slot_major)
    torch.cuda.synchronize()
    assert cuda_witness.launch_counts["spmv"] == before + 1
    for w, g in enumerate(got):
        assert torch.equal(g, comp._evaluate_plain(blocks, 2048 + 64, w, lo, width, slot_major,
                                                   False))
    dev = "cuda"
    base = (torch.bincount(comp.rows[0], minlength=2048) + 1).tolist()  # with the constant's
    n11, n13 = LONG_ROW - base[11], LONG_ROW + 1 - base[13]
    rows = torch.cat([comp.rows[0], torch.full((3000,), 7, device=dev),
                      torch.full((n11,), 11, device=dev), torch.full((n13,), 13, device=dev),
                      torch.arange(2048, device=dev)])
    cols = torch.cat([comp.cols[0], torch.arange(3000, device=dev) % 2049,
                      torch.randint(0, 2049, (n11 + n13,), device=dev),
                      torch.zeros(2048, dtype=torch.int64, device=dev)])
    coeffs = _residues(ring.primes, 1, rows.numel(), cuda, seed=5)
    wide = CompiledR1CS(ctx=ring, num_constraints=2048, num_variables=comp.num_variables,
                        primary_input_size=1, rows=(rows,) * 3, cols=(cols,) * 3,
                        coeffs=(coeffs,) * 3)
    assert wide.csr(0).longs.tolist() == [7, 13] and wide.csr(0, transposed=True).nlong >= 1
    before = cuda_witness.launch_counts["spmv"]
    got = wide.evaluate(blocks, 2048, (0, 1, 2), lo, width, slot_major)
    torch.cuda.synchronize()
    assert cuda_witness.launch_counts["spmv"] == before + 1
    want = wide._evaluate_plain(blocks, 2048, 0, lo, width, slot_major, False)
    assert all(torch.equal(g, want) for g in got)
    u = _residues(ring.primes, 1, 2048, cuda, seed=6)
    got = wide.evaluate(u, comp.num_variables + 1, (0,), transposed=True)[0]
    assert torch.equal(got, wide._evaluate_plain((u,), comp.num_variables + 1, 0, 0, None,
                                                 False, True))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_witness.spmv([(comp.csr(0), comp.coeffs[0].cpu())], blocks, ring.primes, 2048, lo,
                          width or 1, slot_major)


@pytest.mark.gpu
@pytest.mark.parametrize("b_kind", ["full", "slot_constant", "odd_width"])
@pytest.mark.parametrize("add", [False, True])
def test_mulmod_kernel_equals_plain(cuda, b_kind, add):
    """a * b (+ c) mod p on the card == modops' int64 mul_mod / add_mod,
    every word p - 1 in half the rows: b full (16-byte words), a slot's
    constant, and an odd width (one word a thread); in place into a."""
    from ringsnark_tpu_torch.ops import cuda_witness
    from ringsnark_tpu_torch.ops.modops import add_mod, mul_mod
    from ringsnark_tpu_torch.rings.context import default_context

    ring = default_context(L=3, N=1, order=1 << 12, device="cuda")
    K = 1001 if b_kind == "odd_width" else 4096
    a = _residues(ring.primes, K, 16, cuda, seed=1)
    a[:8] = torch.tensor(ring.primes, dtype=torch.int32, device="cuda")[:, None] - 1
    b = _residues(ring.primes, 1 if b_kind == "slot_constant" else K, 16, cuda, seed=2)
    c = _residues(ring.primes, K, 16, cuda, seed=3) if add else None
    want = mul_mod(a, b, ring.p)
    want = add_mod(want, c, ring.p) if add else want
    before = cuda_witness.launch_counts["mulmod"]
    assert torch.equal(cuda_witness.mulmod(a, b, ring.primes, c), want)
    assert torch.equal(cuda_witness.mulmod(a, b, ring.primes, c, out=a), want)
    assert torch.equal(a, want) and cuda_witness.launch_counts["mulmod"] == before + 2
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_witness.mulmod(a.cpu(), b.cpu(), ring.primes)


@pytest.mark.gpu
@pytest.mark.parametrize("outputs", ["prover", "mid"])
def test_warm_witness_map_reads_nothing_back(cuda, outputs):
    """A warm witness map on the card (the CSR and coefficient pairs derived
    by the cold call) runs under torch.cuda.set_sync_debug_mode("error"):
    nothing of it reads the card back; its outputs equal the CPU's."""
    from ringsnark_tpu_torch.ops import cuda_witness
    from ringsnark_tpu_torch.reductions import r1cs_to_qrp as red
    from ringsnark_tpu_torch.rings.elem import RingElem
    from ringsnark_tpu_torch.utils.domain import RootsDomain

    outs = {}
    for dev in ("cuda", "cpu"):
        ring, comp, primary, aux = _chain(64, 2, 256, dev, seed=3)
        dom = RootsDomain(ring, 256)
        if outputs == "prover":
            def run():
                return red.prover_witness_map_chunked(comp, primary.res, aux.res, dom,
                                                      slot_chunk=32)
        else:
            rng = __import__("numpy").random.default_rng(4)
            ds = [RingElem.random_invertible_element(ring, rng).res for _ in range(3)]
            full, _, mid = red._assignment_batches(ring, primary, aux)

            def run():
                return red.witness_map_kernel_chunked(comp, full.res, None, mid.res, *ds, dom,
                                                      slot_chunk=32, outputs="mid")
        run()
        if dev == "cuda":
            torch.cuda.synchronize()
            before = dict(cuda_witness.launch_counts)
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert all(cuda_witness.launch_counts[k] > before[k] for k in cuda_witness.KERNELS)
        else:
            got = run()
        outs[dev] = [x.cpu() for x in got]
    for g, w in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(g, w)

