"""The port's native binding and CPU prover (ringsnark_tpu_torch.native)
against the JAX package's (ringsnark_tpu.native) and its transforms, on the
CPU: the binding builds the library from native/ringsnark_native.cpp into
ringsnark_tpu_torch/_build/ at first use, its NTTs run on the port's plans,
and every comparison is exact (==)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ringsnark_tpu import native as jnative
from ringsnark_tpu.native.cpu_prover import groth16_prover_cpu as jprover_cpu
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.ops import ntt as jntt
from ringsnark_tpu.ops import primes as pr
from ringsnark_tpu.reductions.r1cs_to_qrp import _assignment_batches as j_assignment_batches
from ringsnark_tpu.reductions.r1cs_to_qrp import witness_map_kernel_chunked as jwitness_map
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.utils.domain import RootsDomain as JRootsDomain
from ringsnark_tpu_torch import native
from ringsnark_tpu_torch.encoding import EncodingContext
from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu_torch.native.cpu_prover import groth16_prover_cpu
from ringsnark_tpu_torch.ops import ntt as tntt
from ringsnark_tpu_torch.reductions.r1cs_to_qrp import _assignment_batches
from ringsnark_tpu_torch.rings.context import RingContext

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no C++ compiler)"
)


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


def test_library_built_from_the_repo_source():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE.name == "ringsnark_native.cpp" and native.SOURCE.parent.name == "native"
    assert native.build() == path  # the same source and command reuse the library


def test_build_takes_the_next_compiler_where_one_fails(monkeypatch, tmp_path):
    """A $CXX that cannot build the source (e.g. without OpenMP) gives way to
    g++ on the PATH; where no compiler builds it, the error names each."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "/bin/false")
    assert native._compilers()[0] == "/bin/false"
    path = native.build()
    assert path.parent == tmp_path and path.exists()
    monkeypatch.setattr(native, "_compilers", lambda: ["/bin/false", str(tmp_path / "no-cxx")])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "other")
    with pytest.raises(RuntimeError, match="/bin/false failed") as err:
        native.build()
    assert "no-cxx" in str(err.value)


def test_native_scalar_ops():
    p = pr.find_ntt_primes(1, 1 << 12)[0]
    rng = np.random.default_rng(0)
    for _ in range(50):
        a, b = int(rng.integers(0, p)), int(rng.integers(0, p))
        assert native.mulmod(a, b, p) == a * b % p == jnative.mulmod(a, b, p)
        assert native.powmod(a, 12345, p) == pow(a, 12345, p) == jnative.powmod(a, 12345, p)
        if a:
            assert native.invmod(a, p) == pow(a, -1, p) == jnative.invmod(a, p)


@pytest.mark.parametrize("M", [16, 256])
def test_native_ntt_on_port_plans_matches_jax(M):
    """The native negacyclic pair on the roots of the port's plan equals
    JAX's transform and the port's twin; the inverse gives the input back."""
    ps = tuple(pr.find_ntt_primes(2, 1 << 12))
    plan = tntt.get_plan(ps, M, negacyclic=True)
    jplan = jntt.get_plan(ps, M, negacyclic=True)
    assert plan.w_np == tuple(int(w) for w in jplan.w_np)
    rng = np.random.default_rng(1)
    for l, p in enumerate(ps):
        x = rng.integers(0, p, (4, M)).astype(np.uint32)
        w, psi = plan.w_np[l], int(plan.psi[l, 1])
        got = native.negacyclic_ntt(x, p, w, psi)
        plan1 = jntt.get_plan((p,), M, negacyclic=True)
        want = np.asarray(jntt.negacyclic_ntt_rev(jnp.asarray(x[:, None, :]), plan1))[:, 0, :]
        assert (got == want).all()
        tplan1 = tntt.get_plan((p,), M, negacyclic=True)
        assert (got == _u(tntt.negacyclic_ntt_rev(_t(x[:, None, :]), tplan1))[:, 0, :]).all()
        assert (native.negacyclic_intt(got, p, w, psi) == x).all()
        assert (got == jnative.negacyclic_ntt(x, p, w, psi)).all()


def test_native_cyclic_roundtrip_and_match():
    ps = tuple(pr.find_ntt_primes(1, 1 << 12))
    p = ps[0]
    M = 64
    plan = tntt.get_plan(ps, M)
    rng = np.random.default_rng(2)
    x = rng.integers(0, p, (3, M)).astype(np.uint32)
    got = native.cyclic_ntt(x, p, plan.w_np[0])
    want = np.asarray(jntt.cyclic_ntt_rev(jnp.asarray(x[:, None, :]),
                                          jntt.get_plan(ps, M)))[:, 0, :]
    assert (got == want).all()
    assert (got == _u(tntt.cyclic_ntt_rev(_t(x[:, None, :]), plan))[:, 0, :]).all()
    assert (native.cyclic_intt(got, p, plan.w_np[0]) == x).all()


def test_native_inner_product():
    p = pr.find_ntt_primes(1, 1 << 12)[0]
    rng = np.random.default_rng(3)
    ct = rng.integers(0, p, (10, 32)).astype(np.uint32)
    pt = rng.integers(0, p, (10, 32)).astype(np.uint32)
    got = native.ip_accumulate(ct, pt, p)
    want = (ct.astype(np.uint64) * pt.astype(np.uint64)).sum(axis=0) % p
    assert (got == want.astype(np.uint32)).all()
    assert (got == jnative.ip_accumulate(ct, pt, p)).all()
    w = rng.integers(0, p, 10).astype(np.uint32)
    assert (native.ip_accumulate_scalar(ct, w, p) == jnative.ip_accumulate_scalar(ct, w, p)).all()
    assert (native.lift_rows(ct, p, 2 * p + 1) == jnative.lift_rows(ct, p, 2 * p + 1)).all()


def _witness_map_case(L, N, M, seed):
    """The JAX prover-mode witness map and the port's compiled system of the
    same squaring chain, with the port's plans."""
    jring = jdefault_context(L=L, N=N, order=1 << 10)
    ring = RingContext(primes=jring.primes, N=N, device="cpu")
    jcomp, jprimary, jaux = jsquare_chain(jring, M, np.random.default_rng(seed))
    comp, primary, aux = build_synthetic_square_chain(ring, M, np.random.default_rng(seed))
    full, io, mid = j_assignment_batches(jring, jprimary, jaux)
    zero = jnp.zeros((jring.L, 1), dtype=jnp.uint32)
    want = jwitness_map(jcomp, full.res, io.res, mid.res, zero, zero, zero,
                        JRootsDomain(jring, M), outputs="prover")
    tfull, _, _ = _assignment_batches(ring, primary, aux)
    return ring, comp, _u(tfull.res), [np.asarray(w) for w in want]


def test_native_witness_map_bitexact_zq():
    """The C++ prover-mode witness map on the port's compiled system and
    plans equals the JAX kernel's bit for bit."""
    M = 64
    ring, comp, z, (a_full, b_full, H) = _witness_map_case(2, 1, M, 5)
    plan_M, plan_2M = tntt.get_plan(ring.primes, M), tntt.get_plan(ring.primes, 2 * M)
    for l, p in enumerate(ring.primes):
        coo = [(comp.rows[i].numpy(), comp.cols[i].numpy(), _u(comp.coeffs[i])[:, l, 0])
               for i in (0, 1)]
        na, nb, nh = native.g16_witness_map(coo[0], coo[1], z[:, l, 0], M, p,
                                            plan_M.w_np[l], plan_2M.w_np[l])
        assert (na[:, 0] == a_full[:, l, 0]).all()
        assert (nb[:, 0] == b_full[:, l, 0]).all()
        assert (nh[:, 0] == H[:, l, 0]).all()


def test_native_witness_map_bitexact_dense():
    M, N = 32, 8
    ring, comp, z, (a_full, b_full, H) = _witness_map_case(1, N, M, 6)
    plan_M, plan_2M = tntt.get_plan(ring.primes, M), tntt.get_plan(ring.primes, 2 * M)
    coo = [(comp.rows[i].numpy(), comp.cols[i].numpy(), _u(comp.coeffs[i])[:, 0, 0])
           for i in (0, 1)]
    na, nb, nh = native.g16_witness_map(coo[0], coo[1], np.broadcast_to(z, (z.shape[0], 1, N))[:, 0],
                                        M, ring.primes[0], plan_M.w_np[0], plan_2M.w_np[0])
    assert (na == np.broadcast_to(a_full, (M, 1, N))[:, 0]).all()
    assert (nb == np.broadcast_to(b_full, (M, 1, N))[:, 0]).all()
    assert (nh == np.broadcast_to(H, (M + 1, 1, N))[:, 0]).all()


@pytest.mark.parametrize("N", [1, 8])
def test_native_cpu_prover_matches_jax(N):
    """groth16_prover_cpu runs on the port's objects, gives sane timings,
    and its witness-map outputs equal the JAX package's prover's on the same
    system (Z_q and a dense ring)."""
    jring = jdefault_context(L=1, N=N, order=1 << 11)
    ring = RingContext(primes=jring.primes, N=N, device="cpu")
    inner = tuple(p for p in pr.find_ntt_primes(4, 1 << 11) if p not in ring.primes)[:2]
    jcomp, jprimary, jaux = jsquare_chain(jring, 32, np.random.default_rng(7))
    comp, primary, aux = build_synthetic_square_chain(ring, 32, np.random.default_rng(7))
    jfull, _, _ = j_assignment_batches(jring, jprimary, jaux)
    full, _, _ = _assignment_batches(ring, primary, aux)
    jt, jouts = jprover_cpu(jcomp, JEncodingContext(ring=jring, n_inner=512, inner_primes=inner),
                            np.asarray(jfull.res), np.asarray(jaux.res), np.random.default_rng(8))
    t, outs = groth16_prover_cpu(comp, EncodingContext(ring=ring, n_inner=512,
                                                       inner_primes=inner),
                                 full.res, aux.res, np.random.default_rng(8))
    assert set(t) == set(jt) and t["total_s"] >= 0 and len(outs) == ring.L
    for mine, theirs in zip(outs, jouts):
        for a, b in zip(mine, theirs):
            assert np.array_equal(a, np.asarray(b))
