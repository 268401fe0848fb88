"""The application circuits and the outer BGV helper of ringsnark_tpu_torch
against the JAX package, on the CPU.  One numpy seed gives, in both
packages, the same constraint system (term indices and coefficients), the
same compiled arrays and the same assignment wire for wire; both are
satisfied.  `OuterBGV` gives the same ciphertexts from the same seed (and
the same threefry key), and decrypts them.  All comparisons are exact (==).
"""

import numpy as np
import pytest
import jax
import torch

from ringsnark_tpu import models as jmodels
from ringsnark_tpu.models.incircuit_ntt import negacyclic_eval_points as jeval_points
from ringsnark_tpu.models.synthetic import build_synthetic_mul_chain as jmul_chain
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu_torch import models as tmodels
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.utils import interop


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _ctxs(N, L=2):
    jctx = jdefault_context(L=L, N=N, order=1 << 12)
    return jctx, RingContext(primes=jctx.primes, N=N, device="cpu")


# name -> (N, build(models module, ctx, rng))
CIRCUITS = {
    "toy": (16, lambda m, c, r: m.build_toy_circuit(c, r)),
    "toy_replicated_Zq": (1, lambda m, c, r: m.build_toy_circuit(c, r, replicate=4)),
    "plaintext_check": (16, lambda m, c, r: m.build_plaintext_check(c, r, log_t=8)),
    "plaintext_check_logT32": (16, lambda m, c, r: m.build_plaintext_check(c, r, log_t=32)),
    "ct_mul": (16, lambda m, c, r: m.build_ct_mul(c, r, log_t=8)),
    "incircuit_ntt": (16, lambda m, c, r: m.build_incircuit_ntt(c, r)),
    "logreg": (16, lambda m, c, r: m.build_logreg_inference(c, r, num_features=4, log_t=8)),
}
SHAPES = {  # constraints, variables, inputs
    "toy": (2, 6, 5), "toy_replicated_Zq": (8, 24, 20), "plaintext_check": (9, 9, 1),
    "plaintext_check_logT32": (33, 33, 1), "ct_mul": (4, 8, 8), "incircuit_ntt": (1, 17, 17),
    "logreg": (23, 39, 21),
}


def _coeff(c):
    return c if isinstance(c, int) else _u(c.res)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_matches_jax(name):
    N, build = CIRCUITS[name]
    jctx, tctx = _ctxs(N)
    jpb = build(jmodels, jctx, np.random.default_rng(31))
    tpb = build(tmodels, tctx, np.random.default_rng(31))
    assert (tpb.num_constraints(), tpb.num_variables(), tpb.num_inputs()) == SHAPES[name]
    jcs, tcs = jpb.get_constraint_system(), tpb.get_constraint_system()
    assert (tcs.primary_input_size, tcs.auxiliary_input_size) == (
        jcs.primary_input_size, jcs.auxiliary_input_size)
    # the same constraint system, term for term
    assert len(tcs.constraints) == len(jcs.constraints)
    for tc, jc in zip(tcs.constraints, jcs.constraints):
        for which in "abc":
            tt, jt = getattr(tc, which).terms, getattr(jc, which).terms
            assert [t.index for t in tt] == [t.index for t in jt]
            for a, b in zip(tt, jt):
                assert isinstance(a.coeff, int) == isinstance(b.coeff, int)
                assert np.array_equal(_coeff(a.coeff), _coeff(b.coeff))
    # the same compiled arrays
    tcomp, jcomp = tpb.compile(), jpb.compile()
    for k in range(3):
        assert np.array_equal(tcomp.rows[k].numpy(), np.asarray(jcomp.rows[k]))
        assert np.array_equal(tcomp.cols[k].numpy(), np.asarray(jcomp.cols[k]))
        assert tuple(tcomp.coeffs[k].shape) == tuple(jcomp.coeffs[k].shape)
        assert np.array_equal(_u(tcomp.coeffs[k]), np.asarray(jcomp.coeffs[k]))
    # the same assignment, wire for wire (and as one batch).  The port holds
    # canonical residues; the JAX plaintext check stores its public slot
    # values (up to 2^logT - 1, past a 31-bit prime at logT = 32) unreduced.
    p = np.array(jctx.primes, dtype=np.uint64)[:, None]

    def canon(a):
        return (np.asarray(a).astype(np.uint64) % p).astype(np.uint32)

    for i, (tv, jv) in enumerate(zip(tpb.full_variable_assignment(),
                                     jpb.full_variable_assignment())):
        assert tuple(tv.res.shape) == tuple(jv.res.shape), i
        assert np.array_equal(_u(tv.res), canon(jv.res)), i
    assert np.array_equal(_u(tpb.full_assignment_batch().res),
                          canon(jpb.full_assignment_batch().res))
    assert len(tpb.primary_input()) == tcs.primary_input_size
    assert len(tpb.auxiliary_input()) == tcs.auxiliary_input_size
    assert tpb.is_satisfied() and jpb.is_satisfied()
    assert tcs.is_valid()


def test_circuit_with_a_wrong_wire_is_unsatisfied():
    _, tctx = _ctxs(16)
    pb = tmodels.build_logreg_inference(tctx, np.random.default_rng(1), num_features=2, log_t=8)
    assert pb.is_satisfied()
    cs = pb.get_constraint_system()
    assert cs.is_satisfied(pb.primary_input(), pb.auxiliary_input())  # host path
    last = pb.num_variables()
    pb.values[last - 1] = pb.values[last - 1] + 1
    assert not pb.is_satisfied()
    assert not cs.is_satisfied(pb.primary_input(), pb.auxiliary_input())


def test_negacyclic_eval_points_match_jax():
    jctx, tctx = _ctxs(16)
    got = tmodels.negacyclic_eval_points(tctx)
    assert got.dtype == np.uint32 and np.array_equal(got, jeval_points(jctx))
    # slot j of from_coeffs(X) is the evaluation point of slot j
    x = np.zeros((2, 16), np.uint32)
    x[:, 1] = 1
    assert np.array_equal(RingElem.from_coeffs(tctx, x).numpy(), got)


def test_synthetic_mul_chain_matches_jax():
    jctx, tctx = _ctxs(16)
    jcomp, jprim, jaux = jmul_chain(jctx, 8, np.random.default_rng(3), num_public_gates=2)
    tcomp, tprim, taux = tmodels.build_synthetic_mul_chain(tctx, 8, np.random.default_rng(3),
                                                           num_public_gates=2)
    assert (tcomp.num_constraints, tcomp.num_variables, tcomp.primary_input_size) == (8, 24, 6)
    for k in range(3):
        assert np.array_equal(tcomp.rows[k].numpy(), np.asarray(jcomp.rows[k]))
        assert np.array_equal(tcomp.cols[k].numpy(), np.asarray(jcomp.cols[k]))
        assert np.array_equal(_u(tcomp.coeffs[k]), np.asarray(jcomp.coeffs[k]))
    assert np.array_equal(_u(tprim.res), np.asarray(jprim.res))
    assert np.array_equal(_u(taux.res), np.asarray(jaux.res))
    z = torch.cat([RingElem.one(tctx).res.expand(1, 2, 16), tprim.res, taux.res])
    assert tcomp.is_satisfied(z)
    z[5] = z[5] + 1
    assert not tcomp.is_satisfied(z)


# ---------------------------------------------------------------------------
# the outer BGV helper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fhes():
    jctx = jdefault_context(L=3, N=16, order=1 << 12)
    tctx = RingContext(primes=jctx.primes, N=16, device="cpu")
    jf = jmodels.OuterBGV(jctx, log_t=8, rng=np.random.default_rng(0))
    tf = tmodels.OuterBGV(tctx, log_t=8, rng=np.random.default_rng(0))
    return jf, tf


def test_outer_bgv_encrypt_multiply_decrypt_match_jax(fhes):
    """tests/test_models.py::test_outer_bgv_roundtrip, in both packages from
    one seed: the secret, the ciphertexts and the products are the same bits."""
    jf, tf = fhes
    assert np.array_equal(tf.s_coeffs, jf.s_coeffs)
    assert np.array_equal(_u(tf.s.res), np.asarray(jf.s.res))
    m = [int(x) for x in np.random.default_rng(40).integers(0, 256, 16)]
    m2 = [3] + [0] * 15
    jct, tct = jf.encrypt(m), tf.encrypt(m)
    jct2, tct2 = jf.encrypt(m2), tf.encrypt(m2)
    for t, j in zip(tct + tct2, jct + jct2):
        assert np.array_equal(_u(t.res), np.asarray(j.res))
    assert tf.decrypt(tct) == m == jf.decrypt(jct)
    tprod, jprod = tmodels.OuterBGV.multiply(tct, tct2), jmodels.OuterBGV.multiply(jct, jct2)
    for t, j in zip(tprod, jprod):
        assert np.array_equal(_u(t.res), np.asarray(j.res))
    assert tf.decrypt(tprod) == [(3 * x) % 256 for x in m]  # negacyclic conv with constant 3
    with pytest.raises(AssertionError):
        tf.encrypt([256] + [0] * 15)


@pytest.mark.parametrize("keyed", [False, True], ids=["host_rng", "threefry_key"])
def test_outer_bgv_encrypt_batch_matches_jax(fhes, keyed):
    jf, tf = fhes
    msgs = np.random.default_rng(41).integers(0, 256, size=(5, 16)).astype(np.int64)
    if keyed:
        jkey = jax.random.key(3, impl="threefry2x32")
        tkey = interop.key_from_numpy(np.asarray(jax.random.key_data(jkey)))
        (jc0, jc1), (tc0, tc1) = jf.encrypt_batch(msgs, key=jkey), tf.encrypt_batch(msgs, key=tkey)
    else:
        jf.rng, tf.rng = np.random.default_rng(42), np.random.default_rng(42)
        (jc0, jc1), (tc0, tc1) = jf.encrypt_batch(msgs), tf.encrypt_batch(torch.from_numpy(msgs))
    assert tuple(tc0.res.shape) == (5, 3, 16)
    assert np.array_equal(_u(tc0.res), np.asarray(jc0.res))
    assert np.array_equal(_u(tc1.res), np.asarray(jc1.res))
    for i in range(5):
        assert tf.decrypt((tc0[i], tc1[i])) == [int(v) for v in msgs[i]]


def test_outer_bgv_needs_a_polynomial_ring():
    _, tctx = _ctxs(1)
    with pytest.raises(AssertionError, match="polynomial ring"):
        tmodels.OuterBGV(tctx, 8, np.random.default_rng(0))
