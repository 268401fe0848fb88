"""ringsnark_tpu_torch R1CS -> QRP reduction against the JAX package, on
the CPU, bit for bit: the instance map with evaluation, the prover's
witness map unchunked and slot-chunked, and the synthetic squaring chain.
Also pins the JAX package's own slot-chunked witness map against its
unchunked form (the chunked assembly had no test of its own)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ringsnark_tpu.gadgets import PBVariableArray, Protoboard
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.reductions import r1cs_to_qrp as jred
from ringsnark_tpu.relations.r1cs import R1CSConstraint
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.utils.domain import RootsDomain as JRootsDomain
from ringsnark_tpu_torch.models import synthetic as tsynth
from ringsnark_tpu_torch.reductions import r1cs_to_qrp as tred
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.utils.domain import RootsDomain
from ringsnark_tpu_torch.utils.interop import compiled_from_numpy


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


def _compiled_arrays(comp) -> dict:
    return {
        "rows": tuple(np.asarray(r) for r in comp.rows),
        "cols": tuple(np.asarray(c) for c in comp.cols),
        "coeffs": tuple(np.asarray(c) for c in comp.coeffs),
        "num_constraints": comp.num_constraints,
        "num_variables": comp.num_variables,
        "primary_input_size": comp.primary_input_size,
    }


@pytest.fixture(scope="module", params=[1, 8], ids=["Zq", "Rq"])
def circuit(request):
    """The toy circuit plus a constraint with a constant term, in both packages."""
    jring = jdefault_context(L=2, N=request.param, order=1 << 12)
    pb = Protoboard(jring)
    v = PBVariableArray()
    v.allocate(pb, 6, "x")
    pb.set_input_sizes(5)
    pb.add_r1cs_constraint(R1CSConstraint(v[2], v[3], v[5]))
    pb.add_r1cs_constraint(R1CSConstraint(v[0] + v[1], v[5], v[4]))
    pb.add_r1cs_constraint(R1CSConstraint(v[5] + 1, 1, v[5] + 1))
    rng = np.random.default_rng(11)
    vals = [JRingElem.random_element(jring, rng) for _ in range(4)]
    v5 = vals[2] * vals[3]
    v4 = (vals[0] + vals[1]) * v5
    for i, val in enumerate(vals):
        pb.set_val(v[i], val)
    pb.set_val(v[4], v4)
    pb.set_val(v[5], v5)
    assert pb.is_satisfied()
    jcomp = pb.compile()
    tring = RingContext(primes=jring.primes, N=jring.N, device="cpu")
    tcomp = compiled_from_numpy(tring, _compiled_arrays(jcomp))
    p_res, a_res = jred._pa_batches(jring, pb.primary_input(), pb.auxiliary_input())
    jdom = JRootsDomain(jring, pb.num_constraints())
    tdom = RootsDomain(tring, pb.num_constraints())
    return jring, jcomp, jdom, p_res, a_res, tring, tcomp, tdom


def test_instance_map_with_evaluation(circuit):
    jring, jcomp, jdom, _, _, tring, tcomp, tdom = circuit
    jt = jdom.random_exceptional(np.random.default_rng(17))
    tt = tdom.random_exceptional(np.random.default_rng(17))
    assert np.array_equal(_u(tt.res), np.asarray(jt.res))
    jev = jred.r1cs_to_qrp_instance_map_with_evaluation(jcomp, jt, jdom)
    tev = tred.r1cs_to_qrp_instance_map_with_evaluation(tcomp, tt, tdom)
    for name in ("At", "Bt", "Ct", "Ht", "Zt"):
        assert np.array_equal(_u(getattr(tev, name).res), np.asarray(getattr(jev, name).res)), name
    assert (tev.num_variables, tev.degree, tev.num_inputs) == (
        jev.num_variables, jev.degree, jev.num_inputs)


def test_witness_map_prover_unchunked(circuit):
    _, jcomp, jdom, p_res, a_res, _, tcomp, tdom = circuit
    want = jred.prover_witness_map_chunked(jcomp, p_res, a_res, jdom)
    got = tred.prover_witness_map_chunked(tcomp, _t(p_res), _t(a_res), tdom)
    for name, w, g in zip(("a_full", "b_full", "H"), want, got):
        assert np.array_equal(_u(g), np.asarray(w)), name


def test_witness_map_prover_slot_chunked():
    """slot_chunk=2 at N=8: the port's chunked form equals the JAX package's
    chunked form, which in turn equals the JAX unchunked prover-mode map."""
    jring = jdefault_context(L=2, N=8, order=1 << 12)
    jcomp, jprim, jaux = jsquare_chain(jring, 6, np.random.default_rng(3))
    jdom = JRootsDomain(jring, jcomp.num_constraints)
    p_res, a_res = jprim.res, jaux.res

    jchunked = jred.prover_witness_map_chunked(jcomp, p_res, a_res, jdom, slot_chunk=2)
    full, io, mid = jred._assignment_batches(jring, jprim, jaux)
    zero = jnp.zeros((jring.L, 1), dtype=jnp.uint32)
    junchunked = jred.witness_map_kernel_chunked(
        jcomp, full.res, io.res, mid.res, zero, zero, zero, jdom,
        slot_chunk=jring.N, outputs="prover",
    )
    tring = RingContext(primes=jring.primes, N=8, device="cpu")
    tcomp = compiled_from_numpy(tring, _compiled_arrays(jcomp))
    tdom = RootsDomain(tring, tcomp.num_constraints)
    tchunked = tred.prover_witness_map_chunked(tcomp, _t(p_res), _t(a_res), tdom, slot_chunk=2)
    tunchunked = tred.prover_witness_map_chunked(tcomp, _t(p_res), _t(a_res), tdom)
    for name, jc, ju, tc, tu in zip(("a_full", "b_full", "H"), jchunked, junchunked,
                                    tchunked, tunchunked):
        assert np.array_equal(np.asarray(jc), np.asarray(ju)), f"JAX chunked {name}"
        assert np.array_equal(_u(tc), np.asarray(jc)), f"port chunked {name}"
        assert torch.equal(tc, tu), f"port chunked vs unchunked {name}"


@pytest.mark.parametrize("N", [1, 16])
def test_square_chain_matches_jax_and_device_path(N):
    jring = jdefault_context(L=2, N=N, order=1 << 12)
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    jcomp, jprim, jaux = jsquare_chain(jring, 32, np.random.default_rng(9))
    tcomp, tprim, taux = tsynth.build_synthetic_square_chain(tring, 32, np.random.default_rng(9))
    assert np.array_equal(_u(tprim.res), np.asarray(jprim.res))
    assert np.array_equal(_u(taux.res), np.asarray(jaux.res))
    want = _compiled_arrays(jcomp)
    for key in ("rows", "cols", "coeffs"):
        for w, g in zip(want[key], getattr(tcomp, key)):
            assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype)), key
    # the device-side chain (used at Rq scale) equals the host chain
    x0 = _u(tprim.res[0])
    dev = tsynth._device_square_chain(tring, x0, 33)
    assert torch.equal(dev, torch.cat([tprim.res, taux.res]))


def test_domain_transforms_poly_eval_and_ring_coeffs(circuit):
    """RootsDomain.evaluate_arr / interpolate_arr, utils.poly_arr.eval_coeffs_at
    and RingElem's coefficient <-> slot conversion against the JAX package."""
    from ringsnark_tpu.utils.poly_arr import eval_coeffs_at as jeval_coeffs_at
    from ringsnark_tpu_torch.rings.elem import RingElem
    from ringsnark_tpu_torch.utils.poly_arr import eval_coeffs_at

    jring, _, jdom, _, _, tring, _, tdom = circuit
    rng = np.random.default_rng(19)
    c = np.stack([rng.integers(0, p, (5, jdom.m), dtype=np.uint64) for p in jring.primes],
                 axis=1).astype(np.uint32)  # [5, L, M]
    ev = np.asarray(jdom.evaluate_arr(jnp.asarray(c)))
    assert np.array_equal(_u(tdom.evaluate_arr(_t(c))), ev)
    assert np.array_equal(_u(tdom.interpolate_arr(_t(ev))), c)

    coeffs = np.stack([rng.integers(0, p, (7, jring.N), dtype=np.uint64)
                       for p in jring.primes], axis=1).astype(np.uint32)  # [7, L, N]
    s = jdom.random_exceptional(np.random.default_rng(20))
    want = jeval_coeffs_at(JRingElem(jring, jnp.asarray(coeffs)), s)
    got = eval_coeffs_at(RingElem(tring, _t(coeffs)), RingElem(tring, _t(s.res)))
    assert np.array_equal(got.numpy(), np.asarray(want.res))

    if jring.N > 1:
        jr = JRingElem.from_coeffs(jring, jnp.asarray(coeffs))
        tr = RingElem.from_coeffs(tring, coeffs)
        assert np.array_equal(tr.numpy(), np.asarray(jr.res))
        assert np.array_equal(_u(tr.to_coeffs()), coeffs)
