"""The host/oracle layer of ringsnark_tpu_torch against the JAX package, on
the CPU, on the same numpy-seeded inputs:

* ``RingElem.from_coeffs`` on canonical words, words in [p, 2^31) and words
  in [2^31, 2^32) (they are reduced before the transform, as the JAX
  package's first uint32 multiply reduces them);
* ``rings/oracle.py`` and ``utils/poly.py`` (exact Python-integer rings and
  list polynomials), ``utils/domain.py`` (``RootsDomain``'s reference
  interface, ``IntegerDomain``, ``get_evaluation_domain``): the oracle parts
  of ``tests/test_rings.py`` and ``tests/test_domain.py``;
* ``relations/qrp.py`` and ``reductions/r1cs_to_qrp.py`` (the instance map,
  the witness maps on tensors and on lists, the QRP checks): the tests of
  ``tests/test_reduction.py``, plus equality with the JAX maps, and the
  reference's slot-chunked prover witness map pinned (slot_chunk=2 at N=8);
* ``bgv.decrypt_to_slots_exact`` against the float64 decode,
  ``Encoding.sum_batch`` / ``zero`` / ``__iter__``, ``EncodingContext.
  num_levels`` / ``Q_total``;
* ``utils/profiling.py`` on the CPU.
"""

import json
import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu import gadgets as jgad
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import encode as jencode
from ringsnark_tpu.encoding import keygen as jkeygen
from ringsnark_tpu.encoding.bgv import decrypt_to_slots_exact as jdecrypt_exact
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.reductions import r1cs_to_qrp as jred
from ringsnark_tpu.relations.r1cs import R1CSConstraint as JR1CSConstraint
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.rings.oracle import OracleContext as JOracleContext
from ringsnark_tpu.rings.oracle import OracleElem as JOracleElem
from ringsnark_tpu.utils import domain as jdomain
from ringsnark_tpu_torch import gadgets as tgad
from ringsnark_tpu_torch.encoding import Encoding, EncodingContext, encode, inner_product, keygen
from ringsnark_tpu_torch.encoding.bgv import decrypt_to_slots, decrypt_to_slots_exact
from ringsnark_tpu_torch.reductions import r1cs_to_qrp as tred
from ringsnark_tpu_torch.relations.r1cs import R1CSConstraint
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.rings.oracle import OracleContext, OracleElem
from ringsnark_tpu_torch.utils import poly as _poly
from ringsnark_tpu_torch.utils import prng, profiling
from ringsnark_tpu_torch.utils.domain import IntegerDomain, RootsDomain, get_evaluation_domain


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _same(t, j) -> bool:
    """A port RingElem equals a JAX RingElem: the same residues (the JAX
    package may hold a slot value unreduced; both are read mod p)."""
    p = np.array(j.ctx.primes, np.uint64)[:, None]
    a, b = _u(t.res).astype(np.uint64), _u(j.res).astype(np.uint64)
    a, b = np.broadcast_arrays(a % p, b % p)
    return np.array_equal(a, b)


def _ctx(L, N, order=1 << 12):
    """The JAX context and the port's (CPU) over the same primes."""
    jctx = jdefault_context(L=L, N=N, order=order)
    return jctx, RingContext(primes=jctx.primes, N=N, device="cpu")


# ---------------------------------------------------------------------------
# rings: from_coeffs on unreduced words; the oracle ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0, None), ("p", 1 << 31), (1 << 31, 1 << 32)],
                         ids=["canonical", "p_to_2^31", "2^31_to_2^32"])
def test_from_coeffs_matches_jax_on_every_word_range(lo, hi):
    """Coefficient words in [0, p), [p, 2^31) and [2^31, 2^32) at L=2, N=16
    give the JAX package's slots (the last range did not before the words
    were reduced: an int32 cast made them negative)."""
    jctx, tctx = _ctx(2, 16)
    rng = np.random.default_rng(7)
    words = np.stack([rng.integers(p if lo == "p" else lo, p if hi is None else hi, 16,
                                   dtype=np.uint64) for p in jctx.primes]).astype(np.uint32)
    words = np.stack([words, words[::-1]])  # a batch of 2
    got = RingElem.from_coeffs(tctx, words)
    want = JRingElem.from_coeffs(jctx, jnp.asarray(words))
    assert np.array_equal(_u(got.res), _u(want.res))
    assert (_u(got.res) < np.array(jctx.primes, np.uint32)[:, None]).all()


def test_oracle_ring_consistency():
    ps = find_ntt_primes(2, 1 << 12)
    zq = RingContext(primes=tuple(ps), N=1, device="cpu")
    oc, joc = OracleContext(ps), JOracleContext(ps)
    rng = np.random.default_rng(6)
    x, y = (int.from_bytes(rng.bytes(16), "little") % oc.q for _ in range(2))
    a, b = RingElem.scalar(zq, x), RingElem.scalar(zq, y)
    oa, ob = OracleElem(oc, x), OracleElem(oc, y)
    ja, jb = JOracleElem(joc, x), JOracleElem(joc, y)
    assert (a * b + a - b).to_int() == (oa * ob + oa - ob).to_int() == (ja * jb + ja - jb).to_int()
    assert a.pow(11).to_int() == oa.pow(11).to_int() == ja.pow(11).to_int()
    assert (oa / ob).to_int() == (ja / jb).to_int() and (oa / ob) * ob == oa
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    assert (OracleElem.random_invertible_element(oc, r1).to_int()
            == JOracleElem.random_invertible_element(joc, r2).to_int())


def test_poly_mul_matches_negacyclic_oracle():
    _, rq = _ctx(2, 16)
    rng = np.random.default_rng(2)
    q, N = rq.q, rq.N
    ac = [int.from_bytes(rng.bytes(16), "little") % q for _ in range(N)]
    bc = [int.from_bytes(rng.bytes(16), "little") % q for _ in range(N)]
    ref = [0] * N
    for i, x in enumerate(ac):
        for j, y in enumerate(bc):
            ref[(i + j) % N] += x * y if i + j < N else -x * y
    got = _u((RingElem.from_int_coeffs(rq, ac) * RingElem.from_int_coeffs(rq, bc)).to_coeffs())
    for limb, p in enumerate(rq.primes):
        assert [int(v) for v in got[limb]] == [v % p for v in ref]


# ---------------------------------------------------------------------------
# domains (tests/test_domain.py) and polynomials
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zq2():
    return _ctx(2, 1)


def test_roots_domain_points_are_exceptional(zq2):
    jctx, ctx = zq2
    dom, jdom = RootsDomain(ctx, 8), jdomain.RootsDomain(jctx, 8)
    pts = dom.elements()
    assert dom.kind == jdom.kind == "roots" and len(pts) == dom.m == 8
    for i in range(dom.m):
        assert _same(pts[i], jdom.get_domain_element(i))
        for j in range(i + 1, dom.m):
            assert (pts[i] - pts[j]).is_invertible()


def test_roots_vanishing_matches_product(zq2):
    jctx, ctx = zq2
    dom = RootsDomain(ctx, 8)
    t = dom.random_exceptional(np.random.default_rng(0))
    direct = dom.compute_vanishing_polynomial(t)
    prod = RingElem.one(ctx)
    for x in dom.elements():
        prod = prod * (t - x)
    assert direct == prod
    z = dom.vanishing_polynomial()
    assert _poly.eval_poly(z, t) == direct
    jz = jdomain.RootsDomain(jctx, 8).vanishing_polynomial()
    assert len(z) == len(jz) == 9 and all(_same(a, b) for a, b in zip(z, jz))


def test_roots_lagrange_matches_generic(zq2):
    _, ctx = zq2
    dom = RootsDomain(ctx, 8)
    t = dom.random_exceptional(np.random.default_rng(1))
    fast = dom.evaluate_all_lagrange_polynomials(t)
    pts, one = dom.elements(), RingElem.one(ctx)
    for j in range(dom.m):
        num, den = one, one
        for i in range(dom.m):
            if i != j:
                num, den = num * (t - pts[i]), den * (pts[j] - pts[i])
        assert fast[j] == num / den


def test_roots_lagrange_interpolation_property(zq2):
    _, ctx = zq2
    dom = RootsDomain(ctx, 4)
    rng = np.random.default_rng(2)
    ys = [RingElem.random_element(ctx, rng) for _ in range(dom.m)]
    t = dom.random_exceptional(rng)
    lag = dom.evaluate_all_lagrange_polynomials(t)
    via_lagrange = sum((lag[j] * ys[j] for j in range(dom.m)), RingElem.zero(ctx))
    coeffs = _poly.interpolate(dom.elements(), ys)
    assert _poly.eval_poly(coeffs, t) == via_lagrange


def test_roots_interpolate_arr_matches_generic(zq2):
    jctx, ctx = zq2
    dom = RootsDomain(ctx, 8)
    rng = np.random.default_rng(3)
    ys = [RingElem.random_element(ctx, rng) for _ in range(dom.m)]
    gen = _poly.interpolate(dom.elements(), ys)
    fast = dom.interpolate_arr(RingElem.stack(ys).res.permute(2, 1, 0))[0]  # [L, M]
    for k in range(dom.m):
        assert RingElem(ctx, fast[:, k:k + 1]) == gen[k]
    jys = [JRingElem(jctx, jnp.asarray(_u(y.res))) for y in ys]
    jgen = _poly.interpolate(jdomain.RootsDomain(jctx, 8).elements(), jys)
    assert all(_same(a, b) for a, b in zip(gen, jgen))


def test_roots_divide_by_z_and_add_poly_z(zq2):
    jctx, ctx = zq2
    dom = RootsDomain(ctx, 4)
    rng = np.random.default_rng(4)
    Q = [RingElem.random_element(ctx, rng) for _ in range(dom.m - 1)]
    P = _poly.multiply(Q, dom.vanishing_polynomial())
    got = dom.divide_by_Z(P)
    assert len(got) >= len(Q)
    assert all(got[i] == Q[i] for i in range(len(Q)))
    assert all(got[i].is_zero() for i in range(len(Q), len(got)))
    c = RingElem.random_element(ctx, rng)
    H = dom.add_poly_Z(c, list(Q))
    jdom = jdomain.RootsDomain(jctx, 4)
    jH = jdom.add_poly_Z(JRingElem(jctx, jnp.asarray(_u(c.res))),
                         [JRingElem(jctx, jnp.asarray(_u(q.res))) for q in Q])
    assert len(H) == len(jH) == dom.m + 1 and all(_same(a, b) for a, b in zip(H, jH))
    assert all(_same(a, b) for a, b in zip(
        dom.divide_by_Z(H), jdom.divide_by_Z(jH)))


def test_integer_domain_matches_reference_semantics():
    """Over the oracle ring: interpolation round trip and the Lagrange
    identity, with the JAX package's IntegerDomain giving the same values."""
    ps = find_ntt_primes(2, 1 << 12)
    oc, joc = OracleContext(ps), JOracleContext(ps)
    dom = IntegerDomain(oc, 6, elem_cls=OracleElem)
    jdom = jdomain.IntegerDomain(joc, 6, elem_cls=JOracleElem)
    rng = np.random.default_rng(5)
    ys = [OracleElem(oc, int(rng.integers(0, 10**6))) for _ in range(6)]
    xs = dom.elements()
    coeffs = _poly.interpolate(xs, ys)
    for x, y in zip(xs, ys):
        assert _poly.eval_poly(coeffs, x) == y
    t = dom.random_exceptional(rng)
    lag = dom.evaluate_all_lagrange_polynomials(t)
    assert _poly.eval_poly(coeffs, t) == sum((lag[j] * ys[j] for j in range(6)), OracleElem(oc, 0))
    jlag = jdom.evaluate_all_lagrange_polynomials(JOracleElem(joc, t.to_int()))
    assert [v.to_int() for v in lag] == [v.to_int() for v in jlag]
    assert ([v.to_int() for v in dom.vanishing_polynomial()]
            == [v.to_int() for v in jdom.vanishing_polynomial()])


def test_integer_domain_division(zq2):
    _, ctx = zq2
    dom = IntegerDomain(ctx, 5)
    rng = np.random.default_rng(6)
    Q = [RingElem.random_element(ctx, rng) for _ in range(4)]
    got = dom.divide_by_Z(_poly.multiply(Q, dom.vanishing_polynomial()))
    assert len(got) == len(Q) and all(a == b for a, b in zip(got, Q))
    H = dom.add_poly_Z(RingElem.one(ctx), [RingElem.zero(ctx)])
    assert all(a == b for a, b in zip(H, dom.vanishing_polynomial()))


def test_get_evaluation_domain(zq2):
    _, ctx = zq2
    assert isinstance(get_evaluation_domain(ctx, 5), RootsDomain)
    assert get_evaluation_domain(ctx, 5).m == 8
    dom = get_evaluation_domain(ctx, 5, kind="integer")
    assert isinstance(dom, IntegerDomain) and dom.m == 5 and dom.kind == "integer"
    with pytest.raises(ValueError):
        get_evaluation_domain(ctx, 5, kind="coset")


# ---------------------------------------------------------------------------
# QRP relations and the reduction (tests/test_reduction.py)
# ---------------------------------------------------------------------------


def _reduction_circuit(pkg, ctx, Elem, Constraint):
    """test_reduction.py's circuit: x5 = x2 x3, x4 = (x0 + x1) x5, and a
    constraint with a constant term; values from one numpy seed."""
    pb = pkg.Protoboard(ctx)
    v = pkg.PBVariableArray()
    v.allocate(pb, 6, "x")
    pb.set_input_sizes(5)
    pb.add_r1cs_constraint(Constraint(v[2], v[3], v[5]))
    pb.add_r1cs_constraint(Constraint(v[0] + v[1], v[5], v[4]))
    pb.add_r1cs_constraint(Constraint(v[5] + 1, 1, v[5] + 1))
    rng = np.random.default_rng(11)
    vals = [Elem.random_element(ctx, rng) for _ in range(4)]
    v5 = vals[2] * vals[3]
    for i, val in enumerate(vals + [(vals[0] + vals[1]) * v5, v5]):
        pb.set_val(v[i], val)
    assert pb.is_satisfied()
    return pb


@pytest.fixture(scope="module", params=["scalar", "poly"])
def red(request):
    jctx, ctx = _ctx(2, 1 if request.param == "scalar" else 8)
    pb = _reduction_circuit(tgad, ctx, RingElem, R1CSConstraint)
    jpb = _reduction_circuit(jgad, jctx, JRingElem, JR1CSConstraint)
    return ctx, pb, jctx, jpb


def _ds(ctx, Elem, seed):
    rng = np.random.default_rng(seed)
    return [Elem.random_invertible_element(ctx, rng) for _ in range(3)]


def _cmp_vec(fast_batch, gen_list, name):
    """A RingElem batch against a list (which may be shorter: the extra
    entries of the batch are zero)."""
    flist = list(fast_batch)
    for i, g in enumerate(gen_list):
        assert flist[i] == g.broadcast_to_poly() or flist[i] == g, f"{name}[{i}]"
    assert all(f.is_zero() for f in flist[len(gen_list):]), name


_WIT = ("A_io", "B_io", "C_io", "A_mid", "B_mid", "C_mid", "Z", "H")


def test_witness_map_fast_vs_generic(red):
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    d1, d2, d3 = _ds(ctx, RingElem, 12)
    fast = tred.r1cs_to_qrp_witness_map(pb.compile(), pb.primary_input(), pb.auxiliary_input(),
                                        d1, d2, d3, dom)
    gen = tred.r1cs_to_qrp_witness_map_generic(pb.get_constraint_system(), pb.primary_input(),
                                               pb.auxiliary_input(), d1, d2, d3, dom)
    for name in _WIT:
        _cmp_vec(getattr(fast, f"coefficients_for_{name}"),
                 getattr(gen, f"coefficients_for_{name}"), name)


def test_witness_maps_equal_jax(red):
    """The port's witness maps (tensor and list) and instance map equal the
    JAX package's on the same circuit, domain and d's."""
    ctx, pb, jctx, jpb = red
    dom, jdom = RootsDomain(ctx, pb.num_constraints()), jdomain.RootsDomain(jctx, 3)
    ds, jds = _ds(ctx, RingElem, 12), _ds(jctx, JRingElem, 12)
    fast = tred.r1cs_to_qrp_witness_map(pb.compile(), pb.primary_input(), pb.auxiliary_input(),
                                        *ds, dom)
    jfast = jred.r1cs_to_qrp_witness_map(jpb.compile(), jpb.primary_input(),
                                         jpb.auxiliary_input(), *jds, jdom)
    gen = tred.r1cs_to_qrp_witness_map_generic(pb.get_constraint_system(), pb.primary_input(),
                                               pb.auxiliary_input(), *ds, dom)
    jgen = jred.r1cs_to_qrp_witness_map_generic(jpb.get_constraint_system(),
                                                jpb.primary_input(), jpb.auxiliary_input(),
                                                *jds, jdom)
    for name in _WIT + ("ABCs",):
        f, jf = (getattr(w, f"coefficients_for_{name}") for w in (fast, jfast))
        assert _same(f, jf), name
        if name != "ABCs":
            g, jg = (getattr(w, f"coefficients_for_{name}") for w in (gen, jgen))
            assert len(g) == len(jg) and all(_same(a, b) for a, b in zip(g, jg)), name
    inst = tred.r1cs_to_qrp_instance_map(pb.get_constraint_system(), dom)
    jinst = jred.r1cs_to_qrp_instance_map(jpb.get_constraint_system(), jdom)
    assert (inst.num_variables, inst.degree, inst.num_inputs) == (
        jinst.num_variables, jinst.degree, jinst.num_inputs)
    for m, jm in ((inst.A_in_Lagrange_basis, jinst.A_in_Lagrange_basis),
                  (inst.B_in_Lagrange_basis, jinst.B_in_Lagrange_basis),
                  (inst.C_in_Lagrange_basis, jinst.C_in_Lagrange_basis)):
        assert [{r: int(c) for r, c in d.items()} for d in m] == [
            {r: int(c) for r, c in d.items()} for d in jm]


def test_io_plus_mid_equals_full(red):
    """A_io + A_mid interpolates the full evaluations (the constant once)."""
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    zero, one = RingElem.zero(ctx), RingElem.one(ctx)
    wit = tred.r1cs_to_qrp_witness_map(pb.compile(), pb.primary_input(), pb.auxiliary_input(),
                                       zero, zero, zero, dom)
    full = pb.full_variable_assignment()
    for i, cons in enumerate(pb.get_constraint_system().constraints):
        want = cons.a.evaluate(full, one)
        got = _poly.eval_poly([wit.coefficients_for_A_io[k] + wit.coefficients_for_A_mid[k]
                               for k in range(dom.m)], dom.get_domain_element(i))
        assert got == want.broadcast_to_poly() or got == want


def test_qrp_instance_satisfied(red):
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    inst = tred.r1cs_to_qrp_instance_map(pb.get_constraint_system(), dom)
    wit = tred.r1cs_to_qrp_witness_map_generic(pb.get_constraint_system(), pb.primary_input(),
                                               pb.auxiliary_input(), *_ds(ctx, RingElem, 13), dom)
    assert inst.is_satisfied(wit, rng=np.random.default_rng(14))


def test_qrp_instance_eval_satisfied_fast_witness(red):
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    comp = pb.compile()
    t = dom.random_exceptional(np.random.default_rng(15))
    ev = tred.r1cs_to_qrp_instance_map_with_evaluation(comp, t, dom)
    wit = tred.r1cs_to_qrp_witness_map(comp, pb.primary_input(), pb.auxiliary_input(),
                                       *_ds(ctx, RingElem, 16), dom)
    assert ev.is_satisfied(wit)


def test_qrp_unsatisfied_witness_rejected(red):
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    comp = pb.compile()
    ev = tred.r1cs_to_qrp_instance_map_with_evaluation(
        comp, dom.random_exceptional(np.random.default_rng(16)), dom)
    zero = RingElem.zero(ctx)
    bad_aux = [v + RingElem.one(ctx) for v in pb.auxiliary_input()]
    wit = tred.r1cs_to_qrp_witness_map(comp, pb.primary_input(), bad_aux, zero, zero, zero, dom)
    assert not ev.is_satisfied(wit)


def test_instance_eval_fast_vs_generic_lagrange(red):
    ctx, pb, _, _ = red
    dom = RootsDomain(ctx, pb.num_constraints())
    t = dom.random_exceptional(np.random.default_rng(17))
    ev = tred.r1cs_to_qrp_instance_map_with_evaluation(pb.compile(), t, dom)
    inst = tred.r1cs_to_qrp_instance_map(pb.get_constraint_system(), dom)
    u = dom.evaluate_all_lagrange_polynomials(t)
    for Mmap, fast in ((inst.A_in_Lagrange_basis, ev.At), (inst.B_in_Lagrange_basis, ev.Bt),
                       (inst.C_in_Lagrange_basis, ev.Ct)):
        for k in range(pb.num_variables() + 1):
            acc = RingElem.zero(ctx)
            for row, coeff in Mmap[k].items():
                acc = acc + u[row] * coeff
            assert fast[k] == acc or fast[k] == acc.broadcast_to_poly()
    cur = RingElem.one(ctx)
    for i in range(dom.m + 1):
        assert ev.Ht[i] == cur
        cur = cur * t


def test_slot_chunked_prover_witness_map_pins_the_reference():
    """The reference's blind spot: the JAX `prover_witness_map_chunked` with
    slot_chunk=2 at N=8 (four slot chunks assembled in place) equals its
    unchunked `witness_map_kernel_chunked(outputs="prover")`, and the port's
    prover witness map, chunked the same way or not, equals both."""
    jctx, ctx = _ctx(2, 8)
    pb = _reduction_circuit(tgad, ctx, RingElem, R1CSConstraint)
    jpb = _reduction_circuit(jgad, jctx, JRingElem, JR1CSConstraint)
    jdom, dom = jdomain.RootsDomain(jctx, 3), RootsDomain(ctx, 3)
    jcomp, comp = jpb.compile(), pb.compile()
    jp, ja = jred._pa_batches(jctx, jpb.primary_input(), jpb.auxiliary_input())
    p_res, a_res = tred._pa_batches(ctx, pb.primary_input(), pb.auxiliary_input())
    chunked = jred.prover_witness_map_chunked(jcomp, jp, ja, jdom, slot_chunk=2)
    full, _, _ = jred._assignment_batches(jctx, jpb.primary_input(), jpb.auxiliary_input())
    zero = jnp.zeros((jctx.L, 1), dtype=jnp.uint32)
    unchunked = jred.witness_map_kernel_chunked(jcomp, full.res, None, None, zero, zero, zero,
                                                jdom, outputs="prover")
    port = tred.prover_witness_map_chunked(comp, p_res, a_res, dom, slot_chunk=2)
    port_whole = tred.prover_witness_map_chunked(comp, p_res, a_res, dom)
    for c, u, t, w in zip(chunked, unchunked, port, port_whole):
        assert c.shape[-1] == 8 and np.array_equal(_u(c), _u(u))
        assert np.array_equal(_u(t), _u(u)) and torch.equal(t, w)


# ---------------------------------------------------------------------------
# encodings: the exact decode, sum_batch / zero / __iter__, levels
# ---------------------------------------------------------------------------


def _enc_params(L=2, N=16, n_inner=64, count=4):
    jring = jdefault_context(L=L, N=N, order=1 << 12)
    inner, below = [], 1 << 31
    while len(inner) < count:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in jring.primes:
            inner.append(c)
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    return (JEncodingContext(ring=jring, n_inner=n_inner, inner_primes=tuple(inner)),
            EncodingContext(ring=tring, n_inner=n_inner, inner_primes=tuple(inner)))


@pytest.fixture(scope="module")
def enc_env():
    """Six encodings in both packages from one rng seed and key (equal), and
    the port's inner product of them, switched to the floor."""
    jectx, ectx = _enc_params()
    rj, rt = np.random.default_rng(20), np.random.default_rng(20)
    _, jsk = jkeygen(jectx, rj)
    _, sk = keygen(ectx, rt)
    slots = np.stack([np.stack([rt.integers(0, p, 16, dtype=np.uint64) for p in ectx.ring.primes])
                      for _ in range(6)]).astype(np.uint32)
    msgs = RingElem(ectx.ring, ectx.ring.tensor(slots))
    enc = encode(ectx, sk, msgs, prng.key(21))
    jenc = jencode(jectx, jsk, JRingElem(jectx.ring, jnp.asarray(slots)), jax.random.PRNGKey(21))
    assert np.array_equal(_u(enc.c0), _u(jenc.c0)) and np.array_equal(_u(enc.c1), _u(jenc.c1))
    coefs = RingElem(ectx.ring, ectx.ring.tensor(slots[::-1].copy()))
    return jectx, ectx, jsk, sk, jenc, enc, inner_product(enc, coefs)


def test_decrypt_exact_equals_float_decode_and_jax(enc_env):
    """The big-integer oracle gives the float64 decode's slots, on a fresh
    batch at level 0 and on the inner product at the floor level, and its
    budget within a bit where the budget is within float64's reach (at the
    floor; a fresh ciphertext's 89 bits read as the float's ceiling of 50);
    the JAX package's oracle gives the same."""
    jectx, ectx, jsk, sk, jenc, enc, ip = enc_env
    assert ip.level == ectx.L_inner - ectx.floor_limbs > 0
    for e in (enc, ip):
        slots, budget = decrypt_to_slots(ectx, sk, (e.c0, e.c1), e.level)
        xs, xb = decrypt_to_slots_exact(ectx, sk, (e.c0, e.c1), e.level)
        assert xs.dtype == torch.int32 and xb.dtype == torch.int64
        assert torch.equal(slots, xs) and (xb > 0).all() and (budget <= xb + 1).all()
        if e is ip:
            assert (budget - xb).abs().max() <= 1
        js, jb = jdecrypt_exact(jectx, jsk, (jnp.asarray(_u(e.c0)), jnp.asarray(_u(e.c1))),
                                e.level)
        assert np.array_equal(_u(xs), _u(js)) and np.array_equal(xb.numpy(), jb)


def test_sum_batch_zero_and_iter_equal_jax(enc_env):
    jectx, ectx, _, _, jenc, enc, _ = enc_env
    s, js = enc.sum_batch(), jenc.sum_batch()
    assert s.level == js.level == 0 and s.batch_shape == ()
    assert np.array_equal(_u(s.c0), _u(js.c0)) and np.array_equal(_u(s.c1), _u(js.c1))
    rows = list(enc)
    assert len(rows) == len(list(jenc)) == 6
    for r, jr in zip(rows, jenc):
        assert np.array_equal(_u(r.c0), _u(jr.c0)) and np.array_equal(_u(r.c1), _u(jr.c1))
    for shape, level in (((), 0), ((3,), 1)):
        z, jz = Encoding.zero(ectx, shape, level), type(jenc).zero(jectx, shape, level)
        assert z.is_zero_ct() and z.level == level and z.c0.device.type == "cpu"
        assert tuple(z.c0.shape) == tuple(jz.c0.shape) and z.c0.dtype == torch.int32
    assert (enc[0] + Encoding.zero(ectx)) == enc[0]


def test_context_levels_equal_jax(enc_env):
    jectx, ectx = enc_env[0], enc_env[1]
    assert ectx.num_levels == jectx.num_levels == 4
    for level in range(ectx.num_levels):
        assert ectx.Q_total(level) == jectx.Q_total(level)
    assert ectx.Q_total() == int(np.prod([int(q) for q in ectx.inner_primes], dtype=object))


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_timer_and_timings_on_the_cpu(caplog):
    t = profiling.Timings()
    for _ in range(2):
        with t.measure("work", device="cpu"):
            torch.ones(1000).sum()
    with t.measure("other"):
        pass
    assert set(t.records) == {"work", "other"} and t.records["work"] > 0
    assert set(json.loads(t.as_json())) == {"work", "other"} and "ms" in repr(t)
    with caplog.at_level(logging.INFO, logger="ringsnark_tpu_torch"):
        with profiling.timer("block", device="cpu") as rec:
            assert rec.seconds is None
            torch.ones(10).sum()
    assert rec.name == "block" and rec.seconds > 0
    assert "[TIME] block" in caplog.text


def test_ntt_roofline_and_trace_on_the_cpu(tmp_path):
    r = profiling.ntt_roofline(1024, 2, 4, 1e-3, device="cpu")
    assert r["butterflies"] == 4 * 2 * 512 * 10 and r["bytes_moved"] == 4 * 2 * 1024 * 8
    assert r["copy_GBps"] > 0 and r["floor_s"] == pytest.approx(r["bytes_moved"] / (
        r["copy_GBps"] * 1e9))
    assert r["share_of_floor"] == pytest.approx(r["floor_s"] / 1e-3)
    assert r["achieved_GBps"] == pytest.approx(r["bytes_moved"] / 1e-3 / 1e9)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(100).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").exists() and prof.key_averages()
