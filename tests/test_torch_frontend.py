"""The circuit frontend of ringsnark_tpu_torch against the JAX package, on the
CPU: formal variables and linear combinations, the RingElem methods the
frontend needs, R1CS constraint systems (validity, satisfaction, the A/B
swap, equality, `compile`, the JSON round trip across the two packages) and
the gadgets.  Every comparison is exact (==): the same construction in both
packages gives the same terms, the same compiled arrays and the same values.
"""

import numpy as np
import pytest
import torch

from ringsnark_tpu import gadgets as jgad
from ringsnark_tpu.relations import r1cs as jr1cs
from ringsnark_tpu.relations import variable as jvar
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu_torch import gadgets as tgad
from ringsnark_tpu_torch.relations import r1cs as tr1cs
from ringsnark_tpu_torch.relations import variable as tvar
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem


class Side:
    """One package's frontend names plus a ring context, so one construction
    runs in both."""

    def __init__(self, var, r1cs, gad, elem, ctx):
        self.var, self.r1cs, self.gad, self.Elem, self.ctx = var, r1cs, gad, elem, ctx

    def elem(self, residues):
        """A ring element from uint32 residues [L, n]."""
        return self.Elem.from_slots(self.ctx, np.asarray(residues, dtype=np.uint32))

    def random(self, seed):
        return self.Elem.random_element(self.ctx, np.random.default_rng(seed))


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _res(e) -> np.ndarray:
    return _u(e.res)


@pytest.fixture(scope="module")
def sides():
    jctx = jdefault_context(L=2, N=8, order=1 << 12)
    tctx = RingContext(primes=jctx.primes, N=8, device="cpu")
    return Side(jvar, jr1cs, jgad, JRingElem, jctx), Side(tvar, tr1cs, tgad, RingElem, tctx)


def _terms(lc):
    return [(t.index, t.coeff if isinstance(t.coeff, int) else _res(t.coeff)) for t in lc.terms]


def _same_terms(a, b) -> bool:
    if len(a) != len(b):
        return False
    for (ia, ca), (ib, cb) in zip(a, b):
        if ia != ib or isinstance(ca, int) != isinstance(cb, int):
            return False
        if not (ca == cb if isinstance(ca, int) else np.array_equal(ca, cb)):
            return False
    return True


def _x(s, i):
    return s.var.Variable(i)


LC_CASES = {
    # tests/test_relations.py::test_lc_merge_and_evaluate
    "merge": lambda s: _x(s, 1) + _x(s, 2) + _x(s, 1) * 3 + 5,
    "sub_neg_rsub": lambda s: (_x(s, 1) - _x(s, 2)) - (-_x(s, 3)) + (7 - _x(s, 1)),
    "lc_times_int": lambda s: (_x(s, 1) + 2 * _x(s, 2) + 3) * -4,
    "int_minus_lc": lambda s: 5 - (_x(s, 1) + _x(s, 2)),
    "from_terms": lambda s: s.var.LinearCombination.from_terms(
        [s.var.LinearTerm(3, 2), s.var.LinearTerm(1, 1), s.var.LinearTerm(3, 5),
         s.var.LinearTerm(0, -1)]),
    "cancel_keeps_zero_term": lambda s: _x(s, 2) - _x(s, 2) + _x(s, 1),
    "ring_coeffs_merge": lambda s: (_x(s, 1) * s.random(1) + _x(s, 2) * 3
                                    + _x(s, 1) * s.random(2) + s.random(3)),
    "int_times_ring_coeff": lambda s: (_x(s, 1) * s.random(4)) * 3 + 2 * _x(s, 1) - s.random(5),
    "term_plus_term": lambda s: 3 * _x(s, 2) + (-(_x(s, 1) * 2)) - _x(s, 2) * s.random(6),
}


@pytest.mark.parametrize("case", list(LC_CASES))
def test_linear_combination_matches_jax(sides, case):
    js, ts = sides
    jlc, tlc = LC_CASES[case](js), LC_CASES[case](ts)
    assert _same_terms(_terms(tlc), _terms(jlc))
    if case == "merge":
        assert _terms(tlc) == [(0, 5), (1, 4), (2, 1)]
    assert tlc.is_valid(4) == jlc.is_valid(4) and tlc.is_valid(2) == jlc.is_valid(2)
    vals = [np.random.default_rng(9).integers(0, 1000, (2, 8)).astype(np.uint32) for _ in range(3)]
    got = tlc.evaluate([ts.elem(v) for v in vals], RingElem.one(ts.ctx))
    want = jlc.evaluate([js.elem(v) for v in vals], JRingElem.one(js.ctx))
    assert np.array_equal(np.broadcast_to(_res(got), (2, 8)), np.broadcast_to(_res(want), (2, 8)))


def test_linear_combination_equality(sides):
    _, ts = sides
    r = ts.random(1)
    a = _x(ts, 1) * r + _x(ts, 2) * 3
    assert a == _x(ts, 2) * 3 + _x(ts, 1) * ts.elem(_res(r))
    assert not a == _x(ts, 1) * (r + 1) + _x(ts, 2) * 3
    assert tvar.LinearCombination(_x(ts, 4)) == _x(ts, 4)
    assert repr(_x(ts, 0)) == "1" and repr(tvar.LinearCombination()) == "0"
    assert hash(_x(ts, 3)) == hash(tvar.Variable(3)) and _x(ts, 3) != _x(ts, 2)


def test_ring_elem_frontend_methods_match_jax(sides):
    js, ts = sides
    rng = np.random.default_rng(11)
    slots = rng.integers(0, 1 << 20, (2, 8)).astype(np.uint32)
    je, te = js.elem(slots), ts.elem(slots)
    assert np.array_equal(_res(te), _res(je))
    assert te.is_poly and not te.is_scalar and RingElem.scalar(ts.ctx, 3).is_scalar
    ints = [-1, 0, 5, ts.ctx.primes[0] + 2, 1 << 40, -(1 << 33), 7]
    assert np.array_equal(_res(RingElem.from_int_coeffs(ts.ctx, ints)),
                          _res(JRingElem.from_int_coeffs(js.ctx, ints)))
    zero_slot = slots.copy()
    zero_slot[1, 3] = 0
    for arr in (slots + 1, zero_slot):
        assert ts.elem(arr).is_invertible() == js.elem(arr).is_invertible()
    assert hash(te) == hash(ts.elem(slots)) and hash(te) != hash(ts.elem(slots + 1))
    assert len({te, ts.elem(slots), RingElem.scalar(ts.ctx, 1), RingElem.one(ts.ctx)}) == 2
    with pytest.raises(AssertionError):
        RingElem.from_slots(ts.ctx, np.zeros((2, 4), np.uint32))


def test_stack_mixed_list_matches_jax_bucketed_stack(sides):
    """4096 scalars and one dense element: the port's one torch.stack equals
    the JAX package's bucketed stack (256-operand groups and a gather)."""
    js, ts = sides
    vals = np.random.default_rng(12).integers(0, 1 << 30, 4096)
    dense = np.random.default_rng(13).integers(0, 1 << 20, (2, 8)).astype(np.uint32)
    jl = [JRingElem.scalar(js.ctx, int(v)) for v in vals]
    tl = [RingElem.scalar(ts.ctx, int(v)) for v in vals]
    jl.insert(1000, js.elem(dense))
    tl.insert(1000, ts.elem(dense))
    got, want = RingElem.stack(tl), JRingElem.stack(jl)
    assert tuple(got.res.shape) == (4097, 2, 8)
    assert np.array_equal(_res(got), _res(want))


# ---------------------------------------------------------------------------
# constraint systems
# ---------------------------------------------------------------------------


def _cs_ints(s):
    """Integer coefficients only: negative, 2^31 and past q."""
    cs = s.r1cs.R1CSConstraintSystem(primary_input_size=2, auxiliary_input_size=2)
    x = [None] + [_x(s, i) for i in range(1, 5)]
    cs.add_constraint(s.r1cs.R1CSConstraint(x[1] - x[2], x[3] * (1 << 31) + 1, x[4]), "first")
    cs.add_constraint(s.r1cs.R1CSConstraint(-x[1] + 3, 1, x[2] * (s.ctx.q + 5) - x[4] * 2))
    return cs


def _cs_mixed(s):
    """Dense ring coefficients among integers (nc promoted to N in A and C)."""
    cs = s.r1cs.R1CSConstraintSystem(primary_input_size=1, auxiliary_input_size=2)
    x = [None] + [_x(s, i) for i in range(1, 4)]
    cs.add_constraint(s.r1cs.R1CSConstraint(x[1] * s.random(20) + x[2] * 7 - 1, x[3], x[2]))
    cs.add_constraint(s.r1cs.R1CSConstraint(x[3], x[3] + 2, x[1] * s.random(21) + s.random(22)))
    return cs


def _cs_empty_c(s):
    """No term at all in C: an empty matrix compiles to [0, L, 1]."""
    cs = s.r1cs.R1CSConstraintSystem(primary_input_size=1, auxiliary_input_size=1)
    empty = s.var.LinearCombination()
    cs.add_constraint(s.r1cs.R1CSConstraint(_x(s, 1), _x(s, 2) - _x(s, 2), empty))
    return cs


def _cs_scalar_elems(s):
    """RingElem coefficients that are all scalars keep nc = 1."""
    cs = s.r1cs.R1CSConstraintSystem(primary_input_size=1, auxiliary_input_size=1)
    c = s.Elem.scalar(s.ctx, 12345)
    cs.add_constraint(s.r1cs.R1CSConstraint(_x(s, 1) * c, _x(s, 2), _x(s, 1) * c + 4))
    return cs


CS_CASES = {"ints": _cs_ints, "dense_mixed": _cs_mixed, "empty_c": _cs_empty_c,
            "scalar_elems": _cs_scalar_elems}


def _same_compiled(tcomp, jcomp):
    assert (tcomp.num_constraints, tcomp.num_variables, tcomp.primary_input_size) == (
        jcomp.num_constraints, jcomp.num_variables, jcomp.primary_input_size)
    for k in range(3):
        assert tcomp.rows[k].dtype == torch.int64 and tcomp.cols[k].dtype == torch.int64
        assert np.array_equal(tcomp.rows[k].numpy(), np.asarray(jcomp.rows[k]))
        assert np.array_equal(tcomp.cols[k].numpy(), np.asarray(jcomp.cols[k]))
        assert tuple(tcomp.coeffs[k].shape) == tuple(jcomp.coeffs[k].shape), k
        assert np.array_equal(_u(tcomp.coeffs[k]), np.asarray(jcomp.coeffs[k])), k


@pytest.mark.parametrize("case", list(CS_CASES))
def test_compile_matches_jax(sides, case):
    js, ts = sides
    jcs, tcs = CS_CASES[case](js), CS_CASES[case](ts)
    for (jc, tc) in zip(jcs.constraints, tcs.constraints):
        for which in "abc":
            assert _same_terms(_terms(getattr(tc, which)), _terms(getattr(jc, which)))
    tcomp = tcs.compile(ts.ctx)
    _same_compiled(tcomp, jcs.compile(js.ctx))
    if case == "empty_c":
        assert tuple(tcomp.coeffs[2].shape) == (0, 2, 1)
    if case == "dense_mixed":
        assert [c.shape[-1] for c in tcomp.coeffs] == [8, 1, 8]
    assert tcs.is_valid() and jcs.is_valid()
    assert (tcs.num_inputs(), tcs.num_variables(), tcs.num_constraints()) == (
        jcs.num_inputs(), jcs.num_variables(), jcs.num_constraints())


def test_constraint_system_validity_swap_and_equality(sides):
    _, ts = sides
    cs = _cs_ints(ts)
    assert cs.constraint_annotations == {0: "first"}
    assert cs == _cs_ints(ts) and not cs == _cs_mixed(ts)
    shorter = _cs_ints(ts)
    shorter.constraints.pop()
    assert not cs == shorter and not shorter == cs
    bad = _cs_ints(ts)
    bad.auxiliary_input_size = 1  # x_4 now out of range
    assert not bad.is_valid()
    bad2 = _cs_ints(ts)
    bad2.primary_input_size, bad2.auxiliary_input_size = 5, -1
    assert not bad2.is_valid()
    # tests/test_relations.py::test_swap_ab_if_beneficial
    sw = tr1cs.R1CSConstraintSystem(primary_input_size=3, auxiliary_input_size=0)
    sw.add_constraint(tr1cs.R1CSConstraint(_x(ts, 1), _x(ts, 1) + _x(ts, 2) + _x(ts, 3),
                                           _x(ts, 2)))
    sw.swap_AB_if_beneficial()
    assert len(sw.constraints[0].a.terms) == 3 and len(sw.constraints[0].b.terms) == 1
    sw.swap_AB_if_beneficial()  # A already touches more: stays
    assert len(sw.constraints[0].a.terms) == 3


def _toy(s, wrong=False):
    """tests/test_relations.py::_toy_circuit: x5 = x2*x3; x4 = (x0+x1)*x5."""
    pb = s.gad.Protoboard(s.ctx)
    v = s.gad.PBVariableArray()
    v.allocate(pb, 6, "x")
    pb.set_input_sizes(5)
    pb.add_r1cs_constraint(s.r1cs.R1CSConstraint(v[2], v[3], v[5]))
    pb.add_r1cs_constraint(s.r1cs.R1CSConstraint(v[0] + v[1], v[5], v[4]))
    rng = np.random.default_rng(7)
    vals = [s.Elem.random_element(s.ctx, rng) for _ in range(4)]
    v5 = vals[2] * vals[3]
    v4 = (vals[0] + vals[1]) * v5
    if wrong:
        v4 = v4 + s.Elem.one(s.ctx)
    for i, val in enumerate(vals):
        pb.set_val(v[i], val)
    pb.set_val(v[4], v4)
    pb.set_val(v[5], v5)
    return pb


@pytest.mark.parametrize("wrong", [False, True])
def test_protoboard_satisfaction_host_and_compiled(sides, wrong):
    js, ts = sides
    jpb, tpb = _toy(js, wrong), _toy(ts, wrong)
    assert (tpb.num_inputs(), tpb.num_variables(), tpb.num_constraints()) == (5, 6, 2)
    cs = tpb.get_constraint_system()
    assert cs.is_valid()
    assert cs.is_satisfied(tpb.primary_input(), tpb.auxiliary_input()) is (not wrong)
    assert tpb.is_satisfied() is (not wrong) and jpb.is_satisfied() is (not wrong)
    assert np.array_equal(_res(tpb.full_assignment_batch()), _res(jpb.full_assignment_batch()))
    assert cs.variable_annotations == jpb.get_constraint_system().variable_annotations


def test_compiled_eval_matches_host_and_jax(sides):
    js, ts = sides
    jpb, tpb = _toy(js), _toy(ts)
    got = tpb.compile().eval_matrices(tpb.full_assignment_batch().res)
    want = jpb.compile().eval_matrices(jpb.full_assignment_batch().res)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w))
    full, one = tpb.full_variable_assignment(), RingElem.one(ts.ctx)
    for i, cons in enumerate(tpb.get_constraint_system().constraints):
        for arr, lc in zip(got, (cons.a, cons.b, cons.c)):
            assert RingElem.from_slots(ts.ctx, arr[i]) == lc.evaluate(full, one)


def test_eval_matrices_refuses_short_assignment(sides):
    """JAX clamps an out-of-range gather; the port raises."""
    _, ts = sides
    tpb = _toy(ts)
    z = tpb.full_assignment_batch().res
    with pytest.raises(IndexError):
        tpb.compile().eval_matrices(z[:-1])


def test_protoboard_values_and_lc_cache(sides):
    _, ts = sides
    pb = tgad.Protoboard(ts.ctx)
    x = tgad.PBVariable().allocate(pb, "x")
    y = tgad.PBVariable().allocate(pb, "y")
    assert pb.val(x) == 0 and pb.val(tgad.PBVariable(0)) == 1
    pb.set_val(x, 5)
    pb.set_val(y, ts.random(3))
    lc = tgad.PBLinearCombination()
    lc.assign(pb, x * 2 + y + 1)
    lc.evaluate(pb)
    assert pb.lc_val(lc) == pb.val(y) + 11
    assert pb.lc_val(tgad.PBLinearCombination(x)) == 5
    assert tgad.pb_sum([x, y]) == x + y
    assert tgad.pb_coeff_sum([x, y], [3, 4]) == x * 3 + y * 4
    pb.augment_variable_annotation(x, "input")
    assert pb.get_constraint_system().variable_annotations[x.index] == "x input"
    with pytest.raises(AssertionError):
        pb.set_val(tgad.PBVariable(0), 1)
    pb.clear_values()
    assert pb.val(x) == 0 and pb.val(y) == 0


def _bitdec(s):
    """tests/test_relations.py::test_bit_decomposition_gadget"""
    pb = s.gad.Protoboard(s.ctx)
    x = s.gad.PBVariable().allocate(pb, "x")
    pb.set_input_sizes(1)
    g = s.gad.BitDecompositionGadget(pb, x, log_t=8)
    g.generate_r1cs_constraints()
    slots = np.broadcast_to(np.arange(8, dtype=np.uint32) * 17 % 251, (2, 8)).copy()
    pb.set_val(x, s.elem(slots))
    g.generate_r1cs_witness()
    return pb, g


def _inner_product(s):
    """tests/test_relations.py::test_inner_product_gadget"""
    pb = s.gad.Protoboard(s.ctx)
    xs, ys = s.gad.PBVariableArray(), s.gad.PBVariableArray()
    xs.allocate(pb, 4, "x")
    ys.allocate(pb, 4, "y")
    res = s.gad.PBVariable().allocate(pb, "res")
    pb.set_input_sizes(9)
    g = s.gad.InnerProductGadget(pb, xs, ys, res)
    g.generate_r1cs_constraints()
    rng = np.random.default_rng(8)
    for i in range(4):
        pb.set_val(xs[i], s.Elem.random_element(s.ctx, rng))
        pb.set_val(ys[i], s.Elem.random_element(s.ctx, rng))
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize("build", [_bitdec, _inner_product], ids=["bitdec", "inner_product"])
def test_gadgets_match_jax(sides, build):
    js, ts = sides
    (jpb, _), (tpb, tg) = build(js), build(ts)
    assert tpb.is_satisfied() and jpb.is_satisfied()
    _same_compiled(tpb.compile(), jpb.compile())
    assert np.array_equal(_res(tpb.full_assignment_batch()), _res(jpb.full_assignment_batch()))
    if build is _bitdec:  # flip a bit -> unsatisfied
        bad = tpb.val(tg.bits[0]).numpy().copy()
        bad[:, 0] ^= 1
        tpb.set_val(tg.bits[0], RingElem.from_slots(ts.ctx, bad))
        assert not tpb.is_satisfied()
        with pytest.raises(AssertionError, match="too large"):
            tpb.set_val(tg.x, RingElem.scalar(ts.ctx, 256))
            tg.generate_r1cs_witness()
    else:
        want = RingElem.zero(ts.ctx)
        for vx, vy in zip(tg.xs, tg.ys):
            want = want + tpb.val(vx) * tpb.val(vy)
        assert tpb.val(tg.result) == want


def test_r1cs_json_round_trip_across_packages(sides, tmp_path):
    """A file saved by either package loads in the other and compiles to the
    same arrays (integer and ring coefficients)."""
    js, ts = sides
    jcs, tcs = _cs_mixed(js), _cs_mixed(ts)
    tpath, jpath = str(tmp_path / "torch.json"), str(tmp_path / "jax.json")
    tcs.save(tpath)
    jcs.save(jpath)
    with open(tpath) as f, open(jpath) as g:
        assert f.read() == g.read()
    from_jax = tr1cs.R1CSConstraintSystem.load(jpath, ts.ctx)
    from_torch = jr1cs.R1CSConstraintSystem.load(tpath, js.ctx)
    assert from_jax == tcs and from_torch == jcs
    _same_compiled(from_jax.compile(ts.ctx), jcs.compile(js.ctx))
    _same_compiled(tcs.compile(ts.ctx), from_torch.compile(js.ctx))
    ints = str(tmp_path / "ints.json")
    _cs_ints(ts).save(ints)
    assert tr1cs.R1CSConstraintSystem.load(ints) == _cs_ints(ts)  # no ctx needed
    with pytest.raises(AssertionError, match="need a ctx"):
        tr1cs.R1CSConstraintSystem.load(tpath)
