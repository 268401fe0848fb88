"""The resident Rinocchio generator and prover of ringsnark_tpu_torch, the
ringGroth16 generator over a constraint system, and the tensor cores of
``snark/pipeline.py``, against the JAX package on the CPU.  From one
``(rng seed, key)`` the port's generator gives the JAX CRS bit for bit; a
carried JAX keypair and the same prover `rng` give the JAX proof bit for bit,
with ZK on (auxiliary wires, F present) and off (none, F is None); proofs
cross-verify both ways; a changed public input and a tampered element are
rejected.  All comparisons are exact (==).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu import models as jmodels
from ringsnark_tpu.encoding import Encoding as JEncoding
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import rinocchio as jrin
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch import models as tmodels
from ringsnark_tpu_torch.encoding import Encoding, EncodingContext, encode, keygen
from ringsnark_tpu_torch.encoding.encoding import inner_product
from ringsnark_tpu_torch.reductions.r1cs_to_qrp import (
    _assignment_batches,
    _pa_batches,
    r1cs_to_qrp_instance_map_with_evaluation,
)
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.snark import groth16 as tg16
from ringsnark_tpu_torch.snark import pipeline, seeded
from ringsnark_tpu_torch.snark import rinocchio as trin
from ringsnark_tpu_torch.snark.api import SnarkParams
from ringsnark_tpu_torch.utils import interop, prng

N_INNER = 32
RIN_CRS = ("s_pows", "alpha_s_pows", "beta_prods", "beta_rv_ts", "beta_rw_ts", "beta_ry_ts",
           "alpha_rv_ts", "alpha_rw_ts", "alpha_ry_ts", "rv_vs", "rw_ws", "ry_ys")
RIN_VK = ("s", "alpha", "beta", "r_v", "r_w", "r_y")
RIN_PROOF = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")

# name -> (N, build(models module, ctx, rng), has auxiliary wires)
CIRCUITS = {
    "plaintext_check": (16, lambda m, c, r: m.build_plaintext_check(c, r, log_t=8), True),
    "ct_mul": (16, lambda m, c, r: m.build_ct_mul(c, r, log_t=8), False),  # M = 4
    "incircuit_ntt": (16, lambda m, c, r: m.build_incircuit_ntt(c, r), False),  # M = 1
    "toy_Zq": (1, lambda m, c, r: m.build_toy_circuit(c, r, replicate=2), True),
}


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _params(N):
    jring = jdefault_context(L=2, N=N, order=1 << 12)
    inner, below = [], 1 << 31
    while len(inner) < 3:
        c = find_ntt_primes(1, 2 * N_INNER, below=below)[0]
        below = c
        if c not in jring.primes:
            inner.append(c)
    jp = JSnarkParams(ring=jring, enc=JEncodingContext(ring=jring, n_inner=N_INNER,
                                                       inner_primes=tuple(inner)))
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    tp = SnarkParams(ring=tring, enc=EncodingContext(ring=tring, n_inner=N_INNER,
                                                     inner_primes=tuple(inner)))
    return jp, tp


def _jax_compiled(comp) -> dict:
    return {
        "rows": tuple(np.asarray(r) for r in comp.rows),
        "cols": tuple(np.asarray(c) for c in comp.cols),
        "coeffs": tuple(np.asarray(c) for c in comp.coeffs),
        "num_constraints": comp.num_constraints,
        "num_variables": comp.num_variables,
        "primary_input_size": comp.primary_input_size,
    }


def _jax_rinocchio_arrays(kp) -> dict:
    """The interop dict of a JAX Rinocchio keypair (the JAX side's np.asarray)."""
    pk, vk = kp.pk, kp.vk
    return {
        "compiled": _jax_compiled(pk.compiled),
        "domain_size": pk.domain.m,
        "crs": {k: None if getattr(pk, k) is None else
                (np.asarray(getattr(pk, k).c0), np.asarray(getattr(pk, k).c1)) for k in RIN_CRS},
        "vk": {k: np.asarray(getattr(vk, k).res) for k in RIN_VK},
        "sk": {"s_ntt": np.asarray(vk.sk_enc.s_ntt), "s_coeffs": np.asarray(vk.sk_enc.s_coeffs)},
    }


def _jax_proof_triples(proof, names):
    return tuple(None if e is None else (np.asarray(e.c0), np.asarray(e.c1), e.level)
                 for e in (getattr(proof, n) for n in names))


def _jax_proof(jp, triples, cls, names):
    return cls(**{n: None if t is None else
                  JEncoding(jp.enc, jnp.asarray(t[0]), jnp.asarray(t[1]), t[2])
                  for n, t in zip(names, triples)})


def _same_proofs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g[2] == w[2]
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.fixture(scope="module", params=list(CIRCUITS))
def proved(request):
    """The circuit in both packages, a JAX Rinocchio keypair and proof, the
    port's keypair from the same (rng seed, key), and the port's proof from
    the carried JAX keypair with the same prover rng."""
    N, build, has_aux = CIRCUITS[request.param]
    jp, tp = _params(N)
    jpb = build(jmodels, jp.ring, np.random.default_rng(51))
    tpb = build(tmodels, tp.ring, np.random.default_rng(51))
    jkey = jax.random.PRNGKey(205)
    jkp = jrin.generator(jpb.get_constraint_system(), jp, np.random.default_rng(52), jkey)
    jproof = jrin.prover(jkp.pk, jpb.primary_input(), jpb.auxiliary_input(),
                         np.random.default_rng(53))
    tkp = trin.generator(tpb.get_constraint_system(), tp, np.random.default_rng(52),
                         interop.key_from_numpy(np.asarray(jkey)))
    carried = interop.rinocchio_keypair_from_numpy(tp, _jax_rinocchio_arrays(jkp))
    tproof = trin.prover(carried.pk, tpb.primary_input(), tpb.auxiliary_input(),
                         np.random.default_rng(53))
    return dict(jp=jp, tp=tp, jpb=jpb, tpb=tpb, jkp=jkp, jproof=jproof, tkp=tkp,
                carried=carried, tproof=tproof, has_aux=has_aux)


def test_generator_gives_jax_crs_bit_for_bit(proved):
    """Secrets in the order s, keygen, alpha, r_v, r_w, beta; encodings from
    keys 0-6 of split(key, 8); shifts[0..5] one encoding of six rows."""
    jarr = _jax_rinocchio_arrays(proved["jkp"])
    got = interop.rinocchio_keypair_to_numpy(proved["tkp"])
    for k in RIN_VK:
        assert np.array_equal(got["vk"][k], jarr["vk"][k]), k
    assert np.array_equal(got["sk"]["s_coeffs"], jarr["sk"]["s_coeffs"])
    assert np.array_equal(got["sk"]["s_ntt"], jarr["sk"]["s_ntt"])
    assert got["domain_size"] == jarr["domain_size"]
    for k in RIN_CRS:
        want = jarr["crs"][k]
        assert (got["crs"][k] is None) == (want is None), k
        if want is not None:
            assert got["crs"][k][0].shape == want[0].shape, k
            assert np.array_equal(got["crs"][k][0], want[0]), k
            assert np.array_equal(got["crs"][k][1], want[1]), k
    aux_keys = ("beta_prods", "rv_vs", "rw_ws", "ry_ys")
    assert all((got["crs"][k] is not None) == proved["has_aux"] for k in aux_keys)
    pk = proved["tkp"].pk
    assert pk.constraint_system is proved["tpb"].get_constraint_system()
    assert pk.size_in_bits() == proved["jkp"].pk.size_in_bits()
    assert proved["tkp"].vk.size_in_bits() == pk.size_in_bits()


def test_carried_keypair_gives_jax_proof_bit_for_bit(proved):
    """ZK on exactly with auxiliary wires: the same prover rng gives the same
    d1, d2, d3, folded into A, B, C, and F's three shift terms."""
    tproof, jproof = proved["tproof"], proved["jproof"]
    assert (tproof.F is not None) == proved["has_aux"] == (jproof.F is not None)
    _same_proofs(interop.proof_to_numpy(tproof), _jax_proof_triples(jproof, RIN_PROOF))
    assert tproof.size_in_bits() == jproof.size_in_bits()
    # the port's own keypair is the same CRS, hence the same proof
    tpb = proved["tpb"]
    own = trin.prover(proved["tkp"].pk, tpb.primary_input(), tpb.auxiliary_input(),
                      np.random.default_rng(53))
    _same_proofs(interop.proof_to_numpy(own), interop.proof_to_numpy(tproof))


def test_port_verifier_accepts_jax_proof_rejects_changed_input(proved):
    tp, tpb = proved["tp"], proved["tpb"]
    jproof_t = interop.proof_from_numpy(tp, _jax_proof_triples(proved["jproof"], RIN_PROOF))
    prim = tpb.primary_input()
    for vk in (proved["carried"].vk, proved["tkp"].vk):
        assert trin.verifier(vk, prim, jproof_t)
        assert trin.verifier(vk, prim, proved["tproof"])
    bad = prim[:-1] + [prim[-1] + 1]
    assert not trin.verifier(proved["tkp"].vk, bad, proved["tproof"])
    # a batch of primary inputs is taken like a list
    assert trin.verifier(proved["tkp"].vk, RingElem.stack(prim), proved["tproof"])


def test_jax_verifier_accepts_port_proof(proved):
    jp, jpb = proved["jp"], proved["jpb"]
    proof = _jax_proof(jp, interop.proof_to_numpy(proved["tproof"]), jrin.Proof, RIN_PROOF)
    prim = jpb.primary_input()
    assert jrin.verifier(proved["jkp"].vk, prim, proof)
    assert not jrin.verifier(proved["jkp"].vk, [prim[0] + 1] + prim[1:], proof)


@pytest.mark.parametrize("name", ["A", "B_prime", "D", "F"])
def test_tampered_element_is_rejected(proved, name):
    tproof, vk = proved["tproof"], proved["tkp"].vk
    e = getattr(tproof, name)
    if e is None:
        assert name == "F" and not proved["has_aux"]
        return
    fields = {n: getattr(tproof, n) for n in RIN_PROOF}
    # still a well-formed encoding, of the value plus s (E(s) is CRS row 1)
    fields[name] = e + proved["tkp"].pk.s_pows[1]
    assert not trin.verifier(vk, proved["tpb"].primary_input(), trin.Proof(**fields))


def test_prover_draws_fresh_shifts_without_rng(proved):
    """No rng: ZK proofs differ from call to call (fresh d's), and verify;
    without auxiliary wires the proof is deterministic."""
    tpb, kp = proved["tpb"], proved["tkp"]
    p1 = trin.prover(kp.pk, tpb.primary_input(), tpb.auxiliary_input())
    p2 = trin.prover(kp.pk, tpb.primary_input(), tpb.auxiliary_input())
    assert trin.verifier(kp.vk, tpb.primary_input(), p1)
    assert (p1.A == p2.A) == (not proved["has_aux"])


def test_resident_keypair_survives_numpy(proved):
    tp, tpb = proved["tp"], proved["tpb"]
    kp2 = interop.rinocchio_keypair_from_numpy(
        tp, interop.rinocchio_keypair_to_numpy(proved["tkp"]))
    again = trin.prover(kp2.pk, tpb.primary_input(), tpb.auxiliary_input(),
                        np.random.default_rng(53))
    _same_proofs(interop.proof_to_numpy(again), interop.proof_to_numpy(proved["tproof"]))
    assert trin.verifier(kp2.vk, tpb.primary_input(), again)
    # a streamed vk's dict (no "crs") still loads, with a CRS-less key
    arrays = interop.rinocchio_vk_to_numpy(proved["tkp"].vk)
    assert "crs" not in arrays
    vk = interop.rinocchio_vk_from_numpy(tp, arrays)
    assert vk.pk.s_pows is None and trin.verifier(vk, tpb.primary_input(), again)


@pytest.mark.parametrize("form", ["lists", "batches"])
def test_rinocchio_core_gives_the_provers_arrays(proved, form):
    """The tensor core on the assignment batches, made from lists of
    elements or from stacked batches, gives the object-level prover's arrays
    (F before its shift terms)."""
    tp, tpb, pk = proved["tp"], proved["tpb"], proved["tkp"].pk
    ctx, has_aux = tp.ring, proved["has_aux"]
    rng = np.random.default_rng(53)
    if has_aux:
        d = [RingElem.random_invertible_element(ctx, rng) for _ in range(3)]
    else:
        d = [RingElem.zero(ctx)] * 3
    prim, auxl = tpb.primary_input(), tpb.auxiliary_input()
    if form == "batches":
        prim = RingElem.stack(prim)
        auxl = RingElem.stack(auxl) if has_aux else auxl
    full, _, mid = _assignment_batches(ctx, prim, auxl)
    aux = RingElem.stack(tpb.auxiliary_input()).res if has_aux else None
    crs = {k: None if getattr(pk, k) is None else (getattr(pk, k).c0, getattr(pk, k).c1)
           for k in ("s_pows", "alpha_s_pows", "beta_prods")}
    main, f = pipeline.rinocchio_core(pk.compiled, crs, full.res, mid.res, aux,
                                      *(x.res for x in d), pk.domain, tp.enc, True, has_aux)
    want = interop.proof_to_numpy(proved["tproof"])
    for (c0, c1), w in zip(main, want[:8]):
        assert np.array_equal(_u(c0), w[0]) and np.array_equal(_u(c1), w[1])
    assert (f is None) == (not has_aux)
    if has_aux:
        level = want[8][2]
        F = Encoding(tp.enc, f[0], f[1], level)
        for dk, shift in zip(d, (pk.beta_rv_ts, pk.beta_rw_ts, pk.beta_ry_ts)):
            F = F + dk * shift
        assert np.array_equal(_u(F.c0), want[8][0]) and np.array_equal(_u(F.c1), want[8][1])


@pytest.mark.parametrize("ums", [False, True], ids=["no_modswitch", "modswitch"])
@pytest.mark.parametrize("extra", [1, 7])
def test_zero_coefficients_are_exact_noops(ums, extra):
    """<E, c> with `extra` more encodings that meet zero coefficients is the
    same array: zero-padding a batch (as a sharded path would) changes no
    proof, and neither does leaving the padded rows out."""
    _, tp = _params(16)
    rng = np.random.default_rng(62)
    _, sk = keygen(tp.enc, rng)
    vals = RingElem.stack([RingElem.random_element(tp.ring, rng) for _ in range(5 + extra)])
    e = encode(tp.enc, sk, vals, prng.key(63))
    c = RingElem.stack([RingElem.random_element(tp.ring, rng) for _ in range(5)])
    padded = RingElem(tp.ring, torch.cat([c.res, torch.zeros_like(c.res[:1]).expand(
        extra, *c.res.shape[1:])], dim=0))
    want = inner_product(e[:5], c, use_modswitch=ums)
    got = inner_product(e, padded, use_modswitch=ums)
    assert got.level == want.level
    assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    core = pipeline._ip(tp.enc, (e.c0, e.c1), c.res, ums)
    assert torch.equal(core.c0, want.c0) and torch.equal(core.c1, want.c1)


def test_ring_elem_times_encoding_is_encoding_times_ring_elem():
    """`d * E` reaches Encoding.__rmul__: RingElem.__mul__ declines an Encoding."""
    _, tp = _params(16)
    rng = np.random.default_rng(60)
    _, sk = keygen(tp.enc, rng)
    r, d = RingElem.random_element(tp.ring, rng), RingElem.random_element(tp.ring, rng)
    e = encode(tp.enc, sk, r, prng.key(61))
    assert RingElem.__mul__(d, e) is NotImplemented
    left, right = d * e, e * d
    assert isinstance(left, Encoding) and left == right


# ---------------------------------------------------------------------------
# ringGroth16 over a constraint system
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["logreg", "ct_mul"])
def g16(request):
    """ringGroth16 from a constraint system, in both packages from one
    (rng seed, key); logreg has auxiliary wires, ct-mul has none."""
    jp, tp = _params(16)
    if request.param == "logreg":
        def build(m, c):
            return m.build_logreg_inference(c, np.random.default_rng(54), num_features=2, log_t=8)
    else:
        def build(m, c):
            return m.build_ct_mul(c, np.random.default_rng(54), log_t=8)
    jpb, tpb = build(jmodels, jp.ring), build(tmodels, tp.ring)
    jkey = jax.random.PRNGKey(206)
    tkey = interop.key_from_numpy(np.asarray(jkey))
    jkp = jg16.generator(jpb.get_constraint_system(), jp, np.random.default_rng(55), jkey)
    jproof = jg16.prover(jkp.pk, jpb.primary_input(), jpb.auxiliary_input())
    tkp = tg16.generator(tpb.get_constraint_system(), tp, np.random.default_rng(55), tkey)
    tproof = tg16.prover(tkp.pk, tpb.primary_input(), tpb.auxiliary_input(),
                         np.random.default_rng(0))
    return dict(jp=jp, tp=tp, jpb=jpb, tpb=tpb, jkp=jkp, jproof=jproof, tkp=tkp, tproof=tproof,
                tkey=tkey)


def _g16_crs(kp):
    return interop.keypair_to_numpy(kp)["crs"]


def test_groth16_from_constraint_system_matches_jax(g16):
    want = {k: None if getattr(g16["jkp"].pk, k) is None else
            (np.asarray(getattr(g16["jkp"].pk, k).c0), np.asarray(getattr(g16["jkp"].pk, k).c1))
            for k in ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")}
    got = _g16_crs(g16["tkp"])
    for k, w in want.items():
        assert (got[k] is None) == (w is None), k
        if w is not None:
            assert np.array_equal(got[k][0], w[0]) and np.array_equal(got[k][1], w[1]), k
    _same_proofs(interop.proof_to_numpy(g16["tproof"]),
                 _jax_proof_triples(g16["jproof"], ("A", "B", "C")))
    tpb, jpb = g16["tpb"], g16["jpb"]
    assert tg16.verifier(g16["tkp"].vk, tpb.primary_input(), g16["tproof"])
    bad = [tpb.primary_input()[0] + 1] + tpb.primary_input()[1:]
    assert not tg16.verifier(g16["tkp"].vk, bad, g16["tproof"])
    jproof = _jax_proof(g16["jp"], interop.proof_to_numpy(g16["tproof"]), jg16.Proof,
                        ("A", "B", "C"))
    assert jg16.verifier(g16["jkp"].vk, jpb.primary_input(), jproof)
    assert g16["tkp"].pk.constraint_system is tpb.get_constraint_system()


def test_generator_takes_constraint_system_or_compiled(g16):
    """groth16.generator(cs) == groth16.generator(cs.compile(ctx)), and the
    seeded generator likewise."""
    tp, tpb, tkey = g16["tp"], g16["tpb"], g16["tkey"]
    comp = tpb.get_constraint_system().compile(tp.ring)
    kp2 = tg16.generator(comp, tp, np.random.default_rng(55), tkey)
    assert kp2.pk.constraint_system is None
    a, b = _g16_crs(g16["tkp"]), _g16_crs(kp2)
    for k in a:
        assert (a[k] is None) == (b[k] is None)
        if a[k] is not None:
            assert np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1]), k
    for k in ("s", "alpha", "beta", "gamma", "delta"):
        assert getattr(kp2.vk, k) == getattr(g16["tkp"].vk, k)
    s1 = seeded.generator_seeded(tpb.get_constraint_system(), tp, np.random.default_rng(55),
                                 tkey, slab=8)
    s2 = seeded.generator_seeded(comp, tp, np.random.default_rng(55), tkey, slab=8)
    assert s1.pk.constraint_system is tpb.get_constraint_system()
    assert s2.pk.constraint_system is None
    for k in ("s_pows", "delta_ts"):
        assert torch.equal(getattr(s1.pk, k).c0, getattr(s2.pk, k).c0)
    proof = seeded.prover_seeded(s1.pk, tpb.primary_input(), tpb.auxiliary_input())
    assert tg16.verifier(s1.vk, tpb.primary_input(), proof)


def test_io_terms_at_s_equal_interpolation_route(g16):
    tp, tpb, kp = g16["tp"], g16["tpb"], g16["tkp"]
    qrp = r1cs_to_qrp_instance_map_with_evaluation(kp.pk.compiled, kp.vk.s, kp.pk.domain)
    n_io = kp.pk.compiled.primary_input_size + 1
    for prim in (tpb.primary_input(), RingElem.stack(tpb.primary_input())):
        fast = tg16._io_terms_at_s(qrp, tp.ring, n_io, prim)
        slow = tg16._io_terms_via_interpolation(kp.pk, prim, kp.vk.s)
        for f, s in zip(fast, slow):
            assert f == s and tuple(f.res.shape) == tuple(s.res.shape)
    padded = tg16._padded_primary_with_one(kp.pk, tpb.primary_input())
    assert padded.res.shape[0] == 1 + kp.pk.compiled.num_variables
    assert not padded.res[n_io:].any() and padded[0] == 1


@pytest.mark.parametrize("form", ["lists", "batches"])
def test_groth16_core_gives_the_provers_arrays(g16, form):
    """The tensor core on the primary and auxiliary batches gives the JAX
    package's proof arrays; `groth16.prover` is this core on the key's
    tensors, for lists of elements and for stacked batches alike."""
    tp, tpb, pk = g16["tp"], g16["tpb"], g16["tkp"].pk
    prim, auxl = tpb.primary_input(), tpb.auxiliary_input()
    if form == "batches":
        prim = RingElem.stack(prim)
        auxl = RingElem.stack(auxl) if auxl else auxl
    p_res, a_res = _pa_batches(tp.ring, prim, auxl)
    assert a_res.shape[0] == len(tpb.auxiliary_input())
    crs = {k: None if getattr(pk, k) is None else (getattr(pk, k).c0, getattr(pk, k).c1)
           for k in ("s_pows", "delta_ts", "delta_mid", "alpha", "beta")}
    got = pipeline.groth16_core(pk.compiled, crs, p_res, a_res, pk.domain, tp.enc, True)
    want = _jax_proof_triples(g16["jproof"], ("A", "B", "C"))
    for (c0, c1), w in zip(got, want):
        assert np.array_equal(_u(c0), _u(w[0])) and np.array_equal(_u(c1), _u(w[1]))
    _same_proofs(interop.proof_to_numpy(tg16.prover(pk, prim, auxl)),
                 interop.proof_to_numpy(g16["tproof"]))
    for (c0, c1), w in zip(got, interop.proof_to_numpy(g16["tproof"])):
        assert np.array_equal(_u(c0), w[0]) and np.array_equal(_u(c1), w[1])
    assert pipeline.groth16_proof_levels(tp.enc, True) == (g16["tproof"].A.level,) * 3
