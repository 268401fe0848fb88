"""The streamed provers of ringsnark_tpu_torch against the JAX package, on
the CPU, bit for bit (mirrors tests/test_streamed.py), over
(L, N) ∈ {(2, 1), (2, 8), (1, 8)} at M=32, slab 8, phase_rows 16
(2 chunks of 24 rows; (2, 8) takes the limb-local branch):

* ``stream_prove`` from one (rng seed, key) gives the JAX proof (triples
  and levels), trapdoor, secret key and gamma_io; the proofs cross-verify
  in both packages (the vk carried through ``interop``), and both
  verifiers reject a changed public input;
* its proof decodes to the port's ``prover_seeded`` proof under one rng
  seed; another chunk plan changes only the ciphertexts, the port's row
  sub-chunk nothing at all;
* ``stream_prove_rinocchio`` gives the JAX proof (all 9 elements), with
  ZK on (F present) and off (every wire public: F is None), cross-verifies
  and rejects a changed public input;
* ``amplify.prove_repeated`` with K=2 gives the JAX proofs and verifies.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu.encoding import Encoding as JEncoding
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.snark import amplify as jamplify
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import rinocchio as jrin
from ringsnark_tpu.snark import streamed as jst
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch.encoding import EncodingContext, decode
from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.snark import amplify, rinocchio, seeded, streamed
from ringsnark_tpu_torch.snark import groth16 as tg16
from ringsnark_tpu_torch.snark.api import KeyPair, SnarkParams
from ringsnark_tpu_torch.utils import interop, prng

M = 32
PLAN = dict(slab=8, phase_rows=16)


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _params(L, N):
    """JAX and port params over the same primes (test_streamed.py's _make_params)."""
    jring = jdefault_context(L=L, N=N, order=1 << 12)
    n_inner = 64 if N <= 32 else 2 * N
    inner, below = [], 1 << 31
    while len(inner) < 3:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in jring.primes:
            inner.append(c)
    jp = JSnarkParams(ring=jring, enc=JEncodingContext(ring=jring, n_inner=n_inner,
                                                       inner_primes=tuple(inner)))
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    tp = SnarkParams(ring=tring, enc=EncodingContext(ring=tring, n_inner=n_inner,
                                                     inner_primes=tuple(inner)))
    return jp, tp


def _chain(jp, tp, seed, **kw):
    jc = jsquare_chain(jp.ring, M, np.random.default_rng(seed), **kw)
    tc = build_synthetic_square_chain(tp.ring, M, np.random.default_rng(seed), **kw)
    assert np.array_equal(_u(tc[1].res), np.asarray(jc[1].res))
    return jc, tc


def _triples(proof, names):
    return [None if getattr(proof, n) is None else
            (np.asarray(getattr(proof, n).c0), np.asarray(getattr(proof, n).c1),
             getattr(proof, n).level) for n in names]


def _assert_same_triples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def _jax_vk_arrays(vk) -> dict:
    """The interop dict of a JAX streamed ringGroth16 vk (CRS-less pk)."""
    pk, comp = vk.pk, vk.pk.compiled
    return {
        "compiled": {"rows": tuple(np.asarray(r) for r in comp.rows),
                     "cols": tuple(np.asarray(c) for c in comp.cols),
                     "coeffs": tuple(np.asarray(c) for c in comp.coeffs),
                     "num_constraints": comp.num_constraints,
                     "num_variables": comp.num_variables,
                     "primary_input_size": comp.primary_input_size},
        "domain_size": pk.domain.m,
        "crs": {k: None if getattr(pk, k) is None else
                (np.asarray(getattr(pk, k).c0), np.asarray(getattr(pk, k).c1))
                for k in ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")},
        "vk": {k: np.asarray(getattr(vk, k).res) for k in ("s", "alpha", "beta", "gamma", "delta")},
        "sk": {"s_ntt": np.asarray(vk.sk_enc.s_ntt), "s_coeffs": np.asarray(vk.sk_enc.s_coeffs)},
    }


def _jax_bad(jprim):
    return JRingElem(jprim.ctx, (jprim + JRingElem.one(jprim.ctx)).res)


G16 = ("A", "B", "C")
RIN = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")


@pytest.fixture(scope="module", params=[(2, 1), (2, 8), (1, 8)], ids=["Zq_L2", "Rq_L2", "Rq_L1"])
def env(request):
    """Both packages' streamed ringGroth16 and Rinocchio proofs on the
    squaring chain, each from one (rng seed, key)."""
    jp, tp = _params(*request.param)
    (jcomp, jprim, jaux), (tcomp, tprim, taux) = _chain(jp, tp, 11)
    jproof, jvk, _ = jst.stream_prove(jcomp, jp, jprim, jaux, np.random.default_rng(5),
                                      jax.random.PRNGKey(8), **PLAN)
    tproof, tvk, rec = streamed.stream_prove(tcomp, tp, tprim, taux, np.random.default_rng(5),
                                             prng.key(8), record=streamed.StreamRecord(), **PLAN)
    jrp, jrvk, _ = jst.stream_prove_rinocchio(jcomp, jp, jprim, jaux, np.random.default_rng(9),
                                              jax.random.PRNGKey(13), **PLAN)
    trp, trvk, _ = streamed.stream_prove_rinocchio(tcomp, tp, tprim, taux,
                                                   np.random.default_rng(9), prng.key(13), **PLAN)
    return dict(jp=jp, tp=tp, jcomp=jcomp, jprim=jprim, tcomp=tcomp, tprim=tprim, taux=taux,
                jproof=jproof, jvk=jvk, tproof=tproof, tvk=tvk, rec=rec, jrp=jrp, jrvk=jrvk,
                trp=trp, trvk=trvk)


def test_stream_prove_equals_jax(env):
    tproof, jproof, tvk, jvk = env["tproof"], env["jproof"], env["tvk"], env["jvk"]
    _assert_same_triples(interop.proof_to_numpy(tproof), _triples(jproof, G16))
    for k in ("s", "alpha", "beta", "gamma", "delta"):
        assert np.array_equal(getattr(tvk, k).numpy(), np.asarray(getattr(jvk, k).res)), k
    assert np.array_equal(_u(tvk.sk_enc.s_ntt), np.asarray(jvk.sk_enc.s_ntt))
    assert np.array_equal(_u(tvk.pk.gamma_io.c0), np.asarray(jvk.pk.gamma_io.c0))
    assert np.array_equal(_u(tvk.pk.gamma_io.c1), np.asarray(jvk.pk.gamma_io.c1))
    assert isinstance(tvk.pk, seeded.SeededProvingKey) and tvk.pk.s_pows is None
    assert tproof.size_in_bits() == jproof.size_in_bits()
    assert tvk.pk.size_in_bits() == jvk.pk.gamma_io.size_in_bits()
    tp = env["tp"]
    for e in (tproof.A, tproof.B, tproof.C):
        assert tuple(e.c0.shape) == (tp.ring.L, tp.enc.floor_limbs, tp.enc.n_inner)
    rec = env["rec"]
    assert {k for k, _, _ in rec.events} == {"setup", "prove", "stream"}
    assert rec.total("stream") > 0


def test_stream_proofs_cross_verify(env):
    tp, jp = env["tp"], env["jp"]
    tprim, jprim, tproof = env["tprim"], env["jprim"], env["tproof"]
    assert tg16.verifier(env["tvk"], tprim, tproof)
    assert not tg16.verifier(env["tvk"], tprim + 1, tproof)
    # the JAX vk carried across verifies the JAX proof and the port's
    carried = interop.keypair_from_numpy(tp, _jax_vk_arrays(env["jvk"]))
    assert isinstance(carried.pk, seeded.SeededProvingKey) and carried.pk.s_pows is None
    jproof_t = interop.proof_from_numpy(tp, _triples(env["jproof"], G16))
    assert tg16.verifier(carried.vk, tprim, jproof_t)
    assert tg16.verifier(carried.vk, tprim, tproof)
    # the port's vk survives a trip through numpy
    again = interop.keypair_from_numpy(tp, interop.keypair_to_numpy(KeyPair(pk=env["tvk"].pk,
                                                                             vk=env["tvk"])))
    assert tg16.verifier(again.vk, tprim, tproof)
    # the JAX verifier accepts the port's proof
    A, B, C = (JEncoding(jp.enc, jnp.asarray(c0), jnp.asarray(c1), lvl)
               for c0, c1, lvl in interop.proof_to_numpy(tproof))
    jproof = jg16.Proof(A=A, B=B, C=C)
    assert jg16.verifier(env["jvk"], jprim, jproof)
    assert not jg16.verifier(env["jvk"], _jax_bad(jprim), jproof)


def test_stream_prove_decodes_equal_to_seeded(env):
    """Same rng seed => the seeded generator's trapdoor and secret key; the
    proof plaintexts are equal (the ciphertexts are not)."""
    tp, ectx = env["tp"], env["tp"].enc
    kp = seeded.generator_seeded(env["tcomp"], tp, np.random.default_rng(5), prng.key(9),
                                 slab=8)
    proof_r = seeded.prover_seeded(kp.pk, env["tprim"], env["taux"])
    assert env["tvk"].s == kp.vk.s and env["tvk"].delta == kp.vk.delta
    for name in G16:
        a, b = getattr(env["tproof"], name), getattr(proof_r, name)
        assert a.level == b.level, name
        assert decode(ectx, env["tvk"].sk_enc, a) == decode(ectx, kp.vk.sk_enc, b), name


def test_stream_prove_plan_and_subchunk_invariance(env, monkeypatch):
    """Another (slab, phase_rows) plan decodes to the same proof; another row
    sub-chunk (3 rows) gives the same ciphertexts."""
    tp, ectx = env["tp"], env["tp"].enc
    args = (env["tcomp"], tp, env["tprim"], env["taux"])
    other, vk, _ = streamed.stream_prove(*args, np.random.default_rng(5), prng.key(8),
                                         slab=16, phase_rows=64)
    for name in G16:
        a, b = getattr(other, name), getattr(env["tproof"], name)
        assert not torch.equal(a.c1, b.c1)
        assert decode(ectx, vk.sk_enc, a) == decode(ectx, env["tvk"].sk_enc, b), name
    monkeypatch.setattr(seeded, "_SUB_ELEMS", 3 * ectx.L_inner * ectx.n_inner)
    assert seeded._sub_rows(streamed.limb_enc_context(ectx, 0)) == 3
    sub, _, _ = streamed.stream_prove(*args, np.random.default_rng(5), prng.key(8), **PLAN)
    assert all(getattr(sub, n) == getattr(env["tproof"], n) for n in G16)


def test_stream_record_profile_sections(env):
    """StreamRecord(profile=True) times each chunk's encryption ("setup") and
    MAC ("prove") in place of one "stream" section per phase, and changes
    nothing in the proof."""
    rec = streamed.StreamRecord(profile=True)
    proof, _, _ = streamed.stream_prove(env["tcomp"], env["tp"], env["tprim"], env["taux"],
                                        np.random.default_rng(5), prng.key(8), record=rec,
                                        **PLAN)
    assert all(getattr(proof, n) == getattr(env["tproof"], n) for n in G16)
    assert rec.total("stream") == 0
    chunks = [(k, n) for k, n, _ in rec.events if "+" in n]
    names = {n.split(":")[1].split("+")[0] for _, n in chunks}
    assert names == {"s_pows", "delta_ts", "delta_mid"}
    assert {k for k, _ in chunks} == {"setup", "prove"}


def test_plan_chunks_equals_jax():
    for B, pr, slab in ((65537, 65536, 4096), (262145, 65536, 4096), (31, 16, 8),
                        (1, 1 << 16, 4096), (33, 16, 8), (33, 64, 16), (200001, 50000, 512)):
        n, c = streamed.plan_chunks(B, pr, slab)
        assert (n, c) == jst.plan_chunks(B, pr, slab)
        assert c % slab == 0 and n * c >= B


def test_stream_rinocchio_equals_jax(env):
    trp, jrp, trvk, jrvk = env["trp"], env["jrp"], env["trvk"], env["jrvk"]
    assert trp.F is not None  # auxiliary inputs: ZK on
    _assert_same_triples(interop.proof_to_numpy(trp), _triples(jrp, RIN))
    for k in ("s", "alpha", "beta", "r_v", "r_w", "r_y"):
        assert np.array_equal(getattr(trvk, k).numpy(), np.asarray(getattr(jrvk, k).res)), k
    assert trp.size_in_bits() == jrp.size_in_bits()
    _rinocchio_cross_verify(env["tp"], env["jp"], env["tprim"], env["jprim"], trp, jrp, trvk,
                            jrvk)


def _rinocchio_cross_verify(tp, jp, tprim, jprim, trp, jrp, trvk, jrvk):
    assert rinocchio.verifier(trvk, tprim, trp)
    assert not rinocchio.verifier(trvk, tprim + 1, trp)
    carried = interop.rinocchio_vk_from_numpy(tp, interop.rinocchio_vk_to_numpy(trvk))
    assert rinocchio.verifier(carried, tprim, interop.proof_from_numpy(tp, _triples(jrp, RIN)))
    encs = [None if t is None else JEncoding(jp.enc, jnp.asarray(t[0]), jnp.asarray(t[1]), t[2])
            for t in interop.proof_to_numpy(trp)]
    jproof = jrin.Proof(**dict(zip(RIN, encs)))
    assert jrin.verifier(jrvk, jprim, jproof)
    assert not jrin.verifier(jrvk, _jax_bad(jprim), jproof)


def test_stream_rinocchio_without_zk_equals_jax():
    """Every wire public (num_public = M + 1, so no auxiliary input): ZK
    turns itself off and F is None."""
    jp, tp = _params(2, 8)
    (jcomp, jprim, jaux), (tcomp, tprim, taux) = _chain(jp, tp, 12, num_public=M + 1)
    assert taux.res.shape[0] == 0
    jrp, jrvk, _ = jst.stream_prove_rinocchio(jcomp, jp, jprim, jaux, np.random.default_rng(3),
                                              jax.random.PRNGKey(4), **PLAN)
    trp, trvk, _ = streamed.stream_prove_rinocchio(tcomp, tp, tprim, taux,
                                                   np.random.default_rng(3), prng.key(4), **PLAN)
    assert trp.F is None and jrp.F is None
    _assert_same_triples(interop.proof_to_numpy(trp), _triples(jrp, RIN))
    _rinocchio_cross_verify(tp, jp, tprim, jprim, trp, jrp, trvk, jrvk)


def test_prove_repeated_equals_jax():
    jp, tp = _params(1, 1)
    (jcomp, jprim, jaux), (tcomp, tprim, taux) = _chain(jp, tp, 21)
    plan = dict(slab=32, phase_rows=64)
    jrp = jamplify.prove_repeated(jcomp, jp, jprim, jaux, np.random.default_rng(3),
                                  jax.random.key(3, impl="threefry2x32"), reps=2, **plan)
    trp = amplify.prove_repeated(tcomp, tp, tprim, taux, np.random.default_rng(3), prng.key(3),
                                 reps=2, **plan)
    assert trp.reps == 2
    for tproof, jproof in zip(trp.proofs, jrp.proofs):
        _assert_same_triples(interop.proof_to_numpy(tproof), _triples(jproof, G16))
    assert not trp.proofs[0].A == trp.proofs[1].A  # independent repetitions
    assert trp.size_in_bits() == jrp.size_in_bits()
    assert amplify.verify_repeated(trp, tprim)
    assert not amplify.verify_repeated(trp, tprim + 1)
    assert amplify.soundness_err_log2(1 << 18, 31, reps=3) == jamplify.soundness_err_log2(
        1 << 18, 31, reps=3) == 3 * (19 - 30)
