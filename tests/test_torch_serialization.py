"""Serialization of ringsnark_tpu_torch (``utils/serialization.py``) on the
CPU, alone and across packages:

* the nine tests of ``tests/test_serialization.py`` on the port;
* every file kind (context, proof of both systems, secret key, ringGroth16
  pk, Rinocchio pk, seeded pk and the streamed provers' stub, vk of the
  ``groth16``, ``groth16_seeded`` and ``rinocchio`` systems) written by the
  JAX package and loaded by the port, and written by the port and loaded by
  the JAX package: equal arrays, a proof from the loaded key equal bit for
  bit to the writer's, and a verifier that accepts;
* the traps: a seeded c0 padded to whole slabs at level 0 (either form is
  read), unreduced words in a JAX-written file, an array-path ringGroth16 pk
  refused with a ValueError.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import torch

from ringsnark_tpu import models as jmodels
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import rinocchio as jrin
from ringsnark_tpu.snark import seeded as jseeded
from ringsnark_tpu.snark import streamed as jstreamed
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu.utils import serialization as jser
from ringsnark_tpu_torch import models as tmodels
from ringsnark_tpu_torch.encoding import EncodingContext
from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.snark import groth16 as tg16
from ringsnark_tpu_torch.snark import rinocchio as trin
from ringsnark_tpu_torch.snark import seeded as tseeded
from ringsnark_tpu_torch.snark import streamed as tstreamed
from ringsnark_tpu_torch.snark.api import SnarkParams
from ringsnark_tpu_torch.utils import prng
from ringsnark_tpu_torch.utils import serialization as ser

G16_PK = ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")
RIN_PK = ("s_pows", "alpha_s_pows", "beta_prods", "beta_rv_ts", "beta_rw_ts", "beta_ry_ts",
          "alpha_rv_ts", "alpha_rw_ts", "alpha_ry_ts", "rv_vs", "rw_ws", "ry_ys")
RIN_PROOF = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _enc_eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (a.level == b.level and np.array_equal(_u(a.c0), _u(b.c0))
            and np.array_equal(_u(a.c1), _u(b.c1)))


def _all_eq(x, y, names) -> bool:
    return all(_enc_eq(getattr(x, n), getattr(y, n)) for n in names)


def _meta(path) -> dict:
    with np.load(path) as data:
        return json.loads(str(data["__meta__"]))


def _proof_names(proof):
    return RIN_PROOF if hasattr(proof, "A_prime") else ("A", "B", "C")


def _params(L, N, n_inner, count=3, order=1 << 12):
    """JAX and port params over the same primes."""
    jring = jdefault_context(L=L, N=N, order=order)
    inner, below = [], 1 << 31
    while len(inner) < count:
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


@pytest.fixture(scope="module")
def env():
    """The toy circuit of test_serialization.py in both packages, with a
    ringGroth16 and a Rinocchio keypair each, from the same seeds (so equal)."""
    jp, tp = _params(L=2, N=8, n_inner=16)
    rj, rt = np.random.default_rng(41), np.random.default_rng(41)
    jpb, tpb = jmodels.build_toy_circuit(jp.ring, rj), tmodels.build_toy_circuit(tp.ring, rt)
    jg = jg16.generator(jpb.get_constraint_system(), jp, rj, jax.random.PRNGKey(400))
    tg = tg16.generator(tpb.get_constraint_system(), tp, rt, prng.key(400))
    rj, rt = np.random.default_rng(42), np.random.default_rng(42)
    jr = jrin.generator(jpb.get_constraint_system(), jp, rj, jax.random.PRNGKey(401))
    tr = trin.generator(tpb.get_constraint_system(), tp, rt, prng.key(401))
    assert _all_eq(jg.pk, tg.pk, G16_PK) and _all_eq(jr.pk, tr.pk, RIN_PK)
    return SimpleNamespace(jp=jp, tp=tp, jpb=jpb, tpb=tpb, jg=jg, tg=tg, jr=jr, tr=tr)


def _io(pb):
    return pb.primary_input(), pb.auxiliary_input()


def _prove(system, kp_pk, pb, seed):
    return system.prover(kp_pk, *_io(pb), np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# the nine tests of tests/test_serialization.py, on the port
# ---------------------------------------------------------------------------


def test_context_roundtrip(env):
    s = ser.context_to_json(env.tp.enc)
    assert ser.context_from_json(s, device="cpu") == env.tp.enc


def test_proof_roundtrip(env, tmp_path):
    proof = tg16.prover(env.tg.pk, *_io(env.tpb))
    path = str(tmp_path / "proof.npz")
    ser.save_proof(path, proof, env.tp.enc)
    loaded = ser.load_proof(path, tg16.Proof, device="cpu")
    assert loaded.A == proof.A and loaded.B == proof.B and loaded.C == proof.C
    assert tg16.verifier(env.tg.vk, env.tpb.primary_input(), loaded)


def test_rinocchio_proof_roundtrip(env, tmp_path):
    proof = _prove(trin, env.tr.pk, env.tpb, 42)
    path = str(tmp_path / "rproof.npz")
    ser.save_proof(path, proof, env.tp.enc)
    loaded = ser.load_proof(path, trin.Proof, device="cpu")
    assert _all_eq(loaded, proof, RIN_PROOF)
    assert trin.verifier(env.tr.vk, env.tpb.primary_input(), loaded)


def test_pk_roundtrip_and_reprove(env, tmp_path):
    pk_path, cs_path = str(tmp_path / "pk.npz"), str(tmp_path / "cs.json")
    ser.save_groth16_pk(pk_path, env.tg.pk, cs_path)
    pk2 = ser.load_groth16_pk(pk_path, device="cpu")
    assert _all_eq(pk2, env.tg.pk, G16_PK)
    proof = tg16.prover(pk2, *_io(env.tpb))
    assert _all_eq(proof, tg16.prover(env.tg.pk, *_io(env.tpb)), ("A", "B", "C"))
    assert tg16.verifier(env.tg.vk, env.tpb.primary_input(), proof)


def test_secret_key_roundtrip(env, tmp_path):
    path = str(tmp_path / "sk.npz")
    ser.save_secret_key(path, env.tg.vk.sk_enc)
    sk2 = ser.load_secret_key(path, device="cpu")
    assert torch.equal(sk2.s_ntt, env.tg.vk.sk_enc.s_ntt)
    assert np.array_equal(sk2.s_coeffs, env.tg.vk.sk_enc.s_coeffs) and sk2.ctx == env.tp.enc


def test_rinocchio_pk_roundtrip_and_reprove(env, tmp_path):
    pk_path, cs_path = str(tmp_path / "rpk.npz"), str(tmp_path / "rcs.json")
    ser.save_rinocchio_pk(pk_path, env.tr.pk, cs_path)
    pk2 = ser.load_rinocchio_pk(pk_path, device="cpu")
    assert _all_eq(pk2, env.tr.pk, RIN_PK)
    proof = _prove(trin, pk2, env.tpb, 44)
    assert _all_eq(proof, _prove(trin, env.tr.pk, env.tpb, 44), RIN_PROOF)
    assert trin.verifier(env.tr.vk, env.tpb.primary_input(), proof)


@pytest.mark.parametrize("system", ["groth16", "rinocchio"])
def test_vk_roundtrip_and_verify(env, tmp_path, system):
    kp, mod = (env.tg, tg16) if system == "groth16" else (env.tr, trin)
    vk_path, pk_path = str(tmp_path / "vk.npz"), str(tmp_path / "pk.npz")
    ser.save_vk(vk_path, kp.vk, pk_path, str(tmp_path / "cs.json"))
    assert _meta(vk_path)["pk_path"] == pk_path
    vk2 = ser.load_vk(vk_path, device="cpu")
    assert vk2.s == kp.vk.s and vk2.alpha == kp.vk.alpha
    proof = _prove(mod, kp.pk, env.tpb, 45)
    primary = env.tpb.primary_input()
    assert mod.verifier(vk2, primary, proof)
    assert not mod.verifier(vk2, [primary[0] + 1] + primary[1:], proof)


@pytest.fixture(scope="module")
def seeded_env():
    """A seeded keypair at Z_q (L=2, N=1), M=32: s_pows has 33 rows in slabs
    of 16, so the JAX package pads its c0 to 48 rows."""
    jp, tp = _params(L=2, N=1, n_inner=128)
    jcomp, jprim, jaux = jsquare_chain(jp.ring, 32, np.random.default_rng(31))
    tcomp, tprim, taux = build_synthetic_square_chain(tp.ring, 32, np.random.default_rng(31))
    jkp = jseeded.generator_seeded(jcomp, jp, np.random.default_rng(32),
                                   jax.random.key(4, impl="threefry2x32"), slab=16)
    tkp = tseeded.generator_seeded(tcomp, tp, np.random.default_rng(32), prng.key(4), slab=16)
    jproof = jseeded.prover_seeded(jkp.pk, jprim, jaux)
    tproof = tseeded.prover_seeded(tkp.pk, tprim, taux)
    assert _all_eq(jproof, tproof, ("A", "B", "C"))
    return SimpleNamespace(jp=jp, tp=tp, jkp=jkp, tkp=tkp, jproof=jproof, tproof=tproof,
                           jprim=jprim, jaux=jaux, tprim=tprim, taux=taux)


def test_seeded_pk_roundtrip(seeded_env, tmp_path):
    """The c0 + PRNG-key SeededProvingKey round-trips and the reloaded key
    gives a bit-identical proof (same witness map, MAC and c1 regeneration)."""
    e = seeded_env
    p = str(tmp_path / "seeded_pk.npz")
    ser.save_seeded_pk(p, e.tkp.pk)
    pk2 = ser.load_seeded_pk(p, device="cpu")
    assert _all_eq(tseeded.prover_seeded(pk2, e.tprim, e.taux), e.tproof, ("A", "B", "C"))


@pytest.fixture(scope="module")
def streamed_env():
    """A streamed ringGroth16 proof and its vk (a CRS-less stub pk) at Z_q,
    L=1, M=32, in both packages from the same seeds (so equal)."""
    jp, tp = _params(L=1, N=1, n_inner=128)
    jcomp, jprim, jaux = jsquare_chain(jp.ring, 32, np.random.default_rng(32))
    tcomp, tprim, taux = build_synthetic_square_chain(tp.ring, 32, np.random.default_rng(32))
    jproof, jvk, _ = jstreamed.stream_prove(jcomp, jp, jprim, jaux, np.random.default_rng(1),
                                            jax.random.key(5, impl="threefry2x32"), slab=16,
                                            phase_rows=32)
    tproof, tvk, _ = tstreamed.stream_prove(tcomp, tp, tprim, taux, np.random.default_rng(1),
                                            prng.key(5), slab=16, phase_rows=32)
    assert _all_eq(jproof, tproof, ("A", "B", "C"))
    return SimpleNamespace(jp=jp, tp=tp, jproof=jproof, tproof=tproof, jvk=jvk, tvk=tvk,
                           jprim=jprim, tprim=tprim)


def test_streamed_vk_roundtrip(streamed_env, tmp_path):
    """save_vk / load_vk cover the streamed provers' CRS-less stub pk; the
    reloaded designated-verifier key verifies the original proof."""
    e = streamed_env
    vp = str(tmp_path / "vk.npz")
    ser.save_vk(vp, e.tvk, str(tmp_path / "pk.npz"), str(tmp_path / "cs.json"))
    vk2 = ser.load_vk(vp, device="cpu")
    assert vk2.pk.s_pows is None and _enc_eq(vk2.pk.gamma_io, e.tvk.pk.gamma_io)
    assert tg16.verifier(vk2, e.tprim, e.tproof)
    assert not tg16.verifier(vk2, e.tprim + 1, e.tproof)


# ---------------------------------------------------------------------------
# across packages, both directions
# ---------------------------------------------------------------------------


def test_context_crosses_both_ways(env):
    assert ser.context_from_json(jser.context_to_json(env.jp.enc), device="cpu") == env.tp.enc
    assert jser.context_from_json(ser.context_to_json(env.tp.enc)) == env.jp.enc


@pytest.mark.parametrize("system", ["groth16", "rinocchio"])
def test_proof_crosses_both_ways(env, tmp_path, system):
    jmod, tmod, jkp, tkp = ((jg16, tg16, env.jg, env.tg) if system == "groth16"
                            else (jrin, trin, env.jr, env.tr))
    jproof, tproof = _prove(jmod, jkp.pk, env.jpb, 46), _prove(tmod, tkp.pk, env.tpb, 46)
    names = _proof_names(tproof)
    assert _all_eq(jproof, tproof, names)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_proof(jpath, jproof, env.jp.enc)
    from_jax = ser.load_proof(jpath, tmod.Proof, device="cpu")
    assert _all_eq(from_jax, jproof, names)
    assert tmod.verifier(tkp.vk, env.tpb.primary_input(), from_jax)
    ser.save_proof(tpath, tproof, env.tp.enc)
    from_port = jser.load_proof(tpath, jmod.Proof)
    assert _all_eq(from_port, tproof, names)
    assert jmod.verifier(jkp.vk, env.jpb.primary_input(), from_port)


def test_secret_key_crosses_both_ways(env, tmp_path):
    jsk, tsk = env.jg.vk.sk_enc, env.tg.vk.sk_enc
    jser.save_secret_key(str(tmp_path / "j.npz"), jsk)
    got = ser.load_secret_key(str(tmp_path / "j.npz"), device="cpu")
    assert np.array_equal(_u(got.s_ntt), _u(jsk.s_ntt))
    assert np.array_equal(got.s_coeffs, np.asarray(jsk.s_coeffs)) and got.ctx == env.tp.enc
    ser.save_secret_key(str(tmp_path / "t.npz"), tsk)
    got = jser.load_secret_key(str(tmp_path / "t.npz"))
    assert np.array_equal(_u(got.s_ntt), _u(tsk.s_ntt)) and got.ctx == env.jp.enc
    assert np.array_equal(np.asarray(got.s_coeffs), tsk.s_coeffs)


@pytest.mark.parametrize("system", ["groth16", "rinocchio"])
def test_resident_pk_crosses_both_ways(env, tmp_path, system):
    """A pk written by either package loads in the other with equal
    encodings; the loaded key proves bit for bit what the writer's key
    proves, and the writer's vk accepts it."""
    if system == "groth16":
        jmod, tmod, jkp, tkp, names = jg16, tg16, env.jg, env.tg, G16_PK
        jsave, jload, tsave, tload = (jser.save_groth16_pk, jser.load_groth16_pk,
                                      ser.save_groth16_pk, ser.load_groth16_pk)
    else:
        jmod, tmod, jkp, tkp, names = jrin, trin, env.jr, env.tr, RIN_PK
        jsave, jload, tsave, tload = (jser.save_rinocchio_pk, jser.load_rinocchio_pk,
                                      ser.save_rinocchio_pk, ser.load_rinocchio_pk)
    jsave(str(tmp_path / "j.npz"), jkp.pk, str(tmp_path / "j.json"))
    tpk = tload(str(tmp_path / "j.npz"), device="cpu")
    assert _all_eq(tpk, jkp.pk, names) and tpk.compiled.ctx.device == "cpu"
    tproof = _prove(tmod, tpk, env.tpb, 47)
    assert _all_eq(tproof, _prove(jmod, jkp.pk, env.jpb, 47), _proof_names(tproof))
    assert tmod.verifier(tkp.vk, env.tpb.primary_input(), tproof)
    tsave(str(tmp_path / "t.npz"), tkp.pk, str(tmp_path / "t.json"))
    jpk = jload(str(tmp_path / "t.npz"))
    assert _all_eq(jpk, tkp.pk, names)
    jproof = _prove(jmod, jpk, env.jpb, 47)
    assert _all_eq(jproof, tproof, _proof_names(tproof))
    assert jmod.verifier(jkp.vk, env.jpb.primary_input(), jproof)


def test_seeded_pk_crosses_both_ways(seeded_env, tmp_path):
    e = seeded_env
    jser.save_seeded_pk(str(tmp_path / "j.npz"), e.jkp.pk)
    tpk = ser.load_seeded_pk(str(tmp_path / "j.npz"), device="cpu")
    for name in ("s_pows", "delta_mid", "delta_ts"):
        js, ts = getattr(e.jkp.pk, name), getattr(tpk, name)
        assert np.array_equal(_u(ts.c0), _u(js.c0)[: js.batch]) and ts.batch == js.batch
        assert ts.slab == js.slab and ts.key == tuple(int(v) for v in jax.random.key_data(js.key))
    assert _all_eq(tseeded.prover_seeded(tpk, e.tprim, e.taux), e.jproof, ("A", "B", "C"))
    ser.save_seeded_pk(str(tmp_path / "t.npz"), e.tkp.pk)
    jpk = jser.load_seeded_pk(str(tmp_path / "t.npz"))
    assert _all_eq(jseeded.prover_seeded(jpk, e.jprim, e.jaux), e.tproof, ("A", "B", "C"))
    assert jg16.verifier(e.jkp.vk, e.jprim, e.jproof)


@pytest.mark.parametrize("system", ["groth16", "rinocchio", "groth16_seeded"])
def test_vk_crosses_both_ways(env, seeded_env, tmp_path, system):
    """A vk (and the pk it names) written by either package loads in the
    other; the loaded vk accepts the other package's proof, carried as a
    file too, and rejects a changed public input."""
    if system == "groth16_seeded":
        e = seeded_env
        jvk, tvk, jmod, tmod = e.jkp.vk, e.tkp.vk, jg16, tg16
        jproof, tproof, jprim, tprim = e.jproof, e.tproof, e.jprim, e.tprim
        jbad, tbad = jprim + 1, tprim + 1
    else:
        jmod, tmod, jkp, tkp = ((jg16, tg16, env.jg, env.tg) if system == "groth16"
                                else (jrin, trin, env.jr, env.tr))
        jvk, tvk = jkp.vk, tkp.vk
        jproof, tproof = _prove(jmod, jkp.pk, env.jpb, 48), _prove(tmod, tkp.pk, env.tpb, 48)
        jprim, tprim = env.jpb.primary_input(), env.tpb.primary_input()
        jbad, tbad = [jprim[0] + 1] + jprim[1:], [tprim[0] + 1] + tprim[1:]
    d = tmp_path
    jser.save_vk(str(d / "jvk.npz"), jvk, str(d / "jpk.npz"), str(d / "jcs.json"))
    jser.save_proof(str(d / "jproof.npz"), jproof, jvk.pk.params.enc)
    vk = ser.load_vk(str(d / "jvk.npz"), device="cpu")
    proof = ser.load_proof(str(d / "jproof.npz"), tmod.Proof, device="cpu")
    assert _meta(str(d / "jvk.npz"))["system"] == system
    assert tmod.verifier(vk, tprim, proof) and not tmod.verifier(vk, tbad, proof)
    ser.save_vk(str(d / "tvk.npz"), tvk, str(d / "tpk.npz"), str(d / "tcs.json"))
    ser.save_proof(str(d / "tproof.npz"), tproof, tvk.pk.params.enc)
    vk = jser.load_vk(str(d / "tvk.npz"))
    proof = jser.load_proof(str(d / "tproof.npz"), jmod.Proof)
    assert _meta(str(d / "tvk.npz"))["system"] == system
    assert jmod.verifier(vk, jprim, proof) and not jmod.verifier(vk, jbad, proof)


def test_streamed_vk_crosses_both_ways(streamed_env, tmp_path):
    e, d = streamed_env, tmp_path
    jser.save_vk(str(d / "jvk.npz"), e.jvk, str(d / "jpk.npz"), str(d / "jcs.json"))
    vk = ser.load_vk(str(d / "jvk.npz"), device="cpu")
    assert vk.pk.s_pows is None and _enc_eq(vk.pk.gamma_io, e.jvk.pk.gamma_io)
    assert tg16.verifier(vk, e.tprim, e.tproof) and not tg16.verifier(vk, e.tprim + 1, e.tproof)
    ser.save_vk(str(d / "tvk.npz"), e.tvk, str(d / "tpk.npz"), str(d / "tcs.json"))
    vk = jser.load_vk(str(d / "tvk.npz"))
    assert vk.pk.s_pows is None and _enc_eq(vk.pk.gamma_io, e.tvk.pk.gamma_io)
    assert jg16.verifier(vk, e.jprim, e.jproof)


# ---------------------------------------------------------------------------
# traps
# ---------------------------------------------------------------------------


def _rewrite(path, **arrays):
    """The npz at `path` with some arrays (or the JSON header) replaced."""
    with np.load(path) as data:
        store = {k: data[k] for k in data.files}
    store.update(arrays)
    np.savez(path, **store)


def test_seeded_file_pads_c0_to_whole_slabs_and_reads_either_form(seeded_env, tmp_path):
    """The port writes a seeded batch as the JAX package keeps it (c0 padded
    with zero rows to whole slabs, level 0, impl threefry2x32), reads an
    unpadded c0 too, and refuses a key of another PRNG impl."""
    e = seeded_env
    p = str(tmp_path / "pk.npz")
    ser.save_seeded_pk(p, e.tkp.pk)
    se = e.tkp.pk.s_pows
    assert se.batch == 33 and se.slab == 16
    with np.load(p) as data:
        meta = json.loads(str(data["__meta__"]))
        c0 = data["s_pows_c0"]
        assert c0.shape[0] == 48 and not c0[33:].any()
        assert np.array_equal(c0[:33], _u(se.c0))
        unpadded = c0[:33]
    assert meta["s_pows"] == {"slab": 16, "batch": 33, "level": 0}
    assert meta["s_pows_impl"] == "threefry2x32" and meta["seeded"] == ["s_pows", "delta_mid", "delta_ts"]
    _rewrite(p, s_pows_c0=unpadded)
    pk2 = ser.load_seeded_pk(p, device="cpu")
    assert _all_eq(tseeded.prover_seeded(pk2, e.tprim, e.taux), e.tproof, ("A", "B", "C"))
    meta["s_pows_impl"] = "rbg"
    _rewrite(p, __meta__=json.dumps(meta))
    with pytest.raises(ValueError, match="threefry2x32"):
        ser.load_seeded_pk(p, device="cpu")


def test_unreduced_words_in_a_jax_file_are_reduced(env, tmp_path):
    """Words in [p, 2^32) (a residue plus its prime) in a file written by
    the JAX package load as the canonical residue: encodings, ring elements
    and the secret key; the verifier accepts the reloaded proof."""
    jproof = _prove(jg16, env.jg.pk, env.jpb, 49)
    d = tmp_path
    jser.save_vk(str(d / "vk.npz"), env.jg.vk, str(d / "pk.npz"), str(d / "cs.json"))
    jser.save_proof(str(d / "proof.npz"), jproof, env.jp.enc)
    Q = np.array(env.jp.enc.inner_primes, np.uint64)
    p = np.array(env.jp.ring.primes, np.uint64)

    def plus(a, primes, level=0):  # a + its prime, < 2^32 since a < p < 2^31
        k = len(primes) - level
        return (a.astype(np.uint64) + primes[:k, None]).astype(np.uint32)

    with np.load(str(d / "proof.npz")) as data:
        lv = json.loads(str(data["__meta__"]))["A"]["level"]
        a0 = plus(data["A_c0"], Q, lv)
    with np.load(str(d / "vk.npz")) as data:
        s_words, sk_words = plus(data["s"], p), plus(data["sk_s_ntt"], Q)
    assert (a0.astype(np.uint64) >= Q[: a0.shape[-2], None]).all() and (a0 >= 1 << 31).any()
    _rewrite(str(d / "proof.npz"), A_c0=a0)
    _rewrite(str(d / "vk.npz"), s=s_words, sk_s_ntt=sk_words)
    proof = ser.load_proof(str(d / "proof.npz"), tg16.Proof, device="cpu")
    vk = ser.load_vk(str(d / "vk.npz"), device="cpu")
    assert _enc_eq(proof.A, jproof.A) and vk.s == env.tg.vk.s
    assert torch.equal(vk.sk_enc.s_ntt, env.tg.vk.sk_enc.s_ntt)
    assert tg16.verifier(vk, env.tpb.primary_input(), proof)


def test_array_path_groth16_pk_is_refused(tmp_path):
    """A resident ringGroth16 key made from a CompiledR1CS has no constraint
    system: save_groth16_pk (and save_vk through it) raise a ValueError that
    names save_seeded_pk, and write nothing."""
    _, tp = _params(L=1, N=1, n_inner=128)
    comp, prim, aux = build_synthetic_square_chain(tp.ring, 8, np.random.default_rng(3))
    kp = tg16.generator(comp, tp, np.random.default_rng(4), prng.key(5))
    assert kp.pk.constraint_system is None
    for call in (lambda: ser.save_groth16_pk(str(tmp_path / "pk.npz"), kp.pk,
                                             str(tmp_path / "cs.json")),
                 lambda: ser.save_vk(str(tmp_path / "vk.npz"), kp.vk, str(tmp_path / "pk.npz"),
                                     str(tmp_path / "cs.json"))):
        with pytest.raises(ValueError, match="save_seeded_pk"):
            call()
    assert not list(tmp_path.iterdir())


def test_interop_reduces_unreduced_words(env):
    """Words in [p, 2^32) carried in through utils/interop (a keypair dict,
    a proof's triples) become the canonical residues, as on load from a
    file: the port's int32 residues must be canonical."""
    from ringsnark_tpu_torch.utils import interop

    Q = np.array(env.tp.enc.inner_primes, np.uint64)[:, None]
    p = np.array(env.tp.ring.primes, np.uint64)[:, None]

    def plus(a, primes):  # a residue plus its prime, < 2^32
        return (a.astype(np.uint64) + primes[: a.shape[-2]]).astype(np.uint32)

    arr = interop.keypair_to_numpy(env.tg)
    arr["vk"]["s"] = plus(arr["vk"]["s"], p)
    arr["crs"]["s_pows"] = (plus(arr["crs"]["s_pows"][0], Q), arr["crs"]["s_pows"][1])
    arr["sk"]["s_ntt"] = plus(arr["sk"]["s_ntt"], Q)
    assert (arr["crs"]["s_pows"][0] >= 1 << 31).any()
    kp = interop.keypair_from_numpy(env.tp, arr)
    assert kp.vk.s == env.tg.vk.s and kp.pk.s_pows == env.tg.pk.s_pows
    assert torch.equal(kp.vk.sk_enc.s_ntt, env.tg.vk.sk_enc.s_ntt)
    proof = tg16.prover(env.tg.pk, *_io(env.tpb))
    triples = [(plus(c0, Q), c1, lv) for c0, c1, lv in interop.proof_to_numpy(proof)]
    assert _all_eq(interop.proof_from_numpy(env.tp, triples), proof, ("A", "B", "C"))
