"""The ringGroth16 slice of ringsnark_tpu_torch against the JAX package, on
the CPU: a JAX keypair carried across gives a bit-identical proof; proofs
cross-verify in both directions; the port's generator draws the same
secrets from the same numpy seed and its CRS decodes to the JAX ring
values, and from the same threefry key the JAX CRS bit for bit; the port
runs generator -> prover -> verifier on its own."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu.encoding import Encoding as JEncoding
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import decode as jdecode
from ringsnark_tpu.models import build_toy_circuit
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch.encoding import EncodingContext, decode
from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.snark import groth16 as tg16
from ringsnark_tpu_torch.snark.api import SnarkParams
from ringsnark_tpu_torch.utils import interop, prng

N_INNER = 32


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


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


def _jax_keypair_arrays(kp) -> dict:
    """The interop dict of a JAX keypair (the JAX side's np.asarray)."""
    pk, vk = kp.pk, kp.vk
    comp = pk.compiled

    def enc(e):
        return None if e is None else (np.asarray(e.c0), np.asarray(e.c1))

    return {
        "compiled": {
            "rows": tuple(np.asarray(r) for r in comp.rows),
            "cols": tuple(np.asarray(c) for c in comp.cols),
            "coeffs": tuple(np.asarray(c) for c in comp.coeffs),
            "num_constraints": comp.num_constraints,
            "num_variables": comp.num_variables,
            "primary_input_size": comp.primary_input_size,
        },
        "domain_size": pk.domain.m,
        "crs": {k: enc(getattr(pk, k)) for k in
                ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")},
        "vk": {k: np.asarray(getattr(vk, k).res) for k in ("s", "alpha", "beta", "gamma", "delta")},
        "sk": {"s_ntt": np.asarray(vk.sk_enc.s_ntt), "s_coeffs": np.asarray(vk.sk_enc.s_coeffs)},
    }


def _jax_proof(jp, triples):
    A, B, C = (JEncoding(jp.enc, jnp.asarray(c0), jnp.asarray(c1), lvl) for c0, c1, lvl in triples)
    return jg16.Proof(A=A, B=B, C=C)


@pytest.fixture(scope="module", params=["toy-Zq", "toy-Rq", "chain-Rq"])
def proved(request):
    """A JAX keypair and proof, and the port's proof from the carried keypair."""
    kind, ring = request.param.split("-")
    jp, tp = _params(1 if ring == "Zq" else 16)
    if kind == "toy":
        pb = build_toy_circuit(jp.ring, np.random.default_rng(21))
        cs, jprim, jaux = pb.get_constraint_system(), pb.primary_input(), pb.auxiliary_input()
        prim, aux = (np.stack([np.asarray(v.res) for v in vs]) for vs in (jprim, jaux))
    else:
        cs, jprim, jaux = jsquare_chain(jp.ring, 16, np.random.default_rng(22))
        prim, aux = np.asarray(jprim.res), np.asarray(jaux.res)
    jkp = jg16.generator(cs, jp, np.random.default_rng(4), jax.random.PRNGKey(103))
    jproof = jg16.prover(jkp.pk, jprim, jaux)
    tkp = interop.keypair_from_numpy(tp, _jax_keypair_arrays(jkp))
    tprim, taux = RingElem(tp.ring, _t(prim)), RingElem(tp.ring, _t(aux))
    tproof = tg16.prover(tkp.pk, tprim, taux)
    return dict(jp=jp, tp=tp, cs=cs, jkp=jkp, tkp=tkp, jprim=jprim, jproof=jproof,
                tprim=tprim, taux=taux, tproof=tproof)


def test_carried_keypair_gives_identical_proof(proved):
    want = [(np.asarray(e.c0), np.asarray(e.c1), e.level)
            for e in (proved["jproof"].A, proved["jproof"].B, proved["jproof"].C)]
    got = interop.proof_to_numpy(proved["tproof"])
    for (wc0, wc1, wl), (gc0, gc1, gl) in zip(want, got):
        assert wl == gl
        assert np.array_equal(gc0, wc0) and np.array_equal(gc1, wc1)


def test_port_verifier_accepts_jax_proof_rejects_changed_input(proved):
    jproof_t = interop.proof_from_numpy(proved["tp"], [
        (np.asarray(e.c0), np.asarray(e.c1), e.level)
        for e in (proved["jproof"].A, proved["jproof"].B, proved["jproof"].C)
    ])
    vk, prim = proved["tkp"].vk, proved["tprim"]
    assert tg16.verifier(vk, prim, jproof_t)
    assert tg16.verifier(vk, prim, proved["tproof"])
    assert not tg16.verifier(vk, prim + 1, proved["tproof"])


def test_jax_verifier_accepts_port_proof(proved):
    jp, jkp = proved["jp"], proved["jkp"]
    proof = _jax_proof(jp, interop.proof_to_numpy(proved["tproof"]))
    jprim = proved["jprim"]
    assert jg16.verifier(jkp.vk, jprim, proof)
    bad = (JRingElem(jp.ring, jprim.res) + 1) if isinstance(jprim, JRingElem) \
        else [jprim[0] + 1] + list(jprim[1:])
    assert not jg16.verifier(jkp.vk, bad, proof)


def test_port_generator_same_secrets_and_crs_values(proved):
    """The port's generator, from the JAX generator's numpy seed and another
    key: the same s, alpha, beta, gamma, delta and secret key, and a CRS
    (encrypted with other noise) that decodes to the JAX CRS's ring values."""
    tp, jp, jkp = proved["tp"], proved["jp"], proved["jkp"]
    tcomp = interop.compiled_from_numpy(tp.ring, _jax_keypair_arrays(jkp)["compiled"])
    tkp = tg16.generator(tcomp, tp, np.random.default_rng(4), prng.key(0))
    for k in ("s", "alpha", "beta", "gamma", "delta"):
        assert np.array_equal(getattr(tkp.vk, k).numpy(), np.asarray(getattr(jkp.vk, k).res)), k
    assert np.array_equal(tkp.vk.sk_enc.s_coeffs, np.asarray(jkp.vk.sk_enc.s_coeffs))
    assert np.array_equal(_u(tkp.vk.sk_enc.s_ntt), np.asarray(jkp.vk.sk_enc.s_ntt))
    for k in ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts"):
        te, je = getattr(tkp.pk, k), getattr(jkp.pk, k)
        assert not torch.equal(te.c1, _t(je.c1)), f"{k}: same noise is not expected"
        got = decode(tp.enc, tkp.vk.sk_enc, te).numpy()
        want = np.asarray(jdecode(jp.enc, jkp.vk.sk_enc, je).res)
        assert np.array_equal(got, want), k


def test_port_generator_gives_jax_crs_bit_for_bit(proved):
    """One (rng seed, key) gives the JAX package's resident CRS, c0 and c1,
    bit for bit: the key carried across with `interop.key_from_numpy`."""
    tp, jkp = proved["tp"], proved["jkp"]
    jarr = _jax_keypair_arrays(jkp)
    tcomp = interop.compiled_from_numpy(tp.ring, jarr["compiled"])
    key = interop.key_from_numpy(np.asarray(jax.random.PRNGKey(103)))
    tkp = tg16.generator(tcomp, tp, np.random.default_rng(4), key)
    got = interop.keypair_to_numpy(tkp)["crs"]
    for k, want in jarr["crs"].items():
        if want is None:
            assert got[k] is None, k
            continue
        assert np.array_equal(got[k][0], want[0]) and np.array_equal(got[k][1], want[1]), k


def test_port_end_to_end_and_cross_verify():
    """The port alone on the squaring chain (Rq), then its proof under the
    port verifier from a keypair moved through numpy."""
    _, tp = _params(16)
    comp, prim, aux = build_synthetic_square_chain(tp.ring, 32, np.random.default_rng(5))
    kp = tg16.generator(comp, tp, np.random.default_rng(6), prng.key(7))
    proof = tg16.prover(kp.pk, prim, aux)
    assert tg16.verifier(kp.vk, prim, proof)
    assert not tg16.verifier(kp.vk, prim + 1, proof)
    kp2 = interop.keypair_from_numpy(tp, interop.keypair_to_numpy(kp))
    proof2 = tg16.prover(kp2.pk, prim, aux)
    assert all(a == b for a, b in zip((proof.A, proof.B, proof.C), (proof2.A, proof2.B, proof2.C)))
    assert tg16.verifier(kp2.vk, prim, proof)
