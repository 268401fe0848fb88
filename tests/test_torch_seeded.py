"""The seeded-CRS ringGroth16 of ringsnark_tpu_torch against the JAX
package, on the CPU, bit for bit (mirrors tests/test_seeded.py):

* ``encode_seeded`` gives the JAX package's c0 for the same key, and
  ``expand()`` its c1, at B=19 rows in slabs of 8 (the last one short);
* the seeded inner product equals the port's inner product on the expanded
  batch and the JAX package's seeded inner product, with the slab cut into
  row sub-chunks or not;
* ``generator_seeded`` from one (rng seed, key) gives the JAX seeded CRS;
* ``prover_seeded`` on a JAX seeded keypair carried across gives the JAX
  proof, and the proofs cross-verify in both packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu.encoding import Encoding as JEncoding
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import keygen as jkeygen
from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark import seeded as jseeded
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch.encoding import EncodingContext, inner_product, keygen
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.snark import groth16 as tg16
from ringsnark_tpu_torch.snark import seeded
from ringsnark_tpu_torch.snark.api import SnarkParams
from ringsnark_tpu_torch.utils import interop, prng

N_INNER = 32
SLAB = 8
B = 19  # not a slab multiple


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


def _params(N):
    """JAX and port params over the same primes (test_seeded.py's _params)."""
    jring = jdefault_context(L=2, N=N, order=1 << 10)
    inner, below = [], 1 << 31
    while len(inner) < 4:
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


def _slots(ring, rows, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.integers(0, p, ring.N, dtype=np.uint64) for p in ring.primes])
                     for _ in range(rows)]).astype(np.uint32)  # [rows, L, N]


def _jax_seeded_keypair_arrays(kp) -> dict:
    """The interop dict of a JAX seeded keypair (the JAX side's np.asarray)."""
    pk, vk = kp.pk, kp.vk
    comp = pk.compiled

    def enc(e):
        if e is None:
            return None
        if isinstance(e, jseeded.SeededEncoding):
            return {"c0": np.asarray(e.c0), "key": np.asarray(e.key), "slab": e.slab,
                    "batch": e.batch}
        return np.asarray(e.c0), np.asarray(e.c1)

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


@pytest.fixture(scope="module", params=[1, 8], ids=["N1", "N8"])
def encoded(request):
    """One message batch seeded-encoded by both packages with key 7."""
    jp, tp = _params(request.param)
    _, jsk = jkeygen(jp.enc, np.random.default_rng(3))
    _, tsk = keygen(tp.enc, np.random.default_rng(3))
    msgs = _slots(jp.ring, B, seed=4)
    jse = jseeded.encode_seeded(jp.enc, jsk, JRingElem(jp.ring, jnp.asarray(msgs)),
                                jax.random.PRNGKey(7), slab=SLAB)
    tse = seeded.encode_seeded(tp.enc, tsk, RingElem(tp.ring, _t(msgs)), prng.key(7), slab=SLAB)
    return dict(jp=jp, tp=tp, jse=jse, tse=tse, coefs=_slots(jp.ring, B, seed=5))


def test_encode_seeded_same_c0_and_c1(encoded):
    jse, tse = encoded["jse"], encoded["tse"]
    assert jse.c0.shape[0] == 24 and tse.c0.shape[0] == B and tse.nslab == 3
    assert np.array_equal(_u(tse.c0), np.asarray(jse.c0)[:B])
    texp, jexp = tse.expand(), jse.expand()
    assert np.array_equal(_u(texp.c1), np.asarray(jexp.c1))
    assert np.array_equal(_u(texp.c0), np.asarray(jexp.c0))


@pytest.mark.parametrize("sub_elems", [None, 3 * 2 * 4 * N_INNER], ids=["whole-slabs", "3-rows"])
def test_seeded_ip_equals_expanded_and_jax(encoded, sub_elems, monkeypatch):
    """The slab MAC, whole slabs or 3-row sub-chunks (threefry's row ranges),
    against the port's inner product on expand() and the JAX seeded one."""
    if sub_elems is not None:
        monkeypatch.setattr(seeded, "_SUB_ELEMS", sub_elems)
        assert seeded._sub_rows(encoded["tp"].enc) == 3
    tse, jse, coefs = encoded["tse"], encoded["jse"], encoded["coefs"]
    got = seeded.seeded_inner_product(tse, [_t(coefs), _t(coefs[:11])])
    want = inner_product(tse.expand(), RingElem(encoded["tp"].ring, _t(coefs)))
    jgot = jseeded.seeded_inner_product(jse, [jnp.asarray(coefs), jnp.asarray(coefs[:11])])
    for g, j in zip(got, jgot):
        assert g.level == j.level
        assert np.array_equal(_u(g.c0), np.asarray(j.c0))
        assert np.array_equal(_u(g.c1), np.asarray(j.c1))
    assert got[0] == want


@pytest.fixture(scope="module", params=[1, 8], ids=["Zq", "Rq"])
def proved(request):
    """A JAX seeded keypair and proof on the squaring chain; the port's
    proof from the carried keypair."""
    jp, tp = _params(request.param)
    cs, jprim, jaux = jsquare_chain(jp.ring, 8, np.random.default_rng(0))
    jkp = jseeded.generator_seeded(cs, jp, np.random.default_rng(1), jax.random.PRNGKey(2),
                                   slab=SLAB)
    jproof = jseeded.prover_seeded(jkp.pk, jprim, jaux)
    jarr = _jax_seeded_keypair_arrays(jkp)
    tkp = interop.keypair_from_numpy(tp, jarr)
    tprim, taux = RingElem(tp.ring, _t(jprim.res)), RingElem(tp.ring, _t(jaux.res))
    tproof = seeded.prover_seeded(tkp.pk, tprim, taux)
    return dict(jp=jp, tp=tp, cs=cs, jkp=jkp, jarr=jarr, tkp=tkp, jprim=jprim, jproof=jproof,
                tprim=tprim, taux=taux, tproof=tproof)


def test_carried_seeded_keypair_gives_identical_proof(proved):
    assert isinstance(proved["tkp"].pk, seeded.SeededProvingKey)
    want = [(np.asarray(e.c0), np.asarray(e.c1), e.level)
            for e in (proved["jproof"].A, proved["jproof"].B, proved["jproof"].C)]
    for (wc0, wc1, wl), (gc0, gc1, gl) in zip(want, interop.proof_to_numpy(proved["tproof"])):
        assert wl == gl
        assert np.array_equal(gc0, wc0) and np.array_equal(gc1, wc1)


def test_seeded_proofs_cross_verify(proved):
    tp, jp = proved["tp"], proved["jp"]
    vk, prim, tproof = proved["tkp"].vk, proved["tprim"], proved["tproof"]
    assert tg16.verifier(vk, prim, tproof)
    assert not tg16.verifier(vk, prim + 1, tproof)
    jproof_t = interop.proof_from_numpy(tp, [
        (np.asarray(e.c0), np.asarray(e.c1), e.level)
        for e in (proved["jproof"].A, proved["jproof"].B, proved["jproof"].C)])
    assert tg16.verifier(vk, prim, jproof_t)
    A, Bp, C = (JEncoding(jp.enc, jnp.asarray(c0), jnp.asarray(c1), lvl)
                for c0, c1, lvl in interop.proof_to_numpy(tproof))
    jproof = jg16.Proof(A=A, B=Bp, C=C)
    assert jg16.verifier(proved["jkp"].vk, proved["jprim"], jproof)
    bad = JRingElem(jp.ring, proved["jprim"].res) + 1
    assert not jg16.verifier(proved["jkp"].vk, bad, jproof)


def test_generator_seeded_gives_jax_keypair(proved):
    """One (rng seed, key) gives the JAX seeded CRS (c0, keys, slabs) and
    secrets; the port's own keypair proves and verifies, and survives a
    trip through numpy."""
    tp, jarr = proved["tp"], proved["jarr"]
    tcomp = interop.compiled_from_numpy(tp.ring, jarr["compiled"])
    tkp = seeded.generator_seeded(tcomp, tp, np.random.default_rng(1), prng.key(2), slab=SLAB)
    got = interop.keypair_to_numpy(tkp)
    for k, want in jarr["crs"].items():
        g = got["crs"][k]
        if isinstance(want, dict):
            assert g["slab"] == want["slab"] and g["batch"] == want["batch"], k
            assert np.array_equal(g["key"], np.asarray(want["key"])), k
            assert np.array_equal(g["c0"], want["c0"][: want["batch"]]), k
        else:
            assert np.array_equal(g[0], want[0]) and np.array_equal(g[1], want[1]), k
    for k in ("s", "alpha", "beta", "gamma", "delta"):
        assert np.array_equal(got["vk"][k], jarr["vk"][k]), k
    assert np.array_equal(got["sk"]["s_ntt"], jarr["sk"]["s_ntt"])
    proof = seeded.prover_seeded(tkp.pk, proved["tprim"], proved["taux"])
    assert tg16.verifier(tkp.vk, proved["tprim"], proof)
    assert all(a == b for a, b in zip((proof.A, proof.B, proof.C),
                                      (proved["tproof"].A, proved["tproof"].B, proved["tproof"].C)))
    again = interop.keypair_from_numpy(tp, got)
    proof2 = seeded.prover_seeded(again.pk, proved["tprim"], proved["taux"])
    assert all(a == b for a, b in zip((proof.A, proof.B, proof.C), (proof2.A, proof2.B, proof2.C)))
