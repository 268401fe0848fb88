"""Carrying keys and proofs across between this package and the JAX package.

Everything crosses as numpy arrays (residues as uint32), so this module
never imports jax: the JAX side does its own ``np.asarray``.  Residues that
come in are masked to 32 bits and reduced mod their primes before they
become int32 (``residues``): the JAX package may hold unreduced words.

* ``keypair_from_numpy(params, arrays)`` builds a port ``KeyPair`` from the
  arrays of a ringGroth16 keypair, resident or seeded, or from those of a
  streamed proof's vk (``KeyPair(pk=vk.pk, vk=vk)``, whose pk is a CRS-less
  ``SeededProvingKey`` holding only ``gamma_io``); ``keypair_to_numpy``
  gives the same dict for a port keypair, e.g. to move it to another
  device;
* ``rinocchio_vk_to_numpy`` / ``rinocchio_vk_from_numpy`` carry a streamed
  Rinocchio vk: ``compiled``, ``domain_size``, ``vk`` with ``{"s",
  "alpha", "beta", "r_v", "r_w", "r_y"}`` and ``sk`` (its pk is a CRS-less
  stub);
* ``rinocchio_keypair_to_numpy`` / ``rinocchio_keypair_from_numpy`` carry a
  resident Rinocchio keypair: the vk dict above plus ``crs``, the twelve
  encodings of its ``ProvingKey`` as ``(c0, c1)`` at level 0 (None for one
  that a circuit without auxiliary wires lacks; the six shift encodings
  without a batch axis);
* ``proof_to_numpy`` / ``proof_from_numpy`` turn a ringGroth16 ``Proof``
  (3 elements) or a Rinocchio one (9, ``F`` may be None) into
  ``(c0, c1, level)`` triples (None for a missing element) and back;
* ``key_from_numpy`` / ``key_to_numpy`` carry a threefry key as its key
  data, uint32[2] (``jax.random.key_data`` of a typed key, or a raw
  ``PRNGKey`` array).

The keypair dict holds:

``compiled``  ``{"rows", "cols", "coeffs"}`` (3-tuples of arrays, coeffs
              ``[nnz, L, nc]``), ``"num_constraints"``, ``"num_variables"``,
              ``"primary_input_size"``;
``domain_size`` the evaluation domain's size M;
``crs``       ``{"alpha", "beta", "s_pows", "gamma_io", "delta_mid",
              "delta_ts"}`` -> ``(c0, c1)`` at level 0 (``delta_mid`` may be
              None); ``alpha``/``beta`` without a batch axis.  In a seeded
              keypair ``s_pows``, ``delta_mid`` and ``delta_ts`` are dicts
              ``{"c0", "key", "slab", "batch"}``: c0 with at least `batch`
              rows (the JAX package pads to whole slabs; the rows past
              `batch` are dropped), the key data uint32[2], the slab size
              and the batch length;
``vk``        ``{"s", "alpha", "beta", "gamma", "delta"}`` -> ``[L, n]``;
``sk``        ``{"s_ntt": [L, L', N'], "s_coeffs": int8 [L, N']}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding.context import SecretKey
from ..encoding.encoding import Encoding
from ..relations.r1cs import CompiledR1CS
from ..rings.context import canonical_residues
from ..rings.elem import RingElem
from ..snark import rinocchio
from ..snark.api import KeyPair, SnarkParams
from ..snark.groth16 import Proof, ProvingKey, VerificationKey
from ..snark.seeded import SeededEncoding, SeededProvingKey
from . import prng
from .domain import RootsDomain

__all__ = [
    "compiled_from_numpy", "keypair_from_numpy", "keypair_to_numpy",
    "rinocchio_vk_from_numpy", "rinocchio_vk_to_numpy",
    "rinocchio_keypair_from_numpy", "rinocchio_keypair_to_numpy",
    "proof_to_numpy", "proof_from_numpy", "key_from_numpy", "key_to_numpy",
]

_CRS = ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")
_VK = ("s", "alpha", "beta", "gamma", "delta")
_RIN_VK = ("s", "alpha", "beta", "r_v", "r_w", "r_y")
_RIN_CRS = ("s_pows", "alpha_s_pows", "beta_prods", "beta_rv_ts", "beta_rw_ts", "beta_ry_ts",
            "alpha_rv_ts", "alpha_rw_ts", "alpha_ry_ts", "rv_vs", "rw_ws", "ry_ys")
_RIN_PROOF = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")


def _host(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def residues(arr, p: torch.Tensor) -> torch.Tensor:
    """A uint32 residue array [..., K, n] from outside, canonical mod the
    primes p (int64 [K, 1] on the target device), as int32 there."""
    # copied only if not uint32, contiguous and writable (an array np.load
    # returns is all three; torch warns on a read-only one)
    a = np.require(np.asarray(arr).astype(np.uint32, copy=False), requirements=("C", "W"))
    return canonical_residues(torch.from_numpy(a.view(np.int32)).to(p.device), p)


def _enc(ectx, c0, c1, level: int = 0) -> Encoding:
    Q = ectx.inner_consts(level)
    return Encoding(ectx, residues(c0, Q), residues(c1, Q), level)


def compiled_from_numpy(ring, c: dict) -> CompiledR1CS:
    """A CompiledR1CS over `ring` from the ``compiled`` dict (see above)."""

    def idx(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(ring.device)

    return CompiledR1CS(
        ctx=ring,
        num_constraints=int(c["num_constraints"]),
        num_variables=int(c["num_variables"]),
        primary_input_size=int(c["primary_input_size"]),
        rows=tuple(idx(a) for a in c["rows"]),
        cols=tuple(idx(a) for a in c["cols"]),
        coeffs=tuple(residues(a, ring.p) for a in c["coeffs"]),
    )


def keypair_from_numpy(params: SnarkParams, arrays: dict) -> KeyPair:
    ring, ectx = params.ring, params.enc
    comp = compiled_from_numpy(ring, arrays["compiled"])
    domain = RootsDomain(ring, int(arrays["domain_size"]))
    assert domain.m == int(arrays["domain_size"])

    def enc(entry):
        if entry is None:
            return None
        if isinstance(entry, dict):
            batch = int(entry["batch"])
            return SeededEncoding(ectx, residues(np.asarray(entry["c0"])[:batch],
                                                 ectx.inner_consts(0)),
                                  key_from_numpy(entry["key"]), int(entry["slab"]), batch)
        return _enc(ectx, *entry)

    crs = {k: enc(arrays["crs"][k]) for k in _CRS}
    # seeded, or the CRS-less key of a streamed proof (no s_pows at all)
    seeded = not isinstance(crs["s_pows"], Encoding)
    pk = (SeededProvingKey if seeded else ProvingKey)(
        compiled=comp, domain=domain, params=params, **crs)
    vk = {k: RingElem(ring, residues(arrays["vk"][k], ring.p)) for k in _VK}
    return KeyPair(pk=pk, vk=VerificationKey(pk=pk, sk_enc=_sk_from_numpy(ectx, arrays["sk"]),
                                             **vk))


def _sk_from_numpy(ectx, sk: dict) -> SecretKey:
    return SecretKey(ctx=ectx, s_ntt=residues(sk["s_ntt"], ectx.inner_consts(0)),
                     s_coeffs=np.asarray(sk["s_coeffs"], dtype=np.int8))


def _compiled_to_numpy(comp: CompiledR1CS) -> dict:
    return {
        "rows": tuple(r.cpu().numpy() for r in comp.rows),
        "cols": tuple(r.cpu().numpy() for r in comp.cols),
        "coeffs": tuple(_host(x) for x in comp.coeffs),
        "num_constraints": comp.num_constraints,
        "num_variables": comp.num_variables,
        "primary_input_size": comp.primary_input_size,
    }


def keypair_to_numpy(kp: KeyPair) -> dict:
    pk, vk = kp.pk, kp.vk
    comp = pk.compiled

    def enc(e):
        if e is None:
            return None
        if isinstance(e, SeededEncoding):
            return {"c0": _host(e.c0), "key": key_to_numpy(e.key), "slab": e.slab,
                    "batch": e.batch}
        return (_host(e.c0), _host(e.c1))

    return {
        "compiled": _compiled_to_numpy(comp),
        "domain_size": pk.domain.m,
        "crs": {k: enc(getattr(pk, k)) for k in _CRS},
        "vk": {k: getattr(vk, k).numpy() for k in _VK},
        "sk": {"s_ntt": _host(vk.sk_enc.s_ntt), "s_coeffs": vk.sk_enc.s_coeffs},
    }


def rinocchio_vk_from_numpy(params: SnarkParams, arrays: dict) -> rinocchio.VerificationKey:
    """The vk of `arrays`; its pk holds the encodings of ``arrays["crs"]``
    where there is one (a resident keypair), else none (a streamed vk)."""
    ring = params.ring
    comp = compiled_from_numpy(ring, arrays["compiled"])
    domain = RootsDomain(ring, int(arrays["domain_size"]))
    assert domain.m == int(arrays["domain_size"])
    crs = arrays.get("crs") or {}
    encs = {f: None if crs.get(f) is None else _enc(params.enc, *crs[f]) for f in _RIN_CRS}
    pk = rinocchio.ProvingKey(constraint_system=None, compiled=comp, domain=domain,
                              params=params, **encs)
    vk = {k: RingElem(ring, residues(arrays["vk"][k], ring.p)) for k in _RIN_VK}
    return rinocchio.VerificationKey(pk=pk, sk_enc=_sk_from_numpy(params.enc, arrays["sk"]),
                                     **vk)


def rinocchio_keypair_from_numpy(params: SnarkParams, arrays: dict) -> KeyPair:
    vk = rinocchio_vk_from_numpy(params, arrays)
    return KeyPair(pk=vk.pk, vk=vk)


def rinocchio_keypair_to_numpy(kp: KeyPair) -> dict:
    encs = ((f, getattr(kp.pk, f)) for f in _RIN_CRS)
    return dict(rinocchio_vk_to_numpy(kp.vk),
                crs={f: None if e is None else (_host(e.c0), _host(e.c1)) for f, e in encs})


def rinocchio_vk_to_numpy(vk: rinocchio.VerificationKey) -> dict:
    return {
        "compiled": _compiled_to_numpy(vk.pk.compiled),
        "domain_size": vk.pk.domain.m,
        "vk": {k: getattr(vk, k).numpy() for k in _RIN_VK},
        "sk": {"s_ntt": _host(vk.sk_enc.s_ntt), "s_coeffs": vk.sk_enc.s_coeffs},
    }


def proof_to_numpy(proof):
    """One ``(c0, c1, level)`` triple of uint32 numpy arrays per element
    (A, B, C; or A, A', ..., D', F for Rinocchio), None for a missing F."""
    names = _RIN_PROOF if isinstance(proof, rinocchio.Proof) else ("A", "B", "C")
    return tuple(None if e is None else (_host(e.c0), _host(e.c1), e.level)
                 for e in (getattr(proof, n) for n in names))


def proof_from_numpy(params: SnarkParams, triples):
    """A ringGroth16 Proof from 3 triples, a Rinocchio Proof from 9."""
    encs = [None if t is None else _enc(params.enc, t[0], t[1], int(t[2])) for t in triples]
    if len(encs) == 3:
        return Proof(*encs)
    return rinocchio.Proof(**dict(zip(_RIN_PROOF, encs)))


def key_from_numpy(data) -> prng.Key:
    """A threefry key from its key data, uint32[2]."""
    k = np.asarray(data).astype(np.uint64).reshape(-1)
    assert k.shape == (2,), k.shape
    return int(k[0]), int(k[1])


def key_to_numpy(key: prng.Key) -> np.ndarray:
    return np.array(key, dtype=np.uint32)
