"""Keys, proofs and contexts on disk, in the JAX package's format.

Port of ``ringsnark_tpu/utils/serialization.py``: one ``.npz`` per object,
its arrays under the same names and a JSON header (``__meta__``) with the
same keys, so a file written by either package loads in the other.  Built
on the numpy forms of ``utils/interop.py``.

What differs from a direct translation:

* Residues are ``uint32`` on disk.  On load every residue array is masked to
  32 bits and reduced mod its primes before it becomes int32: a file written
  by the JAX package may hold unreduced words (its uint32 arithmetic reduces
  at the first multiply; the port's int32 residues must be canonical).
* The port writes ``np.savez`` (stored, not deflated): BGV residues are
  uniform, so deflate saves almost nothing and costs minutes of one host
  core at a CRS of gigabytes.  ``np.load`` reads both forms.
* A seeded batch is written as the JAX package keeps it: c0 padded with zero
  rows to whole slabs (no inner product reads them) and ``level`` 0; either
  form is read.  Its PRNG key is its key data ``uint32[2]`` and the impl
  name ``threefry2x32``, the string JAX prints for ``jax.random.key_impl``
  of the keys both packages use; a file naming another impl is refused.
* A resident ringGroth16 or Rinocchio key is written with its constraint
  system (JSON beside it), which the loader compiles again; a key made on
  the array path has none, and ``save_groth16_pk`` / ``save_rinocchio_pk``
  refuse it (``save_seeded_pk`` embeds the compiled arrays instead).
* Every loader takes a device (default the card); the loaded key is built,
  compiled and held there.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..encoding.context import EncodingContext, SecretKey
from ..encoding.encoding import Encoding
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .interop import _host, key_from_numpy, key_to_numpy
from .interop import residues as _residues

__all__ = [
    "save_proof",
    "load_proof",
    "save_groth16_pk",
    "load_groth16_pk",
    "save_rinocchio_pk",
    "load_rinocchio_pk",
    "save_seeded_pk",
    "load_seeded_pk",
    "save_compiled",
    "load_compiled",
    "save_vk",
    "load_vk",
    "save_secret_key",
    "load_secret_key",
    "context_to_json",
    "context_from_json",
]

KEY_IMPL = "threefry2x32"


def context_to_json(ectx: EncodingContext) -> str:
    return json.dumps(
        {
            "ring_primes": list(ectx.ring.primes),
            "ring_N": ectx.ring.N,
            "n_inner": ectx.n_inner,
            "inner_primes": list(ectx.inner_primes),
            "error_stddev": ectx.error_stddev,
            "floor_limbs": ectx.floor_limbs,
        }
    )


def context_from_json(s: str, device: str = "cuda") -> EncodingContext:
    o = json.loads(s)
    ring = RingContext(primes=tuple(o["ring_primes"]), N=o["ring_N"], device=device)
    return EncodingContext(
        ring=ring,
        n_inner=o["n_inner"],
        inner_primes=tuple(o["inner_primes"]),
        error_stddev=o["error_stddev"],
        floor_limbs=o.get("floor_limbs", 2),
    )


def _meta(data) -> dict:
    return json.loads(str(data["__meta__"]))


def _write(path: str, meta: dict, store: dict):
    np.savez(path, __meta__=json.dumps(meta), **store)


def _enc_arrays(prefix: str, e: Encoding | None, store: dict, meta: dict):
    if e is None:
        meta[prefix] = None
        return
    store[f"{prefix}_c0"] = _host(e.c0)
    store[f"{prefix}_c1"] = _host(e.c1)
    meta[prefix] = {"level": e.level}


def _enc_load(prefix: str, data, meta: dict, ectx: EncodingContext):
    if meta[prefix] is None:
        return None
    level = meta[prefix]["level"]
    Q = ectx.inner_consts(level)
    return Encoding(ectx, _residues(data[f"{prefix}_c0"], Q),
                    _residues(data[f"{prefix}_c1"], Q), level)


def save_proof(path: str, proof, ectx: EncodingContext):
    """Works for both rinocchio.Proof and groth16.Proof (duck-typed fields)."""
    store, meta = {}, {"ctx": context_to_json(ectx), "fields": []}
    for name in ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F"):
        if hasattr(proof, name):
            meta["fields"].append(name)
            _enc_arrays(name, getattr(proof, name), store, meta)
    _write(path, meta, store)


def load_proof(path: str, proof_cls, ectx: EncodingContext | None = None,
               device: str = "cuda"):
    """A proof of `proof_cls`, over `ectx` (its device) or over the context
    the file names, on `device`."""
    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        ectx = ectx or context_from_json(meta["ctx"], device)
        return proof_cls(**{n: _enc_load(n, data, meta, ectx) for n in meta["fields"]})


def _sk_store(sk: SecretKey, store: dict, prefix: str = ""):
    store[f"{prefix}s_ntt"] = _host(sk.s_ntt)
    store[f"{prefix}s_coeffs"] = np.asarray(sk.s_coeffs)


def _sk_load(data, ectx: EncodingContext, prefix: str = "") -> SecretKey:
    return SecretKey(ctx=ectx, s_ntt=_residues(data[f"{prefix}s_ntt"], ectx.inner_consts(0)),
                     s_coeffs=np.asarray(data[f"{prefix}s_coeffs"], dtype=np.int8))


def save_secret_key(path: str, sk: SecretKey):
    store = {}
    _sk_store(sk, store)
    np.savez(path, __meta__=context_to_json(sk.ctx), **store)


def load_secret_key(path: str, device: str = "cuda") -> SecretKey:
    with np.load(path, allow_pickle=False) as data:
        return _sk_load(data, context_from_json(str(data["__meta__"]), device))


def _system_or_refuse(pk, save_name: str):
    if pk.constraint_system is None:
        raise ValueError(
            f"{save_name}: this proving key was made from a CompiledR1CS (the array path) "
            "and has no constraint system to write beside it; save it with save_seeded_pk "
            "(seeded or streamed keys), which embeds the compiled arrays")
    return pk.constraint_system


_GROTH16_PK_ENCS = ("alpha", "beta", "s_pows", "gamma_io", "delta_mid", "delta_ts")


def _resident_pk_save(path: str, pk, cs_path: str, names, save_name: str):
    cs = _system_or_refuse(pk, save_name)
    cs.save(cs_path)
    store, meta = {}, {
        "ctx": context_to_json(pk.params.enc),
        "use_modswitch": pk.params.use_modswitch,
        "cs_path": cs_path,
    }
    for name in names:
        _enc_arrays(name, getattr(pk, name), store, meta)
    _write(path, meta, store)


def _resident_pk_load(path: str, device: str, names, pk_cls):
    """The key's constraint system loaded and compiled on `device`, its
    domain, and its encodings."""
    from ..relations.r1cs import R1CSConstraintSystem
    from ..snark.api import SnarkParams
    from .domain import RootsDomain

    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        ectx = context_from_json(meta["ctx"], device)
        cs = R1CSConstraintSystem.load(meta["cs_path"], ectx.ring)
        params = SnarkParams(ring=ectx.ring, enc=ectx, use_modswitch=meta["use_modswitch"])
        encs = {n: _enc_load(n, data, meta, ectx) for n in names}
    return pk_cls(
        constraint_system=cs,
        compiled=cs.compile(ectx.ring),
        domain=RootsDomain(ectx.ring, max(cs.num_constraints(), 1)),
        params=params,
        **encs,
    )


def save_groth16_pk(path: str, pk, cs_path: str):
    """The resident ringGroth16 CRS to npz, its constraint system to JSON."""
    _resident_pk_save(path, pk, cs_path, _GROTH16_PK_ENCS, "save_groth16_pk")


def load_groth16_pk(path: str, device: str = "cuda"):
    from ..snark.groth16 import ProvingKey

    return _resident_pk_load(path, device, _GROTH16_PK_ENCS, ProvingKey)


_RINOCCHIO_PK_ENCS = (
    "s_pows", "alpha_s_pows", "beta_prods", "beta_rv_ts", "beta_rw_ts",
    "beta_ry_ts", "alpha_rv_ts", "alpha_rw_ts", "alpha_ry_ts",
    "rv_vs", "rw_ws", "ry_ys",
)


def save_rinocchio_pk(path: str, pk, cs_path: str):
    """The resident Rinocchio CRS (its twelve encodings) to npz, its
    constraint system to JSON."""
    _resident_pk_save(path, pk, cs_path, _RINOCCHIO_PK_ENCS, "save_rinocchio_pk")


def load_rinocchio_pk(path: str, device: str = "cuda"):
    from ..snark.rinocchio import ProvingKey

    return _resident_pk_load(path, device, _RINOCCHIO_PK_ENCS, ProvingKey)


# ---- seeded / streamed key format -----------------------------------------
# c0-only CRS batches + the PRNG key that regenerates c1
# (snark/seeded.SeededEncoding), or the CRS-less stub the streamed provers
# return.  The compiled R1CS (array path) is embedded.


def save_compiled(store: dict, meta: dict, comp):
    meta["compiled"] = {
        "num_constraints": comp.num_constraints,
        "num_variables": comp.num_variables,
        "primary_input_size": comp.primary_input_size,
    }
    for i, which in enumerate("abc"):
        store[f"coo_{which}_rows"] = comp.rows[i].cpu().numpy().astype(np.int32)
        store[f"coo_{which}_cols"] = comp.cols[i].cpu().numpy().astype(np.int32)
        store[f"coo_{which}_coeffs"] = _host(comp.coeffs[i])


def load_compiled(data, meta: dict, ring: RingContext):
    from ..relations.r1cs import CompiledR1CS

    def idx(w, kind):
        return torch.from_numpy(np.asarray(data[f"coo_{w}_{kind}"], dtype=np.int64)).to(ring.device)

    m = meta["compiled"]
    return CompiledR1CS(
        ctx=ring,
        num_constraints=m["num_constraints"],
        num_variables=m["num_variables"],
        primary_input_size=m["primary_input_size"],
        rows=tuple(idx(w, "rows") for w in "abc"),
        cols=tuple(idx(w, "cols") for w in "abc"),
        coeffs=tuple(_residues(data[f"coo_{w}_coeffs"], ring.p) for w in "abc"),
    )


_SEEDED = ("s_pows", "delta_mid", "delta_ts")


def save_seeded_pk(path: str, pk):
    """seeded.SeededProvingKey to npz: c0 of the seeded batches (padded to
    whole slabs) with their PRNG keys, alpha, beta and gamma_io whole; or the
    streamed provers' CRS-less stub (gamma_io only)."""
    store, meta = {}, {
        "ctx": context_to_json(pk.params.enc),
        "use_modswitch": pk.params.use_modswitch,
        "seeded": [],
    }
    save_compiled(store, meta, pk.compiled)
    for name in ("alpha", "beta", "gamma_io"):
        _enc_arrays(name, getattr(pk, name), store, meta)
    for name in _SEEDED:
        se = getattr(pk, name)
        if se is None:
            meta[name] = None
            continue
        c0 = _host(se.c0)
        padded = np.zeros((se.nslab * se.slab, *c0.shape[1:]), dtype=np.uint32)
        padded[: se.batch] = c0
        store[f"{name}_c0"] = padded
        store[f"{name}_keydata"] = key_to_numpy(se.key)
        meta[f"{name}_impl"] = KEY_IMPL
        meta[name] = {"slab": se.slab, "batch": se.batch, "level": 0}
        meta["seeded"].append(name)
    _write(path, meta, store)


def load_seeded_pk(path: str, device: str = "cuda"):
    """A SeededProvingKey (or a streamed stub) on `device`, from a file of
    either package: c0 with or without its slab padding (rows past `batch`
    are dropped), at level 0, with a threefry2x32 key."""
    from ..snark.api import SnarkParams
    from ..snark.seeded import SeededEncoding, SeededProvingKey
    from .domain import RootsDomain

    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        ectx = context_from_json(meta["ctx"], device)
        comp = load_compiled(data, meta, ectx.ring)
        params = SnarkParams(ring=ectx.ring, enc=ectx, use_modswitch=meta["use_modswitch"])
        seeded = {}
        for name in _SEEDED:
            m = meta[name]
            if m is None:
                seeded[name] = None
                continue
            if meta[f"{name}_impl"] != KEY_IMPL or m.get("level", 0) != 0:
                raise ValueError(f"{path}: seeded batch {name} has PRNG impl "
                                 f"{meta[f'{name}_impl']!r} and level {m.get('level')}; "
                                 f"this package reads {KEY_IMPL!r} at level 0")
            batch = int(m["batch"])
            seeded[name] = SeededEncoding(
                ctx=ectx, c0=_residues(data[f"{name}_c0"][:batch], ectx.inner_consts(0)),
                key=key_from_numpy(data[f"{name}_keydata"]), slab=int(m["slab"]),
                batch=batch)
        whole = {n: _enc_load(n, data, meta, ectx) for n in ("alpha", "beta", "gamma_io")}
    return SeededProvingKey(
        compiled=comp,
        domain=RootsDomain(ectx.ring, max(comp.num_constraints, 1)),
        params=params,
        **whole,
        **seeded,
    )


_VK_RING_FIELDS = {
    "groth16": ("s", "alpha", "beta", "gamma", "delta"),
    "rinocchio": ("s", "alpha", "beta", "r_v", "r_w", "r_y"),
}


def save_vk(path: str, vk, pk_path: str, cs_path: str):
    """Verification key (designated verifier: the trapdoor ring elements and
    the encoding secret key) of either proof system; its pk is saved to
    `pk_path` (a resident key's constraint system to `cs_path`) and named
    by that path in the vk's header."""
    from ..snark import groth16 as _g16, rinocchio as _rin
    from ..snark.seeded import SeededProvingKey

    if isinstance(vk, _g16.VerificationKey):
        system = "groth16"
        if isinstance(vk.pk, SeededProvingKey):
            system = "groth16_seeded"
            save_seeded_pk(pk_path, vk.pk)
        else:
            save_groth16_pk(pk_path, vk.pk, cs_path)
    elif isinstance(vk, _rin.VerificationKey):
        system = "rinocchio"
        save_rinocchio_pk(pk_path, vk.pk, cs_path)
    else:
        raise TypeError(f"unknown verification key type {type(vk)}")
    store = {name: _host(getattr(vk, name).res) for name in _VK_RING_FIELDS[system.split("_")[0]]}
    _sk_store(vk.sk_enc, store, "sk_")
    meta = {"system": system, "pk_path": pk_path, "ctx": context_to_json(vk.pk.params.enc)}
    _write(path, meta, store)


def load_vk(path: str, device: str = "cuda"):
    """The vk and, from the path its header names, its pk, on `device`."""
    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        system = meta["system"]
        ectx = context_from_json(meta["ctx"], device)
        ring_fields = _VK_RING_FIELDS[system.split("_")[0]]
        elems = {name: RingElem(ectx.ring, _residues(data[name], ectx.ring.p))
                 for name in ring_fields}
        sk = _sk_load(data, ectx, "sk_")
    if system == "groth16_seeded":
        from ..snark.groth16 import VerificationKey

        pk = load_seeded_pk(meta["pk_path"], device)
    elif system == "groth16":
        from ..snark.groth16 import VerificationKey

        pk = load_groth16_pk(meta["pk_path"], device)
    elif system == "rinocchio":
        from ..snark.rinocchio import VerificationKey

        pk = load_rinocchio_pk(meta["pk_path"], device)
    else:
        raise ValueError(f"{path}: unknown proof system {system!r}")
    return VerificationKey(pk=pk, sk_enc=sk, **elems)
