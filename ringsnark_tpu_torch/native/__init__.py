"""ctypes bindings for the native C++ library: the CPU oracle and baseline.

Port of ``ringsnark_tpu/native/__init__.py`` (the same functions, numpy in
and out).  The library is compiled at first use from the repository's
``native/ringsnark_native.cpp`` with the flags of ``native/Makefile`` into
``ringsnark_tpu_torch/_build/`` (named by a hash of the source and the
command, so a changed source builds anew); ``native/`` itself is never
written.  Nothing is built at import.  Where no C++ compiler is present,
``available()`` is False; this is the host baseline, not a path the card
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "build",
    "set_threads",
    "max_threads",
    "mulmod",
    "powmod",
    "invmod",
    "negacyclic_ntt",
    "negacyclic_intt",
    "cyclic_ntt",
    "cyclic_intt",
    "ip_accumulate",
    "ip_accumulate_scalar",
    "lift_rows",
    "g16_witness_map",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "ringsnark_native.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-fopenmp")


def _compilers() -> list[str]:
    """$CXX (as native/Makefile takes it), then g++ and c++ on the PATH."""
    found = [os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")]
    return list(dict.fromkeys(c for c in found if c))


def build() -> Path:
    """Compile the library unless one of this source and command exists,
    with the first compiler of `_compilers()` that builds it (one compiler's
    OpenMP can be missing where another's is there); raises where none
    does, with each compiler's message."""
    if not SOURCE.exists():
        raise RuntimeError(f"cannot build {SOURCE}: no source")
    errors = []
    for cxx in _compilers():
        cmd = [cxx, *CXXFLAGS, "-shared"]
        tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(cmd).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libringsnark_native_{tag}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            res = subprocess.run([*cmd, "-o", str(tmp), str(SOURCE)], capture_output=True,
                                 text=True)
        except OSError as e:  # a $CXX that does not run
            errors.append(f"{cxx}: {e}")
            continue
        if res.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{cxx} failed ({res.returncode}):\n{res.stderr}")
    raise RuntimeError(f"cannot build {SOURCE}: " + ("\n".join(errors) or "no C++ compiler"))


@lru_cache(maxsize=1)
def _lib():
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        return None
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    lib.rn_mulmod.restype = u32
    lib.rn_mulmod.argtypes = [u32, u32, u32]
    lib.rn_powmod.restype = u32
    lib.rn_powmod.argtypes = [u32, u64, u32]
    lib.rn_invmod.restype = u32
    lib.rn_invmod.argtypes = [u32, u32]
    lib.rn_negacyclic_ntt.argtypes = [pu32, u64, u32, u32, u32, u32]
    lib.rn_negacyclic_intt.argtypes = [pu32, u64, u32, u32, u32, u32]
    lib.rn_cyclic_ntt.argtypes = [pu32, u64, u32, u32, u32]
    lib.rn_cyclic_intt.argtypes = [pu32, u64, u32, u32, u32]
    lib.rn_ip_accumulate.argtypes = [pu32, pu32, pu32, u64, u64, u32]
    lib.rn_ip_accumulate_scalar.argtypes = [pu32, pu32, pu32, u64, u64, u32]
    lib.rn_lift_rows.argtypes = [pu32, pu32, u64, u32, u32]
    lib.rn_g16_witness_map.argtypes = [
        pi32, pi32, pu32, u64, u32,  # A matrix COO (+ coeff slot count)
        pi32, pi32, pu32, u64, u32,  # B matrix COO
        pu32, u32, u32, u32, u32, u32,  # z, S, M, p, w, w2
        pu32, pu32, pu32,  # a_full, b_full, H
    ]
    lib.rn_set_threads.argtypes = [ctypes.c_int]
    lib.rn_get_max_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _lib() is not None


def set_threads(n: int) -> None:
    """Set the OpenMP thread count for the CPU baseline legs (1 = the
    single-core leg; max_threads() = the 'single-socket' leg)."""
    _lib().rn_set_threads(int(n))


def max_threads() -> int:
    return int(_lib().rn_get_max_threads())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def mulmod(a: int, b: int, p: int) -> int:
    return int(_lib().rn_mulmod(a, b, p))


def powmod(a: int, e: int, p: int) -> int:
    return int(_lib().rn_powmod(a, e, p))


def invmod(a: int, p: int) -> int:
    return int(_lib().rn_invmod(a, p))


def _batched(fn, data: np.ndarray, *args) -> np.ndarray:
    out = np.ascontiguousarray(data, dtype=np.uint32).copy()
    batch = out.size // out.shape[-1]
    fn(_ptr(out), batch, out.shape[-1], *args)
    return out


def negacyclic_ntt(data, p, w, psi):
    """In the DIF/bit-reversed-out convention of ops/ntt.py."""
    return _batched(_lib().rn_negacyclic_ntt, data, p, w, psi)


def negacyclic_intt(data, p, w, psi):
    return _batched(_lib().rn_negacyclic_intt, data, p, w, psi)


def cyclic_ntt(data, p, w):
    return _batched(_lib().rn_cyclic_ntt, data, p, w)


def cyclic_intt(data, p, w):
    return _batched(_lib().rn_cyclic_intt, data, p, w)


def ip_accumulate(ct: np.ndarray, pt: np.ndarray, p: int) -> np.ndarray:
    """sum_b ct[b] * pt[b] elementwise over trailing dims, one limb."""
    ct = np.ascontiguousarray(ct, dtype=np.uint32)
    pt = np.ascontiguousarray(pt, dtype=np.uint32)
    assert ct.shape == pt.shape
    batch, n = ct.shape[0], ct.size // ct.shape[0]
    acc = np.zeros(n, dtype=np.uint32)
    _lib().rn_ip_accumulate(_ptr(ct), _ptr(pt), _ptr(acc), batch, n, p)
    return acc.reshape(ct.shape[1:])


def ip_accumulate_scalar(ct: np.ndarray, w: np.ndarray, p: int) -> np.ndarray:
    """sum_b ct[b] * w[b] (scalar weight per row), one limb."""
    ct = np.ascontiguousarray(ct, dtype=np.uint32)
    w = np.ascontiguousarray(w, dtype=np.uint32)
    batch, n = ct.shape[0], ct.size // ct.shape[0]
    assert w.shape == (batch,)
    acc = np.zeros(n, dtype=np.uint32)
    _lib().rn_ip_accumulate_scalar(_ptr(ct), _ptr(w), _ptr(acc), batch, n, p)
    return acc.reshape(ct.shape[1:])


def lift_rows(v: np.ndarray, t: int, Q: int) -> np.ndarray:
    """Centered lift of values mod t into limb modulus Q."""
    v = np.ascontiguousarray(v, dtype=np.uint32)
    out = np.empty_like(v)
    _lib().rn_lift_rows(_ptr(v), _ptr(out), v.size, t, Q)
    return out


def g16_witness_map(coo_a, coo_b, z: np.ndarray, M: int, p: int, w: int, w2: int):
    """The ringGroth16 prover-mode witness map, one outer limb.

    coo_a/coo_b: (rows int32[nnz], cols int32[nnz], coeffs uint32[nnz] or
    uint32[nnz, S] per slot); z: uint32[num_vars+1, S] full assignment
    (S = 1 for Z_q).  Returns (a_full[M, S], b_full[M, S], H[M+1, S])
    coefficient vectors, bit-exact against the witness map of the same roots
    w (order M) and w2 (order 2M)."""
    z = np.ascontiguousarray(z, dtype=np.uint32)
    if z.ndim == 1:
        z = z[:, None]
    S = z.shape[1]

    def prep(coo):
        r, c, v = coo
        r = np.ascontiguousarray(r, np.int32)
        c = np.ascontiguousarray(c, np.int32)
        v = np.ascontiguousarray(v, np.uint32)
        slots = 1 if v.ndim == 1 else v.shape[1]
        assert slots in (1, S), (slots, S)
        return r, c, v, slots

    ra, ca, va, sa = prep(coo_a)
    rb, cb, vb, sb = prep(coo_b)
    a_full = np.zeros((M, S), dtype=np.uint32)
    b_full = np.zeros((M, S), dtype=np.uint32)
    H = np.zeros((M + 1, S), dtype=np.uint32)
    _lib().rn_g16_witness_map(
        _iptr(ra), _iptr(ca), _ptr(va), len(ra), sa,
        _iptr(rb), _iptr(cb), _ptr(vb), len(rb), sb,
        _ptr(z), S, M, p, w, w2, _ptr(a_full), _ptr(b_full), _ptr(H),
    )
    return a_full, b_full, H
