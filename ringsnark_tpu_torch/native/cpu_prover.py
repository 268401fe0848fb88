"""The measured same-algorithm CPU prover: the host baseline of ringGroth16.

Port of ``ringsnark_tpu/native/cpu_prover.py``.  It runs the whole
ringGroth16 prover algorithm on the host CPU (OpenMP, the C++ kernels of
``native/ringsnark_native.cpp``): the NTT-based witness map (the algorithm
and roots of ``reductions/r1cs_to_qrp``'s prover mode, bit-exact against it)
followed by every MAC the prover performs (4 inner-product sides x 2
ciphertext components x L outer x L' inner limbs; dense rings also pay the
per-term plaintext-to-inner-NTT transform the reference performs inside
`multiply_plain`, `seal/seal_ring.tcc:509-548`).  The CRS ciphertext
buffers are uniform random words: the MAC's time does not depend on operand
values, so the measurement is timing-equivalent to a real CRS without the
setup's encryptions.  Reference algorithm: `groth16.tcc:69-115` +
`r1cs_to_qrp.tcc:148-259`, with the O(m^2) interpolation replaced by the
same O(M log M) NTT pipeline the port runs.

The roots come from this package's ``ops.ntt`` plans, whose root chain is
the JAX package's bit for bit.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops import ntt as _ntt
from . import (
    available,
    g16_witness_map,
    ip_accumulate,
    ip_accumulate_scalar,
    lift_rows,
    max_threads,
    negacyclic_intt,
    negacyclic_ntt,
    set_threads,
)

__all__ = ["groth16_prover_cpu"]


def _host(x) -> np.ndarray:
    """A tensor (or array) of residues as a host uint32 array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x).astype(np.uint32))


def groth16_prover_cpu(comp, ectx, z_full, aux, rng: np.random.Generator,
                       threads: int | None = None):
    """Measured full CPU ringGroth16 prove.

    comp: CompiledR1CS; ectx: EncodingContext; z_full: [nv+1, L, n] full
    assignment (constant 1 in row 0); aux: [n_aux, L, n] (tensors or numpy
    arrays of residues).  Returns (timings, outputs): timings =
    {"witness_map_s", "mac_s", "total_s", "threads"}; outputs = per-limb
    (a_full, b_full, H) for cross-validation."""
    assert available()
    set_threads(threads if threads is not None else max_threads())
    ring = ectx.ring
    M = 1
    while M < max(comp.num_constraints, 1):
        M <<= 1
    z_full, aux = _host(z_full), _host(aux)
    L, n = ring.L, z_full.shape[-1]
    dense = n > 1
    Np = ectx.n_inner
    inner = ectx.inner_primes
    plan_M = _ntt.get_plan(ring.primes, M)
    plan_2M = _ntt.get_plan(ring.primes, 2 * M)
    plain_plan = ectx.plain_plan
    inner_plan = ectx.inner_plan(0)

    rows = [_host(r).view(np.int32) for r in comp.rows]
    cols = [_host(c).view(np.int32) for c in comp.cols]
    coeffs = [_host(c) for c in comp.coeffs]

    # timing-equivalent random CRS component buffers (reused across sides
    # and limbs; allocated outside the timed region: CRS generation is setup)
    B = M + 1
    ct0 = rng.integers(0, 1 << 31, (B, Np), dtype=np.int64).astype(np.uint32)
    ct1 = rng.integers(0, 1 << 31, (B, Np), dtype=np.int64).astype(np.uint32)

    def pad_rows(v, tgt):
        if v.shape[0] == tgt:
            return v
        return np.concatenate([v, np.zeros((tgt - v.shape[0], *v.shape[1:]), dtype=v.dtype)])

    t0 = time.perf_counter()
    wm = []
    for l in range(L):
        def coo(i):
            c = coeffs[i][:, l, :]
            return rows[i], cols[i], (c[:, 0] if c.shape[1] == 1 else c)

        wm.append(g16_witness_map(coo(0), coo(1), z_full[:, l, :], M, ring.primes[l],
                                  int(plan_M.w_np[l]), int(plan_2M.w_np[l])))
    t_wm = time.perf_counter() - t0

    # MACs: 4 sides (A: a_full, B: b_full over s_pows; C: H over delta_ts +
    # aux over delta_mid), per outer limb x inner limb x 2 components
    t0 = time.perf_counter()
    for l in range(L):
        a_full, b_full, H = wm[l]
        if not dense:  # [*, 1] -> flat scalar weight vectors
            a_full, b_full, H = a_full[:, 0], b_full[:, 0], H[:, 0]
        t = ring.primes[l]
        sides = [pad_rows(a_full, B), pad_rows(b_full, B), H,
                 pad_rows(aux[:, l, :] if dense else aux[:, l, 0], B)]
        for v in sides:
            if not dense:
                for Q in inner:
                    w = lift_rows(v, t, Q)
                    ip_accumulate_scalar(ct0, w, Q)
                    ip_accumulate_scalar(ct1, w, Q)
            else:
                # outer slots -> plain coeffs mod t (pad to N', inverse NTT),
                # then per inner limb: centered lift + forward NTT + MAC,
                # the reference's multiply_plain per-term transform
                padded = np.concatenate([v, np.zeros((B, Np - v.shape[1]), dtype=np.uint32)],
                                        axis=1)
                pc = negacyclic_intt(padded, t, int(plain_plan.w_np[l]),
                                     int(plain_plan.psi[l, 1]))
                for j, Q in enumerate(inner):
                    ptntt = negacyclic_ntt(lift_rows(pc, t, Q), Q, int(inner_plan.w_np[j]),
                                           int(inner_plan.psi[j, 1]))
                    ip_accumulate(ct0, ptntt, Q)
                    ip_accumulate(ct1, ptntt, Q)
    t_mac = time.perf_counter() - t0

    timings = {
        "witness_map_s": round(t_wm, 3),
        "mac_s": round(t_mac, 3),
        "total_s": round(t_wm + t_mac, 3),
        "threads": max_threads(),
    }
    return timings, wm
