"""Batched cyclic / negacyclic NTT over RNS limbs: plans, plain twins, dispatch.

Port of ``ringsnark_tpu/ops/ntt.py``.  ``get_plan`` and ``bitrev_indices``
are the JAX package's numpy code, unchanged, so the root chain and the
bit-reversed slot order are identical.

Layout: data ``[..., L, M]`` (L = RNS limbs, M = transform size, a power of
two), int32 residues.  Ordering (Harvey/SEAL style, as in the JAX package):

* ``cyclic_ntt_rev``: natural coefficients in -> bit-reversed evaluations out
  (output j holds the evaluation at ``w^bitrev(j)``);
* ``cyclic_intt_nat``: bit-reversed evaluations in -> natural coefficients
  out, scaled by M^-1 (``scale=False`` leaves the scale out: the
  coefficient-sharded inverse applies it after its exchange stages);
* the negacyclic pair twists by psi^i before / psi^-i * M^-1 after.

Large sizes split as M = R * Mi (``get_split_tables``, ``ntt_split_plain``,
the port of ``ntt_split_pallas``): the forward transform runs log2(R) outer
DIF stages across the R rows of each column of the [R, Mi] view, then R
inner cyclic transforms of size Mi; the inverse runs the inner transforms
unscaled, then the outer DIT stages and the folded scale.  Roots are
canonical (w_M^R = w_Mi), so the result equals the full-size transform bit
for bit.

Dispatch: a CUDA tensor goes to the hand-written kernels
(``ops/cuda_ntt.py``): the shared-memory kernel up to ``MAX_KERNEL_M``, the
split kernel above it at any power of two (inner size ``split_mi(M)``).
A CPU tensor goes to the plain PyTorch twin (``*_plain`` below).  A CUDA
tensor never reaches a twin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from . import primes as _primes

__all__ = [
    "NTTPlan",
    "get_plan",
    "cyclic_ntt_rev",
    "cyclic_intt_nat",
    "negacyclic_ntt_rev",
    "negacyclic_intt_nat",
    "cyclic_ntt_rev_plain",
    "cyclic_intt_nat_plain",
    "negacyclic_ntt_rev_plain",
    "negacyclic_intt_nat_plain",
    "bitrev_indices",
    "SplitTables",
    "get_split_tables",
    "ntt_split_plain",
    "MAX_KERNEL_M",
    "SPLIT_MI",
    "split_mi",
    "PLAIN_TWINS",
]


def bitrev_indices(M: int) -> np.ndarray:
    bits = M.bit_length() - 1
    idx = np.arange(M, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _mod_powers(w: int, n: int, p: int) -> np.ndarray:
    """[1, w, w^2, ..., w^(n-1)] mod p as uint32, via log(n) numpy doublings."""
    pw = np.array([1], dtype=np.uint64)
    while len(pw) < n:
        step = pow(int(w), len(pw), int(p))
        pw = np.concatenate([pw, (pw * step) % p])
    return pw[:n].astype(np.uint32)


@dataclass(frozen=True)
class NTTPlan:
    """Precomputed numpy tables for size-M (neg)acyclic NTTs over a prime chain."""

    primes: tuple[int, ...]
    M: int
    # broadcast-ready limb constants, shape [L, 1]
    p: object = field(hash=False, compare=False)
    # forward DIF stage twiddles: tuple over stages (d = M/2 .. 1) of [L, d]
    fwd_tw: tuple = field(hash=False, compare=False)
    # inverse DIT stage twiddles: tuple over stages (d = 1 .. M/2) of [L, d]
    inv_tw: tuple = field(hash=False, compare=False)
    minv: object = field(hash=False, compare=False)  # [L, 1]
    psi: object = field(hash=False, compare=False)  # [L, M] or None
    psi_inv_scaled: object = field(hash=False, compare=False)  # [L, M] * M^-1 or None
    # host-side table
    eval_points_np: object = field(hash=False, compare=False)  # [L, M] uint32: w^bitrev(j)
    w_np: tuple = field(hash=False, compare=False)  # per-limb M-th root

    @property
    def L(self) -> int:
        return len(self.primes)

    @property
    def negacyclic(self) -> bool:
        return self.psi is not None


@lru_cache(maxsize=None)
def get_plan(primes: tuple[int, ...], M: int, negacyclic: bool = False) -> NTTPlan:
    assert M & (M - 1) == 0 and M >= 2
    for p in primes:
        order = 2 * M if negacyclic else M
        assert (p - 1) % order == 0, f"prime {p} lacks order-{order} roots"

    p_np = np.array(primes, dtype=np.uint32)
    ws = [_primes.root_of_unity(p, M) for p in primes]
    w_pows = np.stack([_mod_powers(w, M, p) for w, p in zip(ws, primes)])  # [L, M]
    winv_pows = np.stack(
        [_mod_powers(pow(w, p - 2, p), M, p) for w, p in zip(ws, primes)]
    )

    logM = M.bit_length() - 1
    fwd_tw = []
    for s in range(logM):
        d = M >> (s + 1)
        stride = M // (2 * d)
        fwd_tw.append(np.ascontiguousarray(w_pows[:, : d * stride : stride]))  # [L, d]
    inv_tw = []
    for s in range(logM):
        d = 1 << s
        stride = M // (2 * d)
        inv_tw.append(np.ascontiguousarray(winv_pows[:, : d * stride : stride]))

    minv_np = np.array([pow(M, p - 2, p) for p in primes], dtype=np.uint32)

    psi = psi_inv_scaled = None
    if negacyclic:
        psis = [_primes.root_of_unity(p, 2 * M) for p in primes]
        # choose psi with psi^2 = w so the twist matches the cyclic tables
        psis2 = []
        for psi_c, w, p in zip(psis, ws, primes):
            if pow(psi_c, 2, p) == w:
                psis2.append(psi_c)
            else:
                k = _dlog_pow2(pow(psi_c, 2, p), w, p, M)
                psis2.append(pow(psi_c, k, p))
                assert pow(psis2[-1], 2, p) == w
        psi_pows = np.stack([_mod_powers(s, M, p) for s, p in zip(psis2, primes)])
        psiinv_pows = np.stack(
            [_mod_powers(pow(s, p - 2, p), M, p) for s, p in zip(psis2, primes)]
        )
        psiinv_scaled = (psiinv_pows.astype(np.uint64) * minv_np[:, None]) % p_np[
            :, None
        ].astype(np.uint64)
        psi = psi_pows
        psi_inv_scaled = psiinv_scaled.astype(np.uint32)

    br = bitrev_indices(M)
    eval_points = w_pows[:, br]  # [L, M]: point for slot j

    return NTTPlan(
        primes=primes,
        M=M,
        p=p_np[:, None],
        fwd_tw=tuple(fwd_tw),
        inv_tw=tuple(inv_tw),
        minv=minv_np[:, None],
        psi=psi,
        psi_inv_scaled=psi_inv_scaled,
        eval_points_np=eval_points,
        w_np=tuple(ws),
    )


def _dlog_pow2(base: int, target: int, p: int, order: int) -> int:
    """Solve base^k = target mod p where base has power-of-two order (small)."""
    x = 1
    for k in range(order):
        if x == target:
            return k
        x = x * base % p
    raise ValueError("discrete log not found")


# ---------------------------------------------------------------------------
# plain PyTorch twins (the stage math of the JAX package's XLA path)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _TwinTables:
    p: torch.Tensor  # [L, 1] int64
    fwd_tw: tuple  # per stage [L, d] int64
    inv_tw: tuple
    minv: torch.Tensor  # [L, 1]
    psi: torch.Tensor | None  # [L, M]
    psi_inv_scaled: torch.Tensor | None


@lru_cache(maxsize=None)
def _twin_tables(primes: tuple, M: int, negacyclic: bool, device: str) -> _TwinTables:
    plan = get_plan(primes, M, negacyclic)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return _TwinTables(
        p=t(plan.p),
        fwd_tw=tuple(t(x) for x in plan.fwd_tw),
        inv_tw=tuple(t(x) for x in plan.inv_tw),
        minv=t(plan.minv),
        psi=None if plan.psi is None else t(plan.psi),
        psi_inv_scaled=None if plan.psi is None else t(plan.psi_inv_scaled),
    )


def _tables_for(x: torch.Tensor, plan: NTTPlan) -> _TwinTables:
    assert x.shape[-2:] == (plan.L, plan.M), (tuple(x.shape), plan.L, plan.M)
    return _twin_tables(plan.primes, plan.M, plan.negacyclic, str(x.device))


def _fwd_stages(x, tb: _TwinTables, M: int):
    batch = x.shape[:-1]  # (..., L)
    p3 = tb.p[:, None, :]  # [L, 1, 1]
    for s, tw in enumerate(tb.fwd_tw):
        d = M >> (s + 1)
        xr = x.reshape(*batch, M // (2 * d), 2, d)
        a_, b_ = xr[..., 0, :], xr[..., 1, :]
        na = a_ + b_
        na = torch.where(na >= p3, na - p3, na)
        nb_ = torch.remainder((a_ - b_) * tw[:, None, :], p3)
        x = torch.stack([na, nb_], dim=-2).reshape(*batch, M)
    return x


def _inv_stages(x, tb: _TwinTables, M: int):
    batch = x.shape[:-1]
    p3 = tb.p[:, None, :]
    for s, tw in enumerate(tb.inv_tw):
        d = 1 << s
        xr = x.reshape(*batch, M // (2 * d), 2, d)
        a_, b_ = xr[..., 0, :], xr[..., 1, :]
        t = torch.remainder(b_ * tw[:, None, :], p3)
        na = a_ + t
        na = torch.where(na >= p3, na - p3, na)
        nb_ = a_ - t
        nb_ = torch.where(nb_ < 0, nb_ + p3, nb_)
        x = torch.stack([na, nb_], dim=-2).reshape(*batch, M)
    return x


def cyclic_ntt_rev_plain(x, plan: NTTPlan):
    """Forward cyclic NTT along the last axis; natural in, bit-reversed out."""
    tb = _tables_for(x, plan)
    return _fwd_stages(x.to(torch.int64), tb, plan.M).to(torch.int32)


def cyclic_intt_nat_plain(x, plan: NTTPlan, scale: bool = True):
    """Inverse cyclic NTT along the last axis; bit-reversed in, natural out;
    times M^-1 unless `scale` is off."""
    tb = _tables_for(x, plan)
    y = _inv_stages(x.to(torch.int64), tb, plan.M)
    if not scale:
        return y.to(torch.int32)
    return torch.remainder(y * tb.minv, tb.p).to(torch.int32)


def negacyclic_ntt_rev_plain(x, plan: NTTPlan):
    """Negacyclic forward NTT: psi-twist then cyclic; natural in, rev out."""
    assert plan.negacyclic, "plan built without negacyclic=True"
    tb = _tables_for(x, plan)
    y = torch.remainder(x.to(torch.int64) * tb.psi, tb.p)
    return _fwd_stages(y, tb, plan.M).to(torch.int32)


def negacyclic_intt_nat_plain(y, plan: NTTPlan):
    """Negacyclic inverse NTT: cyclic inverse then psi^-1 * M^-1 twist."""
    assert plan.negacyclic, "plan built without negacyclic=True"
    tb = _tables_for(y, plan)
    x = _inv_stages(y.to(torch.int64), tb, plan.M)
    return torch.remainder(x * tb.psi_inv_scaled, tb.p).to(torch.int32)


# ---------------------------------------------------------------------------
# the split transform for large M (port of pallas_ntt.get_split_tables and
# ntt_split_pallas's math)
# ---------------------------------------------------------------------------


def shoup_np(vals, p) -> np.ndarray:
    """Shoup constants floor(v * 2^32 / p) as uint64 (v < p < 2^31; p
    broadcasts against vals)."""
    return (np.asarray(vals).astype(np.uint64) << np.uint64(32)) // np.asarray(p, np.uint64)


@dataclass(frozen=True)
class SplitTables:
    """Tables of the split transform M = R * Mi (layout of the JAX package's
    ``SplitNTTTables``, without its TPU inner tables).

    fwd_tw[l, i, r, c]: outer DIF stage i (pair distance d = R >> (i+1))
    twiddle w^(2^i (lo Mi + c)) at the b-row r of a pair, lo = r mod d,
    and 1 at a-rows; inv_tw: w^-(...) at both rows of a pair.  psi and
    psiinv_s ([L, R, Mi]) are the negacyclic twists (psi^-k M^-1 after the
    inverse), None for a cyclic table set; minv holds the full-size M^-1.
    """

    primes: tuple[int, ...]
    M: int
    Mi: int
    fwd_tw: object = field(hash=False, compare=False)  # uint32 [L, s, R, Mi]
    fwd_tw_sh: object = field(hash=False, compare=False)
    inv_tw: object = field(hash=False, compare=False)
    inv_tw_sh: object = field(hash=False, compare=False)
    psi: object = field(hash=False, compare=False)  # uint32 [L, R, Mi] or None
    psi_sh: object = field(hash=False, compare=False)
    psiinv_s: object = field(hash=False, compare=False)
    psiinv_s_sh: object = field(hash=False, compare=False)
    minv: tuple = field(hash=False, compare=False)
    minv_sh: tuple = field(hash=False, compare=False)

    @property
    def L(self) -> int:
        return len(self.primes)

    @property
    def R(self) -> int:
        return self.M // self.Mi

    @property
    def s(self) -> int:
        return self.R.bit_length() - 1


@lru_cache(maxsize=None)
def get_split_tables(primes: tuple[int, ...], M: int, Mi: int,
                     negacyclic: bool = True) -> SplitTables:
    """The JAX package's ``get_split_tables`` (numpy), with its assertion that
    the roots are canonical.  ``negacyclic=False`` leaves out the psi
    tables, so a cyclic split needs only order-M roots."""
    assert M % Mi == 0 and Mi >= 2 and Mi & (Mi - 1) == 0
    R = M // Mi
    assert R & (R - 1) == 0 and R >= 2
    s = R.bit_length() - 1
    L = len(primes)
    plan = get_plan(primes, M, negacyclic=negacyclic)
    ws = [_primes.root_of_unity(p, M) for p in primes]
    # inner transforms must come from the same canonical root chain
    for w, p in zip(ws, primes):
        assert pow(w, R, p) == _primes.root_of_unity(p, Mi), (
            "non-canonical roots: the split path would diverge from the full-size one")

    ks = np.arange(Mi)
    fwd, fwd_sh, inv, inv_sh, minv, minv_sh = [], [], [], [], [], []
    for w, p in zip(ws, primes):
        w_pows = _mod_powers(w, M, p)
        winv_pows = _mod_powers(pow(w, p - 2, p), M, p)
        f_st, i_st = [], []
        for i in range(s):
            d = R >> (i + 1)
            r = np.arange(R)
            lo = r & (d - 1)
            idx = ((1 << i) * (lo[:, None] * Mi + ks[None, :])) % M  # [R, Mi]
            is_b = (r & (2 * d - 1)) >= d
            f_st.append(np.where(is_b[:, None], w_pows[idx], 1).astype(np.uint32))
            i_st.append(winv_pows[idx])
        fwd.append(np.stack(f_st))
        fwd_sh.append(np.stack([shoup_np(t, p) for t in f_st]))
        inv.append(np.stack(i_st))
        inv_sh.append(np.stack([shoup_np(t, p) for t in i_st]))
        mv = pow(M, p - 2, p)
        minv.append(mv)
        minv_sh.append((mv << 32) // p)

    psi = psi_sh = psiinv_s = psiinv_s_sh = None
    if negacyclic:
        psi = plan.psi.astype(np.uint32).reshape(L, R, Mi)
        psi_sh = np.stack([shoup_np(psi[l], p) for l, p in enumerate(primes)])
        psiinv_s = plan.psi_inv_scaled.astype(np.uint32).reshape(L, R, Mi)
        psiinv_s_sh = np.stack([shoup_np(psiinv_s[l], p) for l, p in enumerate(primes)])

    return SplitTables(
        primes=primes, M=M, Mi=Mi,
        fwd_tw=np.stack(fwd), fwd_tw_sh=np.stack(fwd_sh),
        inv_tw=np.stack(inv), inv_tw_sh=np.stack(inv_sh),
        psi=psi, psi_sh=psi_sh, psiinv_s=psiinv_s, psiinv_s_sh=psiinv_s_sh,
        minv=tuple(minv), minv_sh=tuple(minv_sh),
    )


@lru_cache(maxsize=None)
def _split_twin_tables(primes: tuple, M: int, Mi: int, negacyclic: bool, device: str):
    st = get_split_tables(primes, M, Mi, negacyclic)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return dict(
        p=t(np.array(primes))[:, None, None],  # [L, 1, 1]
        fwd_tw=t(st.fwd_tw), inv_tw=t(st.inv_tw),  # [L, s, R, Mi]
        psi=None if st.psi is None else t(st.psi),  # [L, R, Mi]
        psiinv_s=None if st.psi is None else t(st.psiinv_s),
        minv=t(np.array(st.minv))[:, None, None],
    )


def ntt_split_plain(x, plan: NTTPlan, inverse: bool, negacyclic: bool, mi: int = None,
                    scale: bool = True):
    """The split transform of ``[..., L, M]`` in plain PyTorch: the outer
    stages in int64 on the ``[..., L, R, Mi]`` view, and the plain twins'
    stages for the R inner cyclic transforms of size Mi (unscaled).  Equal
    to the full-size transform of the same mode, bit for bit; the cyclic
    inverse leaves out M^-1 when `scale` is off."""
    check_scale(inverse, negacyclic, scale)
    mi = split_mi(plan.M) if mi is None else mi
    M, L = plan.M, plan.L
    assert tuple(x.shape[-2:]) == (L, M), (tuple(x.shape), L, M)
    assert not negacyclic or plan.negacyclic, "negacyclic transform with a cyclic plan"
    R = M // mi
    tb = _split_twin_tables(plan.primes, M, mi, negacyclic, str(x.device))
    inner = _twin_tables(plan.primes, mi, False, str(x.device))
    p = tb["p"]
    batch = x.shape[:-2]
    xr = x.to(torch.int64).reshape(*batch, L, R, mi)

    def outer_pairs(v, d):  # [..., L, R, Mi] -> a-rows, b-rows [..., L, R/2d, d, Mi]
        v = v.reshape(*batch, L, R // (2 * d), 2, d, mi)
        return v[..., 0, :, :], v[..., 1, :, :]

    def tw_b(tw, i, d):  # b-row twiddles of stage i: [L, R/2d, d, Mi]
        return tw[:, i].reshape(L, R // (2 * d), 2, d, mi)[:, :, 1]

    def inner_pass(v, stages):  # cyclic stages on the [..., L, R, Mi] rows
        return stages(v.transpose(-3, -2), inner, mi).transpose(-3, -2)

    if not inverse:
        if negacyclic:
            xr = torch.remainder(xr * tb["psi"], p)
        for i in range(R.bit_length() - 1):
            d = R >> (i + 1)
            a, b = outer_pairs(xr, d)
            na = a + b
            na = torch.where(na >= p[..., None], na - p[..., None], na)
            nb = torch.remainder((a - b) * tw_b(tb["fwd_tw"], i, d), p[..., None])
            xr = torch.stack([na, nb], dim=-3).reshape(*batch, L, R, mi)
        out = inner_pass(xr, _fwd_stages)
    else:
        xr = inner_pass(xr, _inv_stages)
        for i in range(R.bit_length() - 2, -1, -1):
            d = R >> (i + 1)
            a, b = outer_pairs(xr, d)
            m = torch.remainder(b * tw_b(tb["inv_tw"], i, d), p[..., None])
            na = a + m
            na = torch.where(na >= p[..., None], na - p[..., None], na)
            nb = a - m
            nb = torch.where(nb < 0, nb + p[..., None], nb)
            xr = torch.stack([na, nb], dim=-3).reshape(*batch, L, R, mi)
        if negacyclic or scale:
            xr = torch.remainder(xr * (tb["psiinv_s"] if negacyclic else tb["minv"]), p)
        out = xr
    return out.reshape(*batch, L, M).to(torch.int32)


# ---------------------------------------------------------------------------
# dispatch: CUDA tensor -> kernel, CPU tensor -> plain twin
# ---------------------------------------------------------------------------

# Largest transform the shared-memory kernel holds (128 KiB of residues).
MAX_KERNEL_M = 32768
# The split route for M > MAX_KERNEL_M: M = R * mi with mi = SPLIT_MI (the
# JAX package's ``_SPLIT_MI``) up to R = 32, i.e. M = 2^15 .. 2^19, where the
# outer stages take one pass; above, mi = MAX_KERNEL_M, so 2^20 still takes
# one outer pass and every larger size one more pass per five stages.
SPLIT_MI = 16384


def split_mi(M: int) -> int:
    """The inner size of the split transform of size M > MAX_KERNEL_M."""
    return SPLIT_MI if M <= 32 * SPLIT_MI else MAX_KERNEL_M

# (inverse, negacyclic) -> plain twin
PLAIN_TWINS = {
    (False, False): cyclic_ntt_rev_plain,
    (True, False): cyclic_intt_nat_plain,
    (False, True): negacyclic_ntt_rev_plain,
    (True, True): negacyclic_intt_nat_plain,
}


def check_scale(inverse: bool, negacyclic: bool, scale: bool) -> None:
    """`scale=False` (no M^-1) is an option of the cyclic inverse only; every
    route refuses it elsewhere."""
    if not scale and (negacyclic or not inverse):
        raise ValueError("scale=False is an option of the cyclic inverse only")


def _dispatch(x, plan: NTTPlan, inverse: bool, negacyclic: bool, scale: bool = True):
    check_scale(inverse, negacyclic, scale)
    if x.device.type == "cpu":
        if not scale:
            return cyclic_intt_nat_plain(x, plan, scale=False)
        return PLAIN_TWINS[(inverse, negacyclic)](x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT route for device {x.device}")
    from . import cuda_ntt

    route = cuda_ntt.ntt if plan.M <= MAX_KERNEL_M else cuda_ntt.ntt_split
    return route(x.contiguous(), plan, inverse=inverse, negacyclic=negacyclic, scale=scale)


def cyclic_ntt_rev(x, plan: NTTPlan):
    return _dispatch(x, plan, inverse=False, negacyclic=False)


def cyclic_intt_nat(x, plan: NTTPlan, scale: bool = True):
    """The cyclic inverse; ``scale=False`` leaves out the factor M^-1."""
    return _dispatch(x, plan, inverse=True, negacyclic=False, scale=scale)


def negacyclic_ntt_rev(x, plan: NTTPlan):
    assert plan.negacyclic, "plan built without negacyclic=True"
    return _dispatch(x, plan, inverse=False, negacyclic=True)


def negacyclic_intt_nat(y, plan: NTTPlan):
    assert plan.negacyclic, "plan built without negacyclic=True"
    return _dispatch(y, plan, inverse=True, negacyclic=True)
