"""Core batched BGV-symmetric operations on raw tensors.

Port of ``ringsnark_tpu/encoding/bgv.py``.  Ciphertext components are
``int32[*batch, L, L'_lvl, N']`` (L outer limbs = independent schemes,
L'_lvl inner RNS limbs at the current level, N' inner degree) in inner-NTT
form; plaintext slot arrays are ``[*batch, L, n]``.

Randomness: encryption draws its uniform mask and its centered-binomial
error from a threefry key (``utils/prng.py``) exactly as the JAX package
draws them from a ``jax.random`` key, so one key gives one ciphertext in
both packages.  A draw may be made for a row range ``rows=(lo, hi)`` of its
leading batch axis: those rows get the bits they get in the whole draw.
On a CUDA device the draws, the plaintext's lift and the encryption's
arithmetic are kernels (``ops/cuda_prng.py``); elsewhere they run their
plain versions here (``_uniform_plain``, ``_error_coeffs_plain``,
``_lift_centered``, ``_lift_error_plain``, ``_encrypt_from_u``).

An encryption is one schedule on every device: the plaintext's
coefficients, their lift into each Q_j with t*e added (``_lift_error``),
one forward NTT, then c0 = u - a*s (``encrypt``).  The NTT is linear mod
Q_j and every residue is canonical, so NTT(lift(pt) + t*e) - a*s is the
JAX package's m - a*s + t*NTT(e) bit for bit; the lift must stay before
the NTT, and nothing that is not linear mod Q_j may come between them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import cuda_prng
from ..ops import ntt as _ntt
from ..ops.modops import add_mod, mul_mod
from ..utils import prng
from .context import EncodingContext, SecretKey

__all__ = [
    "plain_to_inner_ntt",
    "sample_a_e",
    "encrypt",
    "decrypt_to_slots",
    "decrypt_to_slots_exact",
    "ct_add",
    "ct_mul_plain",
    "modswitch",
]

_I64 = torch.int64
_I32 = torch.int32


def _slots_to_plain_coeffs(ctx: EncodingContext, slots):
    """[*, L, n] outer slot values -> plaintext coefficients mod t_i [*, L, N']:
    the n slot values go into the first n inner slots (zero beyond), then an
    inverse negacyclic NTT mod t_i."""
    N = ctx.ring.N
    padded = torch.zeros((*slots.shape[:-1], ctx.n_inner), dtype=_I32, device=slots.device)
    padded[..., :N] = slots  # a scalar ring element (n == 1) fills every slot
    return _ntt.negacyclic_intt_nat(padded, ctx.plain_plan)


def _lift_centered(ctx: EncodingContext, pt_coeffs, level: int):
    """Centered lift of plaintext coeffs (mod t_i) into each inner limb:
    [*, L, N'] -> int64 [*, L, L'_lvl, N'];  v > t/2 maps to v - t + Q_j."""
    t = ctx.t_consts  # [L, 1, 1]
    Q = ctx.inner_consts(level)[None]  # [1, L', 1]
    v = pt_coeffs.to(_I64)[..., :, None, :]  # [*, L, 1, N']
    lifted = torch.where(v > (t >> 1), v + Q - t, v)
    # v <= t/2 may still exceed Q_j when t_i > Q_j: one conditional subtract
    return torch.where(lifted >= Q, lifted - Q, lifted)


def _scalar(ctx: EncodingContext, slots) -> bool:
    """The Z_q backend's slots (N == 1): a constant polynomial, its one
    coefficient the slot value."""
    return ctx.ring.N == 1 and slots.shape[-1] == 1


def _lift(ctx: EncodingContext, pt_coeffs, level: int):
    """`_lift_centered` as int32 [*, L, L'_lvl, I]: a CUDA context launches
    the kernel (``cuda_prng.lift``); any other runs the plain version."""
    if _on_card(ctx):
        return cuda_prng.lift(ctx, pt_coeffs, level)
    return _lift_centered(ctx, pt_coeffs, level).to(_I32)


def plain_to_inner_ntt(ctx: EncodingContext, slots, level: int = 0):
    """Outer slot values -> inner-NTT plaintext operand int32[*, L, L'_lvl, N'].

    Scalar fast path (N == 1, the Z_q backend): the value is encoded as the
    constant polynomial, whose NTT form is the constant itself — no
    transforms; the lift's [*, L, L', 1] is expanded over N' (stride 0).
    """
    if _scalar(ctx, slots):
        lifted = _lift(ctx, slots, level)  # [*, L, L', 1]
        return lifted.expand(*lifted.shape[:-1], ctx.n_inner)
    lifted = _lift(ctx, _slots_to_plain_coeffs(ctx, slots), level)
    return _ntt.negacyclic_ntt_rev(lifted, ctx.inner_plan(level))


def _cbd_k(stddev: float) -> int:
    """Centered-binomial parameter with variance k/2 >= stddev^2."""
    return max(1, int(np.ceil(2.0 * stddev * stddev)))


def _popcount32(v):
    """SWAR popcount of int64 values in [0, 2^32) (torch has no popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _on_card(ctx: EncodingContext) -> bool:
    return torch.device(ctx.device).type == "cuda"


def _sample_error_coeffs(ctx: EncodingContext, key, batch_shape, rows=None):
    """Centered-binomial error, k = ceil(2 sigma^2) (21 at sigma = 3.2), as
    the JAX package's `_sample_error_ntt` draws it: words
    ``bits(key, (2, n_words, *batch, L, N'))``, the last word masked to the
    remaining bits, popcounts summed per side, side 0 minus side 1.
    Returns its residues per inner limb, int32 [*, L, L', N'] (coefficient
    form).  A CUDA context launches the kernel; any other runs
    `_error_coeffs_plain`."""
    if _on_card(ctx):
        return cuda_prng.cbd_error(ctx, key, batch_shape, rows, _cbd_k(ctx.error_stddev))
    return _error_coeffs_plain(ctx, key, batch_shape, rows)


def _error_coeffs_plain(ctx: EncodingContext, key, batch_shape, rows=None):
    """`_sample_error_coeffs` as torch ops on the context's device."""
    k = _cbd_k(ctx.error_stddev)
    n_words = -(-k // 32)
    shape = (2, n_words, *batch_shape, ctx.L, ctx.n_inner)
    u = prng.bits_plain(key, shape, ctx.device, rows=rows, axis=2)
    last_mask = (1 << (k - 32 * (n_words - 1))) - 1
    pops = sum(_popcount32(u[:, w] & (0xFFFFFFFF if w < n_words - 1 else last_mask))
               for w in range(n_words))
    e = pops[0] - pops[1]  # [*, L, N']
    Q = ctx.inner_consts(0)  # [L', 1]
    e_ = e[..., :, None, :]  # [*, L, 1, N']
    return torch.where(e_ < 0, e_ + Q, e_).to(_I32)


def _sample_uniform(ctx: EncodingContext, key, batch_shape, rows=None):
    """Uniform element of R_Q in NTT form: per inner prime Q_j, uint32
    ``randint(split(key, L')[j], (*batch, L, N'), 0, Q_j)``.  A CUDA
    context launches the kernel; any other runs `_uniform_plain`."""
    if _on_card(ctx):
        return cuda_prng.uniform(ctx, key, batch_shape, rows)
    return _uniform_plain(ctx, key, batch_shape, rows)


def _uniform_plain(ctx: EncodingContext, key, batch_shape, rows=None):
    """`_sample_uniform` as torch ops on the context's device."""
    shape = (*batch_shape, ctx.L, ctx.n_inner)
    cols = [
        prng.randint_plain(k, shape, Q, ctx.device, rows=rows).to(_I32)
        for k, Q in zip(prng.split(key, ctx.L_inner), ctx.inner_primes)
    ]
    return torch.stack(cols, dim=-2)  # [*, L, L', N']


def sample_a_e(ctx: EncodingContext, key, batch_shape, rows=None):
    """(a, e) for encryption with `key`: ``k_a, k_e = split(key)``, uniform
    a from k_a and the NTT form of the CBD error from k_e.  `rows` limits
    both to a row range of the leading batch axis."""
    k_a, k_e = prng.split(key)
    a = _sample_uniform(ctx, k_a, batch_shape, rows)
    e = _ntt.negacyclic_ntt_rev(_sample_error_coeffs(ctx, k_e, batch_shape, rows),
                                ctx.inner_plan(0))
    return a, e


def _lift_error(ctx: EncodingContext, pt, key, batch_shape, rows=None):
    """u = lift(pt) + t * e mod Q_j at level 0, int32 [*, L, L', N'], for
    the centred-binomial error `_sample_error_coeffs(ctx, key, batch_shape,
    rows)`; `pt` is [*, L, N'] or the Z_q slots [*, L, 1] (coefficient 0).
    A CUDA context launches the kernel, which draws the error in its
    registers (``cuda_prng.lift_error``); any other runs
    `_lift_error_plain`."""
    if _on_card(ctx):
        return cuda_prng.lift_error(ctx, pt, key, batch_shape, rows, _cbd_k(ctx.error_stddev))
    return _lift_error_plain(ctx, pt, key, batch_shape, rows)


def _lift_error_plain(ctx: EncodingContext, pt, key, batch_shape, rows=None):
    """`_lift_error` as int64 torch ops on the context's device:
    `_lift_centered` + t * `_error_coeffs_plain` mod Q_j."""
    lifted = _lift_centered(ctx, pt, 0)
    if lifted.shape[-1] != ctx.n_inner:  # the Z_q slot: zero past coefficient 0
        lifted = torch.nn.functional.pad(lifted, (0, ctx.n_inner - lifted.shape[-1]))
    e = _error_coeffs_plain(ctx, key, batch_shape, rows).to(_I64)
    return torch.remainder(lifted + e * ctx.t_mod_Q, ctx.inner_consts(0)).to(_I32)


def _encrypt_from_u(ctx: EncodingContext, s_ntt, u, a):
    """c1 = a,  c0 = u - a*s  (mod Q_j), all in inner-NTT form, from u =
    NTT(lift(m) + t*e): the encryption kernel's plain version."""
    Q = ctx.inner_consts(0)
    c0 = torch.remainder(u.to(_I64) - a.to(_I64) * s_ntt.to(_I64), Q)
    return c0.to(_I32), a


def encrypt(ctx: EncodingContext, sk: SecretKey, slots, key, draw_rows=None, lo: int = 0,
            c0_out=None):
    """Symmetric BGV encryption of a batch of outer-slot vectors.

    slots: int32[*batch, L, n] -> (c0, c1): int32[*batch, L, L', N'] with
    c0 + c1*s = m + t*e (mod Q).  With `draw_rows`, `slots` are rows
    ``[lo, lo + len(slots))`` of a batch of `draw_rows` rows encrypted with
    `key`: they get the randomness those rows get in the whole batch.
    ``k_a, k_e = split(key)``: the plaintext's coefficients are lifted with
    t*e added (`_lift_error`, the error from k_e), taken to inner-NTT form
    by one forward NTT, and c0 = u - a*s for the uniform a of k_a.  With
    `c0_out` (a contiguous int32 tensor of c0's shape), c0 is written there
    and c1 is neither written nor returned: ``(c0_out, None)``.  Each step
    launches its kernel on a CUDA device and runs its plain version on any
    other.
    """
    batch, rows = ((slots.shape[:-2], None) if draw_rows is None
                   else ((draw_rows,), (lo, lo + slots.shape[0])))
    k_a, k_e = prng.split(key)
    pt = slots if _scalar(ctx, slots) else _slots_to_plain_coeffs(ctx, slots)
    u = _ntt.negacyclic_ntt_rev(_lift_error(ctx, pt, k_e, batch, rows), ctx.inner_plan(0))
    if _on_card(ctx):
        return cuda_prng.encrypt(ctx, sk, u, k_a, batch, rows, c0_out)
    c0, c1 = _encrypt_from_u(ctx, sk.s_ntt, u, _uniform_plain(ctx, k_a, batch, rows))
    return (c0, c1) if c0_out is None else (c0_out.copy_(c0), None)


def ct_add(ctx: EncodingContext, ct_a, ct_b, level: int):
    Q = ctx.inner_consts(level)
    return add_mod(ct_a[0], ct_b[0], Q), add_mod(ct_a[1], ct_b[1], Q)


def ct_mul_plain(ctx: EncodingContext, ct, slots, level: int):
    """ct * plain(slot values) — pointwise in NTT form."""
    pt = plain_to_inner_ntt(ctx, slots, level)
    Q = ctx.inner_consts(level)
    return mul_mod(ct[0], pt, Q), mul_mod(ct[1], pt, Q)


def modswitch(ctx: EncodingContext, ct, level: int):
    """Drop the last inner limb: (c - d)/Q_last with d ≡ c (mod Q_last),
    d ≡ 0 (mod t_i), |d| small.  Returns the ciphertext at level + 1; the
    plaintext is scaled by Q_last^{-1} mod t_i (undone at decode)."""
    primes = ctx.level_primes(level)
    Q_last = primes[-1]
    dev = ct[0].device
    t = torch.as_tensor(ctx.t_np.astype(np.int64), device=dev)[:, None]  # [L, 1]
    qinv_t = torch.tensor([pow(Q_last, -1, int(t_i)) for t_i in ctx.ring.primes],
                          dtype=_I64, device=dev)[:, None]
    Qs = ctx.inner_consts(level + 1)  # [L'-1, 1]
    qlast_inv = torch.tensor([pow(Q_last, -1, Q) for Q in primes[:-1]],
                             dtype=_I64, device=dev)[:, None]
    out = []
    for comp in ct:
        coeffs = _ntt.negacyclic_intt_nat(comp, ctx.inner_plan(level))  # [*, L, L', N']
        r = coeffs[..., -1, :].to(_I64)  # [*, L, N'] mod Q_last
        r_c = torch.where(r > (Q_last >> 1), r - Q_last, r)  # centered
        u = torch.remainder(torch.remainder(-r_c, t) * qinv_t, t)
        u_c = torch.where(u > (t >> 1), u - t, u)
        d = r_c + Q_last * u_c  # |d| <= Q_last*(t+1)/2 — fits int64
        num = torch.remainder(coeffs[..., :-1, :].to(_I64) - d[..., None, :], Qs)
        scaled = torch.remainder(num * qlast_inv, Qs).to(_I32)
        out.append(_ntt.negacyclic_ntt_rev(scaled, ctx.inner_plan(level + 1)))
    return tuple(out)


def _ct_s_coeffs(ctx: EncodingContext, s_ntt, c0, c1, level: int):
    """Coefficient form of c0 + c1*s at the given level: [*, L, L'_lvl, N']."""
    Q = ctx.inner_consts(level)
    s = s_ntt[..., : len(ctx.level_primes(level)), :]
    cts = add_mod(c0, mul_mod(c1, s, Q), Q)
    return _ntt.negacyclic_intt_nat(cts, ctx.inner_plan(level))


def decrypt_to_slots(ctx: EncodingContext, sk: SecretKey, ct, level: int):
    """Decrypt -> (slot values int32[*, L, N'], noise budget bits int64[*, L]).

    RNS decryption with a float64 CRT, as ``_decrypt_device`` in the JAX
    package:  c(s) = sum_j y_j (Q/Q_j) - v Q  with  y_j = c_j (Q/Q_j)^-1 mod
    Q_j  and  v = round(sum_j y_j / Q_j).  The float sum reproduces the
    roundings of the JAX package's jitted CPU program (see `_crt_fraction`),
    so the slots and the budget integers agree exactly.
    """
    return _decrypt_device(ctx, sk.s_ntt, ct[0], ct[1], level)


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp split of float64 a into two halves of <= 26 significant bits."""
    f = a * 134217729.0  # 2^27 + 1
    hi = f - (f - a)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e) with p = fl(a * b) and p + e = a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _budget_bits(absr):
    """floor(-1 - log2(max(absr, 2^-62))) as the JAX package's jitted CPU
    program rounds it: log2(x) = log(x) * fl(1/ln 2), and -1 - that product
    is one fused multiply-add.  The fma is emulated with an exact product
    (`_two_prod`) and TwoSums (exact except in a tie of the last rounding)."""
    lg = torch.log(torch.clamp(absr, min=2.0**-62))
    p, e = _two_prod(-lg, torch.full_like(lg, 1.0 / math.log(2.0)))
    s, e1 = _two_sum(torch.full_like(lg, -1.0), p)
    t, _ = _two_sum(e1, e)
    return torch.floor(s + t).to(_I64)


def _reciprocal_parts(q: int) -> tuple[float, float, float]:
    """fl(1/q) split exactly into three parts of <= 22 significant bits, so
    that y * part is exact in float64 for any y < 2^31."""
    f, E = math.frexp(1.0 / q)  # 1/q = f * 2^E, f in [0.5, 1)
    M = int(f * (1 << 53))  # 53-bit integer mantissa: fl(1/q) = M * 2^(E-53)
    return (math.ldexp(M >> 31, E - 22),
            math.ldexp((M >> 9) & ((1 << 22) - 1), E - 44),
            math.ldexp(M & 511, E - 53))


def _crt_fraction(y, primes):
    """sum_j y_j / Q_j in float64, rounded as the JAX package's jitted CPU
    program rounds it: XLA turns y / Q_j into y * fl(1/Q_j) and fuses the
    running sum into multiply-adds, acc = fma(y_j, fl(1/Q_j), acc).

    torch has no float64 fma, so each one is emulated exactly: y_j * fl(1/Q_j)
    is the exact sum of three float64 products (`_reciprocal_parts`), and
    acc + those three is accumulated exactly as a double-double with
    TwoSum; its high word is then the correctly rounded fma.  (Every term
    is a multiple of 2^(E-53) below 2^(log2 L' + 2), so the exact sum fits
    the double-double's 106 bits.)
    """
    for q in primes:
        assert q < (1 << 31), q
    yf = y.to(torch.float64)
    acc = yf[..., 0, :] * (1.0 / primes[0])
    for j in range(1, len(primes)):
        hi, lo = acc, torch.zeros_like(acc)
        for part in _reciprocal_parts(primes[j]):
            s, e = _two_sum(hi, yf[..., j, :] * part)
            hi, lo = _two_sum(s, e + lo)
        acc = hi
    return acc


def _decrypt_device(ctx: EncodingContext, s_ntt, c0, c1, level: int):
    primes = ctx.level_primes(level)
    coeffs = _ct_s_coeffs(ctx, s_ntt, c0, c1, level)  # [*, L, L', N']
    dev = coeffs.device
    Q = math.prod(primes)
    inv = torch.tensor([pow(Q // qj, -1, qj) for qj in primes], dtype=_I64,
                       device=dev)[:, None]
    y = torch.remainder(coeffs.to(_I64) * inv, ctx.inner_consts(level))

    # v = round(sum_j y_j / Q_j); frac = sum - v in [-0.5, 0.5)
    fr = _crt_fraction(y, primes)
    v = torch.round(fr)
    resid = fr - v

    # noise budget: log2((Q/2) / |c(s)|) = -1 - log2(max |resid|)
    budget = _budget_bits(resid.abs().amax(dim=-1))  # [*, L]

    # centered(c(s)) mod t = sum_j y_j*(Q/Q_j mod t) - v*(Q mod t)  (mod t)
    t_list = [int(t) for t in ctx.t_np]
    t = torch.tensor(t_list, dtype=_I64, device=dev)  # [L]
    Mj_mod_t = torch.tensor([[(Q // qj) % ti for qj in primes] for ti in t_list],
                            dtype=_I64, device=dev)  # [L, L']
    Q_mod_t = torch.tensor([Q % ti for ti in t_list], dtype=_I64, device=dev)
    acc = torch.remainder(y * Mj_mod_t[:, :, None], t[:, None, None]).sum(dim=-2)
    v_term = torch.remainder(v.to(_I64) * Q_mod_t[:, None], t[:, None])
    m = torch.remainder(acc + t[:, None] - v_term, t[:, None])

    # undo the modswitch correction factor
    corr = ctx.correction_factor(level)
    inv_corr = torch.tensor([pow(int(c), -1, ti) for c, ti in zip(corr, t_list)],
                            dtype=_I64, device=dev)
    m = torch.remainder(m * inv_corr[:, None], t[:, None]).to(_I32)
    return _ntt.negacyclic_ntt_rev(m, ctx.plain_plan), budget


def decrypt_to_slots_exact(ctx: EncodingContext, sk: SecretKey, ct, level: int):
    """Big-integer oracle of `decrypt_to_slots`, on the host: c(s) composed
    by CRT in Python integers and centred, the budget floor(log2((Q/2) /
    |c(s)|_inf)) in exact integers, the message c(s) mod t with the
    modswitch correction undone.  Returns the same (slots, budget) tensors,
    on the ciphertext's device; exact by construction, so it checks the
    float64 CRT of the device decode."""
    primes = ctx.level_primes(level)
    coeffs = _ct_s_coeffs(ctx, sk.s_ntt, ct[0], ct[1], level)
    dev = coeffs.device
    coeffs = coeffs.cpu().numpy()  # [*, L, L', N'] residues
    Q = math.prod(primes)
    comp = np.zeros(coeffs.shape[:-2] + coeffs.shape[-1:], dtype=object)
    for j, qj in enumerate(primes):
        Mj = Q // qj
        comp += coeffs[..., j, :].astype(object) * (Mj * pow(Mj, -1, qj))
    comp %= Q
    centered = np.where(comp > Q // 2, comp - Q, comp)
    absmax = np.abs(centered).max(axis=-1)  # [*, L], Python ints
    budget = np.array([((Q // 2) // max(int(x), 1)).bit_length() - 1 for x in absmax.flat],
                      dtype=np.int64).reshape(absmax.shape)
    t = ctx.t_np.astype(object)[:, None]  # [L, 1]
    inv_corr = np.array([pow(int(c), -1, int(ti)) for c, ti in
                         zip(ctx.correction_factor(level), ctx.ring.primes)], dtype=object)
    m = (centered % t) * inv_corr[:, None] % t  # [*, L, N'] in [0, t)
    m = torch.from_numpy(m.astype(np.int64).astype(np.int32)).to(dev)
    return _ntt.negacyclic_ntt_rev(m, ctx.plain_plan), torch.from_numpy(budget).to(dev)
