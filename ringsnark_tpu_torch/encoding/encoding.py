"""The Encoding API: E(.) with encode/decode/add/mul-by-ring/inner_product.

Port of ``ringsnark_tpu/encoding/encoding.py``.  A "vector of encodings" is
one `Encoding` with a leading batch axis.
"""

from __future__ import annotations

import math

import torch

from ..rings.elem import RingElem
from ..utils import prng
from . import bgv
from .context import EncodingContext, SecretKey
from .mac import mac_rows

__all__ = ["Encoding", "DecodingError", "encode", "decode", "inner_product", "mac_accumulate",
           "finish_inner_product"]

# Batch rows per chunk of the inner-product MAC: chunks hold this many
# residues, so each chunk's plaintext operand is 64 MiB of int32 (256 rows
# at L = 1, L' = 4, N' = 16384).
_CHUNK_ELEMS = 1 << 24
# Rows per randomness chunk of `encode`: the JAX package's default
# (``RINGSNARK_ENCODE_CHUNK_ELEMS`` = 2^22 residues, at least 8 rows).
# Chunk i draws from ``fold_in(key, i)``, so this sets the ciphertexts.
_ENCODE_CHUNK_ELEMS = 1 << 22


def _chunk_rows(ctx: EncodingContext, limbs: int) -> int:
    return max(1, _CHUNK_ELEMS // (ctx.L * limbs * ctx.n_inner))


class DecodingError(Exception):
    """Noise budget exhausted (reference `decoding_error`)."""


class Encoding:
    """A batch of encodings: ciphertext components int32[*batch, L, L'_lvl, N'].

    `level` counts modswitches applied; the implied plaintext correction
    factor lives in `EncodingContext.correction_factor(level)`.
    """

    __slots__ = ("ctx", "c0", "c1", "level")

    def __init__(self, ctx: EncodingContext, c0, c1, level: int = 0):
        self.ctx = ctx
        self.c0 = c0
        self.c1 = c1
        self.level = level

    @property
    def batch_shape(self):
        return tuple(self.c0.shape[:-3])

    def __len__(self):
        assert self.batch_shape
        return self.c0.shape[0]

    def __getitem__(self, idx):
        return Encoding(self.ctx, self.c0[idx], self.c1[idx], self.level)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def is_zero_ct(self) -> bool:
        """Transparent-zero check (host)."""
        return not (bool(self.c0.any()) or bool(self.c1.any()))

    def __add__(self, other: "Encoding") -> "Encoding":
        assert self.ctx == other.ctx
        a, b = self, other
        while a.level < b.level:
            a = a.modswitch()
        while b.level < a.level:
            b = b.modswitch()
        c0, c1 = bgv.ct_add(a.ctx, (a.c0, a.c1), (b.c0, b.c1), a.level)
        return Encoding(a.ctx, c0, c1, a.level)

    def __mul__(self, r) -> "Encoding":
        """Encoding * RingElem (ciphertext-plaintext multiply)."""
        assert isinstance(r, RingElem)
        c0, c1 = bgv.ct_mul_plain(self.ctx, (self.c0, self.c1), r.res, self.level)
        return Encoding(self.ctx, c0, c1, self.level)

    __rmul__ = __mul__

    def modswitch(self) -> "Encoding":
        assert self.level + 1 < self.ctx.L_inner, "no more limbs to drop"
        c0, c1 = bgv.modswitch(self.ctx, (self.c0, self.c1), self.level)
        return Encoding(self.ctx, c0, c1, self.level + 1)

    def sum_batch(self) -> "Encoding":
        """Sum over the leading batch axis, in int64 (exact: every term is
        < 2^31 and a batch has < 2^32 rows), reduced once."""
        Q = self.ctx.inner_consts(self.level)
        c0, c1 = (torch.remainder(c.to(torch.int64).sum(0), Q).to(torch.int32)
                  for c in (self.c0, self.c1))
        return Encoding(self.ctx, c0, c1, self.level)

    def __eq__(self, other):
        if not isinstance(other, Encoding):
            return NotImplemented
        return (
            self.level == other.level
            and torch.equal(self.c0, other.c0)
            and torch.equal(self.c1, other.c1)
        )

    def size_in_bits(self) -> int:
        return self.ctx.size_in_bits(math.prod(self.batch_shape), self.level)

    @classmethod
    def zero(cls, ctx: EncodingContext, batch_shape=(), level: int = 0) -> "Encoding":
        """The transparent-zero encoding (a valid encryption of 0 with zero
        noise), on the context's device."""
        shape = (*batch_shape, ctx.L, ctx.L_inner - level, ctx.n_inner)
        z = torch.zeros(shape, dtype=torch.int32, device=ctx.device)
        return cls(ctx, z, z, level)


def encode(ctx: EncodingContext, sk: SecretKey, rs: RingElem, key) -> Encoding:
    """Encrypt a RingElem batch ([B, L, n] slots) under the per-limb keys.

    The JAX package's chunking, which fixes the randomness: a batch of at
    most `chunk` rows is encrypted with `key` itself; a larger one in
    chunks of `chunk` rows (the last one short), chunk i with
    ``fold_in(key, i)`` as a draw of `chunk` rows.  `key` is a threefry key
    (``utils/prng.py``)."""
    slots = rs.broadcast_to_poly().res
    if slots.ndim < 3:  # single element [L, n]
        c0, c1 = bgv.encrypt(ctx, sk, slots, key)
        return Encoding(ctx, c0, c1, 0)
    B = slots.shape[0]
    chunk = max(8, _ENCODE_CHUNK_ELEMS // (ctx.L * ctx.L_inner * ctx.n_inner))
    if B <= chunk:
        c0, c1 = bgv.encrypt(ctx, sk, slots, key)
        return Encoding(ctx, c0, c1, 0)
    shape = (B, ctx.L, ctx.L_inner, ctx.n_inner)
    c0 = torch.empty(shape, dtype=torch.int32, device=ctx.device)
    c1 = torch.empty(shape, dtype=torch.int32, device=ctx.device)
    for i, lo in enumerate(range(0, B, chunk)):
        c0[lo:lo + chunk], c1[lo:lo + chunk] = bgv.encrypt(
            ctx, sk, slots[lo:lo + chunk], prng.fold_in(key, i), draw_rows=chunk
        )
    return Encoding(ctx, c0, c1, 0)


def decode(ctx: EncodingContext, sk: SecretKey, e: Encoding) -> RingElem:
    """Decrypt one encoding back to a RingElem (noise-budget checked): budget
    <= 0 raises DecodingError; the all-zero ciphertext decodes to zero."""
    slots, budget = bgv.decrypt_to_slots(ctx, sk, (e.c0, e.c1), e.level)
    if not e.is_zero_ct() and bool((budget <= 0).any()):
        raise DecodingError(f"noise budget exhausted: min budget {int(budget.min())} <= 0")
    return RingElem(ctx.ring, slots[..., : ctx.ring.N])


def mac_accumulate(a: Encoding, b: RingElem):
    """The exact int64 sums sum_i E_i * r_i over the leading batch axis,
    before the final reduction: in row chunks, each chunk's plaintexts go to
    inner-NTT form and `mac.mac_rows` adds their products (each reduced mod
    Q_j before the int64 sum), so any partition of the rows sums to the same
    bits."""
    ctx = a.ctx
    B = len(a)
    assert b.res.shape[0] == B
    acc0 = torch.zeros(a.c0.shape[1:], dtype=torch.int64, device=a.c0.device)
    acc1 = torch.zeros_like(acc0)
    chunk = _chunk_rows(ctx, ctx.L_inner - a.level)
    for lo in range(0, B, chunk):
        pt = bgv.plain_to_inner_ntt(ctx, b.res[lo:lo + chunk], a.level)
        mac_rows(ctx, a.level, a.c0[lo:lo + chunk], a.c1[lo:lo + chunk], [pt], [(acc0, acc1)])
    return acc0, acc1


def finish_inner_product(ctx: EncodingContext, accs, level: int = 0,
                         use_modswitch: bool = True) -> Encoding:
    """The sums of `mac_accumulate` reduced mod Q_j, then switched down
    ``L_inner - floor_limbs`` times (at least `floor_limbs` >= 2 limbs
    remain for noise headroom)."""
    Q = ctx.inner_consts(level)
    acc = Encoding(ctx, *(torch.remainder(a, Q).to(torch.int32) for a in accs), level)
    if use_modswitch:
        for _ in range(max(ctx.L_inner - ctx.floor_limbs, 0)):
            acc = acc.modswitch()
    return acc


def inner_product(a: Encoding, b: RingElem, use_modswitch: bool = True) -> Encoding:
    """sum_i E_i * r_i over the leading batch axis, then switch the sum down.

    The sum-then-switch schedule of the JAX package: the whole batch is
    multiply-accumulated at its level (`mac_accumulate`) and only the final
    sum is switched down to the floor (`finish_inner_product`), so the
    result equals the JAX package's bit for bit.
    """
    return finish_inner_product(a.ctx, mac_accumulate(a, b), a.level, use_modswitch)
