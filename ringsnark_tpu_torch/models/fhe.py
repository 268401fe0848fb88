"""Minimal outer-level symmetric BGV over ring elements.

The vFHE workloads prove statements ABOUT ciphertexts of an outer FHE scheme
whose ciphertext components live in R_q — i.e. they are `RingElem`s.  The
reference uses SEAL for this outer scheme (e.g.
`benchmarks/bench_mul_SEAL.cpp:56-86`); here a self-contained implementation
over the ring layer (port of ``ringsnark_tpu/models/fhe.py``), used to
generate authentic circuit values and for the FHE-side comparison points
(`bench_logistic_regression_inference.cpp:277-313`).

All host randomness comes from the one numpy `rng`, in the JAX package's
call order (the secret, then per `encrypt` the uniform `a` and the error),
so one seed gives the same ciphertexts in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rings.context import RingContext
from ..rings.elem import RingElem
from ..utils import prng

__all__ = ["OuterBGV"]


class OuterBGV:
    """Symmetric BGV with plaintext modulus T over the ring context's R_q.

    Ciphertexts are tuples of RingElems in slot form (matching SEAL's
    is_ntt_form invariant).  No relinearization: ct*ct yields 3 components,
    exactly what the ct-mul circuit proves.
    """

    def __init__(self, ctx: RingContext, log_t: int, rng: np.random.Generator):
        assert ctx.N > 1, "outer BGV needs a polynomial ring"
        self.ctx = ctx
        self.T = 1 << log_t
        self.rng = rng
        # ternary secret
        s_coeffs = rng.integers(-1, 2, size=ctx.N).astype(np.int64)
        self.s_coeffs = s_coeffs
        arr = np.stack([(s_coeffs % p).astype(np.uint32) for p in ctx.primes])
        self.s = RingElem.from_coeffs(ctx, arr)

    def _small_poly(self, bound: int) -> tuple[RingElem, np.ndarray]:
        c = self.rng.integers(-bound, bound + 1, size=self.ctx.N).astype(np.int64)
        arr = np.stack([(c % p).astype(np.uint32) for p in self.ctx.primes])
        return RingElem.from_coeffs(self.ctx, arr), c

    def encrypt(self, m_coeffs: list[int]) -> tuple[RingElem, RingElem]:
        """Encrypt an integer-coefficient plaintext (< T): (c0, c1)."""
        assert all(0 <= int(v) < self.T for v in m_coeffs)
        ctx = self.ctx
        a = RingElem.random_element(ctx, self.rng)
        e, _ = self._small_poly(6)
        m = RingElem.from_int_coeffs(ctx, m_coeffs)
        c0 = -(a * self.s) + RingElem.scalar(ctx, self.T) * e + m
        return c0, a

    def encrypt_batch(self, m_coeffs, key=None) -> tuple[RingElem, RingElem]:
        """Encrypt B plaintexts at once: [B, N] integers < T (numpy or a
        tensor) -> (c0, c1) RingElem batches [B, L, N].

        One batched NTT and one pass of arithmetic instead of B per-element
        pipelines.  With `key` (a threefry key, ``utils/prng.py``) the a/e
        randomness is drawn on the device, as the JAX package draws it from
        the same key; without one it comes from the host `rng`.  The
        randomness stream differs from sequential `encrypt` calls either
        way; the distribution is identical.
        """
        ctx = self.ctx
        m_coeffs = torch.as_tensor(m_coeffs).to(device=ctx.device, dtype=torch.int64)
        B, N = m_coeffs.shape
        assert N == ctx.N
        ps = ctx.p[None]  # [1, L, 1] int64
        if key is None:
            a_res = ctx.tensor(np.stack(
                [
                    self.rng.integers(0, p, (B, N), dtype=np.int64)
                    for p in ctx.primes
                ],
                axis=1,
            ))  # [B, L, N]
            e_int = torch.from_numpy(self.rng.integers(-6, 7, size=(B, 1, N))).to(ctx.device)
        else:
            ka, ke = prng.split(key)
            cols = [
                prng.randint(k, (B, N), int(p), ctx.device)
                for k, p in zip(prng.split(ka, ctx.L), ctx.primes)
            ]
            a_res = torch.stack(cols, dim=1).to(torch.int32)
            e_int = prng.randint(ke, (B, 1, N), 7, ctx.device, minval=-6)
        e_res = torch.remainder(e_int, ps).to(torch.int32)  # [B, L, N]
        m_res = torch.remainder(m_coeffs[:, None, :], ps).to(torch.int32)
        a = RingElem(ctx, a_res)
        e = RingElem.from_coeffs(ctx, e_res)
        m = RingElem.from_coeffs(ctx, m_res)
        c0 = -(a * self.s) + RingElem.scalar(ctx, self.T) * e + m
        return c0, a

    @staticmethod
    def multiply(ct1, ct2) -> tuple[RingElem, RingElem, RingElem]:
        """(z0, z1, z2) = (x0, x1) * (y0, y1) — no relinearization."""
        x0, x1 = ct1
        y0, y1 = ct2
        return (x0 * y0, x0 * y1 + x1 * y0, x1 * y1)

    def decrypt(self, ct) -> list[int]:
        """Decrypt a 2- or 3-component ciphertext to integer coefficients."""
        ctx = self.ctx
        acc = ct[0]
        s_pow = RingElem.one(ctx)
        for comp in ct[1:]:
            s_pow = s_pow * self.s
            acc = acc + comp * s_pow
        coeffs = acc.to_coeffs().cpu().numpy().view(np.uint32)  # [L, N]
        q = ctx.q
        out = []
        for j in range(ctx.N):
            v = ctx.from_rns(coeffs[:, j])
            if v > q // 2:
                v -= q
            out.append(v % self.T)
        return out
