"""The noise planner of ringsnark_tpu_torch (``encoding/noise.py``) against
the JAX package's, and ``tests/test_noise.py``'s four tests on the port:

* ``plan_inner_chain``, ``required_inner_limbs``, ``inner_product_noise_bits``
  and ``budget_after_inner_product`` equal the JAX module on every shape that
  ``chip_smoke.py`` plans: the squaring chain at N'=16384 (margin 10) for
  its M+1 terms, and each reference circuit's
  ``plan_inner_chain(N', 31, max(4*nf+8, N+2, logT+2))``;
* the estimator is monotonic in the terms, the planner's chains are
  reasonable, ``floor_limbs`` sets the final level, and the measured budget
  after an inner product (the exact big-integer decode) is at least the
  model's floor, at small N.
"""

import numpy as np
import pytest

from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import noise as jnoise
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu_torch.encoding import EncodingContext, decode, encode, inner_product, keygen
from ringsnark_tpu_torch.encoding.bgv import decrypt_to_slots, decrypt_to_slots_exact
from ringsnark_tpu_torch.encoding.noise import (
    budget_after_inner_product,
    inner_product_noise_bits,
    plan_inner_chain,
    required_inner_limbs,
)
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.utils import prng

# chip_smoke.py's plans: (N, N', terms, margin, L)
SQUARING_CHAIN = [(8192, 16384, (1 << k) + 1, 10, 1) for k in (14, 16, 18)] + [
    (256, 512, (1 << k) + 1, 10, 1) for k in (6, 8, 9, 11)]  # its small configurations
REFERENCE_CIRCUITS = {  # (N, N', logT, features) of chip_smoke.REFERENCE_CIRCUITS
    "plaintext_check": (2048, 16384, 32, 32),
    "ct_mul": (8192, 16384, 16, 32),
    "incircuit_ntt": (4096, 16384, 16, 32),
    "logreg": (2048, 16384, 16, 256),
}
SHAPES = SQUARING_CHAIN + [
    (N, n_inner, max(4 * nf + 8, N + 2, log_t + 2), None, 2)
    for N, n_inner, log_t, nf in REFERENCE_CIRCUITS.values()]


def _contexts(N, n_inner, L, L_inner, floor):
    """The JAX and the port's EncodingContext over the same primes, with the
    inner chain chip_smoke.py picks."""
    jring = jdefault_context(L=L, N=N, order=max(1 << 14, 2 * n_inner, 4 * N))
    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in jring.primes:
            inner.append(c)
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    return (JEncodingContext(ring=jring, n_inner=n_inner, inner_primes=tuple(inner),
                             floor_limbs=floor),
            EncodingContext(ring=tring, n_inner=n_inner, inner_primes=tuple(inner),
                            floor_limbs=floor))


@pytest.mark.parametrize("N,n_inner,terms,margin,L", SHAPES)
def test_planner_equals_jax_on_the_chip_smoke_shapes(N, n_inner, terms, margin, L):
    kw = {} if margin is None else {"margin_bits": margin}
    plan = plan_inner_chain(n_inner, 31, terms, dense=N > 1, **kw)
    assert plan == jnoise.plan_inner_chain(n_inner, 31, terms, dense=N > 1, **kw)
    assert (required_inner_limbs(n_inner, 31, terms, **kw)
            == jnoise.required_inner_limbs(n_inner, 31, terms, **kw))
    jectx, ectx = _contexts(N, n_inner, L, *plan)
    for n in (terms, 2, 4 * terms):
        assert inner_product_noise_bits(ectx, n) == jnoise.inner_product_noise_bits(jectx, n)
        assert budget_after_inner_product(ectx, n) == jnoise.budget_after_inner_product(jectx, n)
    assert budget_after_inner_product(ectx, terms) > 0


def _ectx(floor=2, L_inner=4):
    ring = RingContext(primes=jdefault_context(L=2, N=16, order=1 << 12).primes, N=16,
                       device="cpu")
    inner, below = [], 1 << 31
    while len(inner) < L_inner:
        c = find_ntt_primes(1, 64, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    return EncodingContext(ring=ring, n_inner=32, inner_primes=tuple(inner), floor_limbs=floor)


def test_estimator_monotonic_in_terms():
    # sum-then-switch: the post-switch noise does not fall with the terms; at
    # level 0 (floor = L_inner, no switch) it rises strictly
    e = _ectx()
    assert inner_product_noise_bits(e, 1024) >= inner_product_noise_bits(e, 16)
    e0 = _ectx(floor=4)
    assert inner_product_noise_bits(e0, 1024) > inner_product_noise_bits(e0, 16)
    assert budget_after_inner_product(e0, 16) > budget_after_inner_product(e0, 1024)


def test_plan_inner_chain_reasonable():
    l, floor = plan_inner_chain(16384, 31, 1 << 14)
    assert 2 <= floor < l <= 14
    l2, floor2 = plan_inner_chain(16384, 31, 1 << 18)  # the north star
    assert floor2 >= floor and l2 >= l
    assert required_inner_limbs(16384, 31, 1 << 14) == l


def test_floor_limbs_controls_final_level():
    rng = np.random.default_rng(0)
    for floor in (2, 3):
        e = _ectx(floor=floor)
        _, sk = keygen(e, rng)
        msgs = RingElem.stack([RingElem.random_element(e.ring, rng) for _ in range(6)])
        coefs = RingElem.stack([RingElem.random_element(e.ring, rng) for _ in range(6)])
        res = inner_product(encode(e, sk, msgs, prng.key(floor)), coefs)
        assert res.level == e.L_inner - floor
        want = RingElem.zero(e.ring)
        for i in range(6):
            want = want + msgs[i] * coefs[i]
        assert decode(e, sk, res) == want.broadcast_to_poly()


@pytest.mark.parametrize("N,B,L_inner", [(1, 512, 3), (16, 256, 4)])
def test_empirical_noise_within_planner_floor(N, B, L_inner):
    """The measured (exact big-integer) budget after a B-term inner product
    is at least the worst-case model's, the planner's chain decodes, and the
    float64 decode equals the exact one at stressed noise."""
    n_inner = 64
    li, floor = plan_inner_chain(n_inner, 31, B, dense=N > 1)
    L_use = max(li, L_inner)  # a chain the planner itself would emit
    ring = RingContext(primes=jdefault_context(L=1, N=N, order=4 * n_inner).primes, N=N,
                       device="cpu")
    inner, below = [], 1 << 31
    while len(inner) < L_use:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in ring.primes:
            inner.append(c)
    ectx = EncodingContext(ring=ring, n_inner=n_inner, inner_primes=tuple(inner),
                           floor_limbs=floor)
    rng = np.random.default_rng(B + N)
    _, sk = keygen(ectx, rng)

    def batch():
        return np.stack([rng.integers(0, p, (B, N), dtype=np.uint64) for p in ring.primes],
                        axis=1).astype(np.uint32)

    m, c = batch(), batch()
    res = inner_product(encode(ectx, sk, RingElem(ring, ring.tensor(m)), prng.key(B)),
                        RingElem(ring, ring.tensor(c)))
    slots, budget = decrypt_to_slots(ectx, sk, (res.c0, res.c1), res.level)
    xslots, xbudget = decrypt_to_slots_exact(ectx, sk, (res.c0, res.c1), res.level)
    assert (slots == xslots).all()
    assert ((budget - xbudget).abs() <= 1).all()
    assert (xbudget > 0).all()
    assert (xbudget.numpy() >= np.floor(budget_after_inner_product(ectx, B))).all()
    got = decode(ectx, sk, res).res.numpy()
    for l, p in enumerate(ring.primes):
        want = (m[:, l].astype(np.uint64) * c[:, l] % p).sum(axis=0) % p
        assert np.array_equal(got[l, :N].astype(np.uint64), want)
