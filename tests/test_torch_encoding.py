"""ringsnark_tpu_torch encodings against the JAX package, on the CPU, bit
for bit: keygen from one numpy seed, encrypt with the same a and e (the
port's schedule NTT(lift + t*e) - a*s against JAX's m - a*s + t*NTT(e)),
encrypt under one key (whole batches, row ranges, one element), ct x pt,
ct + ct, modswitch, the inner product, and decode (slots and the float64
noise-budget integers); and the lift and encryption kernels replayed in
numpy against their plain versions."""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ringsnark_tpu.encoding import Encoding as JEncoding
from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.encoding import bgv as jbgv
from ringsnark_tpu.encoding import inner_product as jinner_product
from ringsnark_tpu.encoding import keygen as jkeygen
from ringsnark_tpu.ops import ntt as jntt
from ringsnark_tpu.ops.modops import add_mod, mul_mod, sub_mod
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu_torch.encoding import (
    DecodingError, Encoding, EncodingContext, decode, inner_product, keygen,
)
from ringsnark_tpu_torch.encoding import bgv
from ringsnark_tpu_torch.ops import ntt as tntt
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.utils import prng

N_INNER = 32

# jitted JAX references: one compile per shape instead of one per eager op
j_plain_to_inner_ntt = jax.jit(jbgv.plain_to_inner_ntt, static_argnums=(0, 2))
j_ntt = jax.jit(jntt.negacyclic_ntt_rev, static_argnums=1)


@partial(jax.jit, static_argnums=0)
def j_encrypt_from_m(jctx, s_ntt, m, a, e_ntt):
    """The arithmetic of the JAX package's bgv._encrypt_from_m, given a and e."""
    p, mu, b = jctx.inner_consts(0)
    As = mul_mod(a, s_ntt, p, mu, b)
    te = mul_mod(e_ntt, jctx.t_mod_Q, p, mu, b)
    return add_mod(sub_mod(m, As, p), te, p)


@partial(jax.jit, static_argnums=(0, 2, 3, 4))
def j_lift_error_ntt(jctx, pt, key_seed, batch, draw):
    """NTT(the JAX package's lift of `pt`, zero past its width) + t *
    `_sample_error_ntt` of rows `draw` of a `batch` draw under PRNGKey(key_seed)."""
    lifted = jbgv._lift_centered(jctx, pt, 0)
    lifted = jnp.pad(lifted, [(0, 0)] * 3 + [(0, jctx.n_inner - lifted.shape[-1])])
    e_ntt = jbgv._sample_error_ntt(jctx, jax.random.PRNGKey(key_seed), batch)[draw[0]:draw[1]]
    p, mu, b = jctx.inner_consts(0)
    return add_mod(jntt.negacyclic_ntt_rev(lifted, jctx.inner_plan(0)),
                   mul_mod(e_ntt, jctx.t_mod_Q, p, mu, b), p)


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))


@pytest.fixture(scope="module", params=[1, 16], ids=["Zq", "Rq"])
def pair(request):
    N = request.param
    jring = jdefault_context(L=2, N=N, order=1 << 12)
    inner, below = [], 1 << 31
    while len(inner) < 3:
        c = find_ntt_primes(1, 2 * N_INNER, below=below)[0]
        below = c
        if c not in jring.primes:
            inner.append(c)
    jctx = JEncodingContext(ring=jring, n_inner=N_INNER, inner_primes=tuple(inner))
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    tctx = EncodingContext(ring=tring, n_inner=N_INNER, inner_primes=tuple(inner))
    _, jsk = jkeygen(jctx, np.random.default_rng(42))
    _, tsk = keygen(tctx, np.random.default_rng(42))
    return jctx, jsk, tctx, tsk


def _slots(ctx, B, seed, n=None):
    rng = np.random.default_rng(seed)
    n = ctx.ring.N if n is None else n
    return np.stack(
        [np.stack([rng.integers(0, p, n, dtype=np.uint64) for p in ctx.ring.primes])
         for _ in range(B)]
    ).astype(np.uint32)  # [B, L, n]


@pytest.fixture(scope="module")
def cts(pair):
    """A batch of 4 ciphertexts made by both packages from the same a and e."""
    jctx, jsk, tctx, tsk = pair
    B = 4
    rng = np.random.default_rng(7)
    slots = _slots(jctx, B, seed=8)
    Qs = jctx.inner_primes
    a = np.stack([rng.integers(0, Q, (B, jctx.L, N_INNER), dtype=np.uint64) for Q in Qs],
                 axis=-2).astype(np.uint32)  # [B, L, L', N']
    e = rng.integers(-21, 22, (B, jctx.L, 1, N_INNER))
    e_res = (e % np.array(Qs, dtype=np.int64)[:, None]).astype(np.uint32)  # [B, L, L', N']

    m = j_plain_to_inner_ntt(jctx, jnp.asarray(slots), 0)
    e_ntt = j_ntt(jnp.asarray(e_res), jctx.inner_plan(0))
    jc0 = np.asarray(j_encrypt_from_m(jctx, jsk.s_ntt, m, jnp.asarray(a), e_ntt))

    tm = bgv.plain_to_inner_ntt(tctx, _t(slots), 0)
    assert np.array_equal(_u(tm), np.asarray(m))
    te_ntt = tntt.negacyclic_ntt_rev(_t(e_res), tctx.inner_plan(0))
    assert np.array_equal(_u(te_ntt), np.asarray(e_ntt))
    tu = tntt.negacyclic_ntt_rev(_lift_plus_te(tctx, _t(slots), e_res), tctx.inner_plan(0))
    tc0, tc1 = bgv._encrypt_from_u(tctx, tsk.s_ntt, tu, _t(a))
    return slots, (jc0, a), (tc0, tc1)


def _lift_plus_te(ctx, slots, e_res):
    """The port's u before its NTT, for a given error: the plaintext's
    coefficients (the Z_q slot at coefficient 0) lifted, plus t * e mod Q_j."""
    pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
    lifted = bgv._lift_centered(ctx, pt, 0)
    lifted = torch.nn.functional.pad(lifted, (0, ctx.n_inner - lifted.shape[-1]))
    te = torch.from_numpy(e_res.astype(np.int64)) * ctx.t_mod_Q
    return torch.remainder(lifted + te, ctx.inner_consts(0)).to(torch.int32)


def test_keygen_same_secret(pair):
    jctx, jsk, tctx, tsk = pair
    assert np.array_equal(np.asarray(jsk.s_coeffs), tsk.s_coeffs)
    assert np.array_equal(np.asarray(jsk.s_ntt), _u(tsk.s_ntt))


@pytest.mark.parametrize("scalar", [False, True], ids=["poly", "scalar"])
@pytest.mark.parametrize("level", [0, 1])
def test_plain_to_inner_ntt(pair, level, scalar):
    jctx, _, tctx, _ = pair
    slots = _slots(jctx, 3, seed=11 + level, n=1 if scalar else None)
    want = np.asarray(j_plain_to_inner_ntt(jctx, jnp.asarray(slots), level))
    got = bgv.plain_to_inner_ntt(tctx, _t(slots), level)
    assert np.array_equal(_u(got), want)


def test_encrypt_same_a_e_and_decrypt(pair, cts):
    jctx, jsk, tctx, tsk = pair
    slots, (jc0, jc1), (tc0, tc1) = cts
    assert np.array_equal(_u(tc0), jc0) and np.array_equal(_u(tc1), jc1)
    js, jb = jbgv.decrypt_to_slots(jctx, jsk, (jnp.asarray(jc0), jnp.asarray(jc1)), 0)
    ts, tb = bgv.decrypt_to_slots(tctx, tsk, (tc0, tc1), 0)
    assert np.array_equal(_u(ts), js) and np.array_equal(tb.numpy(), jb)
    assert np.array_equal(_u(ts)[..., : tctx.ring.N], slots)


ENCRYPTIONS = {  # (batch rows, draw_rows, lo)
    "whole_batch": (5, None, 0),
    "one_element": (None, None, 0),
    "rows_lo_not_0": (4, 16, 5),
    "short_last_rows": (3, 16, 13),
}


@pytest.mark.parametrize("case", list(ENCRYPTIONS))
def test_encrypt_schedule_equals_jax(pair, case):
    """The port's schedule (lift with t*e, one NTT, c0 = u - a*s), on the
    CPU's plain versions, gives the JAX package's c0 and c1 under one key:
    a whole batch and one element against `jbgv.encrypt`; rows [lo, lo + n)
    of a draw of draw_rows rows against `j_encrypt_from_m` with JAX's own a
    and e drawn for the whole draw and sliced."""
    jctx, jsk, tctx, tsk = pair
    B, draw_rows, lo = ENCRYPTIONS[case]
    slots = _slots(jctx, B or 1, seed=17 + len(case))
    slots = slots if B else slots[0]
    jkey, tkey = jax.random.PRNGKey(18), prng.key(18)
    if draw_rows is None:
        jc0, jc1 = jbgv.encrypt(jctx, jsk, jnp.asarray(slots), jkey)
        tc0, tc1 = bgv.encrypt(tctx, tsk, _t(slots), tkey)
    else:
        k_a, k_e = jax.random.split(jkey)
        hi = lo + B
        jc1 = jbgv._sample_uniform(jctx, k_a, (draw_rows,))[lo:hi]
        e_ntt = jbgv._sample_error_ntt(jctx, k_e, (draw_rows,))[lo:hi]
        m = j_plain_to_inner_ntt(jctx, jnp.asarray(slots), 0)
        jc0 = j_encrypt_from_m(jctx, jsk.s_ntt, m, jc1, e_ntt)
        tc0, tc1 = bgv.encrypt(tctx, tsk, _t(slots), tkey, draw_rows=draw_rows, lo=lo)
    assert tc0.shape == tuple(np.shape(jc0))
    assert np.array_equal(_u(tc0), np.asarray(jc0)) and np.array_equal(_u(tc1), np.asarray(jc1))
    out = torch.empty_like(tc0)
    c0, c1 = bgv.encrypt(tctx, tsk, _t(slots), tkey, draw_rows=draw_rows, lo=lo, c0_out=out)
    assert c1 is None and c0 is out and torch.equal(c0, tc0)


def test_ct_mul_plain_and_add(pair, cts):
    jctx, _, tctx, _ = pair
    _, (jc0, jc1), (tc0, tc1) = cts
    pt = _slots(jctx, 4, seed=12)
    jm = jbgv.ct_mul_plain(jctx, (jnp.asarray(jc0), jnp.asarray(jc1)), jnp.asarray(pt), 0)
    tm = bgv.ct_mul_plain(tctx, (tc0, tc1), _t(pt), 0)
    for j, t in zip(jm, tm):
        assert np.array_equal(_u(t), np.asarray(j))
    ja = jbgv.ct_add(jctx, jm, (jnp.asarray(jc0), jnp.asarray(jc1)), 0)
    ta = bgv.ct_add(tctx, tm, (tc0, tc1), 0)
    for j, t in zip(ja, ta):
        assert np.array_equal(_u(t), np.asarray(j))


def test_modswitch_and_decode(pair, cts):
    jctx, jsk, tctx, tsk = pair
    slots, (jc0, jc1), (tc0, tc1) = cts
    jm = jbgv.modswitch(jctx, (jnp.asarray(jc0), jnp.asarray(jc1)), 0)
    tm = bgv.modswitch(tctx, (tc0, tc1), 0)
    for j, t in zip(jm, tm):
        assert np.array_equal(_u(t), np.asarray(j))
    js, jb = jbgv.decrypt_to_slots(jctx, jsk, jm, 1)
    ts, tb = bgv.decrypt_to_slots(tctx, tsk, tm, 1)
    assert np.array_equal(_u(ts), js) and np.array_equal(tb.numpy(), jb)
    got = decode(tctx, tsk, Encoding(tctx, tm[0][0], tm[1][0], 1))
    assert np.array_equal(got.numpy(), slots[0])


@pytest.mark.parametrize("use_modswitch", [True, False])
def test_inner_product_and_decode(pair, cts, use_modswitch):
    jctx, jsk, tctx, tsk = pair
    _, (jc0, jc1), (tc0, tc1) = cts
    coefs = _slots(jctx, 4, seed=13)
    je = jinner_product(JEncoding(jctx, jnp.asarray(jc0), jnp.asarray(jc1), 0),
                        JRingElem(jctx.ring, jnp.asarray(coefs)), use_modswitch)
    te = inner_product(Encoding(tctx, tc0, tc1, 0), RingElem(tctx.ring, _t(coefs)),
                       use_modswitch)
    assert te.level == je.level == (1 if use_modswitch else 0)
    assert np.array_equal(_u(te.c0), np.asarray(je.c0))
    assert np.array_equal(_u(te.c1), np.asarray(je.c1))
    js, jb = jbgv.decrypt_to_slots(jctx, jsk, (je.c0, je.c1), je.level)
    ts, tb = bgv.decrypt_to_slots(tctx, tsk, (te.c0, te.c1), te.level)
    assert np.array_equal(_u(ts), js) and np.array_equal(tb.numpy(), jb)


def test_encode_decode_identity_and_error_distribution(pair):
    _, _, tctx, tsk = pair
    from ringsnark_tpu_torch.encoding import encode

    rs = RingElem(tctx.ring, _t(_slots(tctx, 5, seed=14)))
    enc = encode(tctx, tsk, rs, prng.key(3))
    assert enc.c0.shape == (5, tctx.L, tctx.L_inner, N_INNER)
    assert decode(tctx, tsk, enc) == rs.broadcast_to_poly()
    e = bgv._sample_error_coeffs(tctx, prng.key(4), (64,)).to(torch.int64)[..., 0, :]  # limb Q_0
    Q0 = tctx.inner_primes[0]
    e = torch.where(e > Q0 // 2, e - Q0, e).double()
    k = bgv._cbd_k(tctx.error_stddev)
    assert int(e.abs().max()) <= k
    assert abs(float(e.mean())) < 0.25 and abs(float(e.var()) - k / 2) < 1.0


def test_decode_raises_on_exhausted_budget(pair):
    _, _, tctx, tsk = pair
    rng = np.random.default_rng(15)
    shape = (tctx.L, tctx.L_inner, N_INNER)
    rand = np.stack([rng.integers(0, Q, (tctx.L, N_INNER), dtype=np.uint64)
                     for Q in tctx.inner_primes], axis=-2)
    assert rand.shape == shape
    with pytest.raises(DecodingError):
        decode(tctx, tsk, Encoding(tctx, _t(rand), _t(rand), 0))


@pytest.mark.parametrize("B", [3, 19], ids=["one-chunk", "three-chunks"])
def test_encode_same_key_same_ciphertexts(pair, B, monkeypatch):
    """encode with one key gives the JAX package's c0 and c1 bit for bit,
    in one chunk (the key itself) and in three chunks of 8 rows (fold_in(key,
    i), the last chunk short), with the chunk size cut to 8 rows in both."""
    from ringsnark_tpu.encoding import encode as jencode
    from ringsnark_tpu.encoding import encoding as jencoding
    from ringsnark_tpu_torch.encoding import encode, encoding

    jctx, jsk, tctx, tsk = pair
    per_row = tctx.L * tctx.L_inner * N_INNER
    monkeypatch.setattr(jencoding, "_ENCODE_CHUNK_ELEMS", 8 * per_row)
    monkeypatch.setattr(encoding, "_ENCODE_CHUNK_ELEMS", 8 * per_row)
    slots = _slots(jctx, B, seed=16)
    je = jencode(jctx, jsk, JRingElem(jctx.ring, jnp.asarray(slots)), jax.random.PRNGKey(9))
    te = encode(tctx, tsk, RingElem(tctx.ring, _t(slots)), prng.key(9))
    assert np.array_equal(_u(te.c0), np.asarray(je.c0))
    assert np.array_equal(_u(te.c1), np.asarray(je.c1))


@pytest.mark.parametrize("limbs", [2, 3, 4])
def test_crt_fraction_rounds_as_jitted_jax(limbs):
    """sum_j y_j / Q_j: the port's float64 sum equals XLA's jitted CPU
    program bit for bit (its reciprocal multiplies and fused multiply-adds)."""
    primes = [2147415041, 2147396609, 2147389441, 2147387393][:limbs]
    rng = np.random.default_rng(limbs)
    y = np.stack([rng.integers(0, q, (4, 2, 512), dtype=np.uint64) for q in primes], axis=-2)

    @jax.jit
    def jsum(y):
        return jnp.sum(y.astype(jnp.float64) / np.array(primes, dtype=np.float64)[:, None],
                       axis=-2)

    got = bgv._crt_fraction(torch.from_numpy(y.astype(np.int64)), primes).numpy()
    assert np.array_equal(got, np.asarray(jsum(jnp.asarray(y))))


def test_budget_bits_round_as_jitted_jax():
    """floor(-1 - log2(max(x, 2^-62))): equal to XLA's jitted CPU program on
    powers of two (where the rounding decides the floor), tiny values below
    the clamp, and random magnitudes."""
    rng = np.random.default_rng(0)
    x = np.concatenate([2.0 ** -np.arange(1, 70), 3.0 * 2.0 ** -np.arange(2, 70),
                        rng.random(4000) * 2.0 ** -rng.integers(1, 64, 4000)])

    @jax.jit
    def jbudget(a):
        return jnp.floor(-1.0 - jnp.log2(jnp.maximum(a, 2.0**-62))).astype(jnp.int64)

    got = bgv._budget_bits(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jbudget(jnp.asarray(x))))


# The draw and encryption kernels (csrc/prng.cu) replayed in numpy with the
# wrappers' own geometry and key tables (tests/prng_replay.py) equal the
# plain torch-op draws and encryption on the CPU: whole batches, a single
# element, row ranges with lo != 0 and a short last sub-chunk of a slab,
# and the error's words at a stride of `slab` rows (two words a side at
# sigma = 5: k = 50).
ENC_DRAWS = {
    "whole_batch": ((3,), None, 3.2),
    "one_element": ((), None, 3.2),
    "sub_chunk_lo_not_0": ((16,), (5, 9), 3.2),
    "short_last_sub_chunk": ((16,), (12, 16), 3.2),
    "two_words_a_side": ((16,), (3, 10), 5.0),
}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("case", list(ENC_DRAWS))
def test_kernel_replay_equals_plain_uniform_and_error(pair, case):
    import dataclasses

    import prng_replay

    from ringsnark_tpu_torch.ops import cuda_prng

    _, _, tctx, _ = pair
    batch, rows, sigma = ENC_DRAWS[case]
    ctx = dataclasses.replace(tctx, error_stddev=sigma)
    key = prng.key(60 + list(ENC_DRAWS).index(case))
    shape = (*(batch or (1,)), ctx.L, ctx.n_inner)
    geo = cuda_prng.geometry(shape, rows, 0)

    a = bgv._sample_uniform(ctx, key, batch, rows)
    got = prng_replay.draw(cuda_prng.uniform_columns(ctx.inner_primes, key), geo)
    assert np.array_equal(got.reshape(a.shape), _host(a))

    e = bgv._sample_error_coeffs(ctx, key, batch, rows)
    k = bgv._cbd_k(sigma)
    got = prng_replay.cbd(ctx.inner_primes, key, k, geo)
    assert np.array_equal(got.reshape(e.shape), _host(e))
    assert (k > 32) == (sigma == 5.0)  # the two-word case reaches the mask of word 1


@pytest.mark.parametrize("case", ["whole_batch", "sub_chunk_lo_not_0"])
def test_kernel_constants_and_encrypt_replay_equal_plain(pair, case):
    """The host's tables for the lift and encryption kernels equal the plain
    versions' constants (s_ntt beside floor(s 2^32 / Q_j); Q_j - t_l as a
    32-bit word, Q_j, t_l mod Q_j and its Shoup constant; the key columns of
    split(k_a, L')), and the
    two kernels replayed with them (the lift with its error, the forward
    NTT between them) give the plain encryption's c0 and c1, with c1 and
    without, at one CTA, a few and more CTAs than units."""
    import prng_replay

    from ringsnark_tpu_torch.ops import cuda_prng

    jctx, _, ctx, sk = pair
    batch, rows, _ = ENC_DRAWS[case]
    Qs = np.array(ctx.inner_primes, dtype=object)
    s_pairs, k4 = _host(sk.s_pairs), _host(cuda_prng.lift_consts(ctx))
    s = _host(sk.s_ntt)
    assert np.array_equal(s_pairs[..., 0], s)
    assert np.array_equal(s_pairs[..., 1].astype(object),
                          (s.astype(object) << 32) // Qs[None, :, None])
    tmq = ctx.t_mod_Q[..., 0].numpy()
    qt = (ctx.Q_np[None, :].astype(np.int64) - ctx.t_np[:, None].astype(np.int64)) % (1 << 32)
    assert np.array_equal(k4[..., 0], qt)
    assert np.array_equal(k4[..., 1], np.broadcast_to(ctx.Q_np[None, :], tmq.shape))
    assert np.array_equal(k4[..., 2], tmq)
    assert np.array_equal(k4[..., 3].astype(object), (tmq.astype(object) << 32) // Qs[None, :])

    key = prng.key(70)
    k_a, k_e = prng.split(key)
    cols = cuda_prng.uniform_columns(ctx.inner_primes, k_a)
    for kj, Q, col in zip(prng.split(k_a, ctx.L_inner), ctx.inner_primes, cols):
        k_hi, k_lo = prng.split(kj)
        assert col == (*k_lo, *k_hi, Q, 0, (1 << 32) // Q, 0)

    n = (rows[1] - rows[0]) if rows else batch[0]
    slots = _t(_slots(jctx, n, seed=71))
    pt = slots if bgv._scalar(ctx, slots) else bgv._slots_to_plain_coeffs(ctx, slots)
    geo, _ = cuda_prng._enc_geometry(ctx, batch, rows)
    u = bgv._lift_error_plain(ctx, pt, k_e, batch, rows)
    got = prng_replay.lift(_host(pt), k4, ctx.L_inner, geo, bgv._scalar(ctx, slots),
                           (k_e, bgv._cbd_k(ctx.error_stddev)))
    assert np.array_equal(got.reshape(u.shape), _host(u))
    u = tntt.negacyclic_ntt_rev(u, ctx.inner_plan(0))
    c0, c1 = bgv._encrypt_from_u(ctx, sk.s_ntt, u, bgv._uniform_plain(ctx, k_a, batch, rows))
    if rows is None:
        assert all(torch.equal(x, y) for x, y in zip((c0, c1), bgv.encrypt(ctx, sk, slots, key)))
    for ctas, with_c1 in ((1, True), (3, False), (1000, True)):
        r0, r1 = prng_replay.encrypt(cols, geo, ctx.L, _host(u), s_pairs, ctas, with_c1)
        assert np.array_equal(r0.reshape(c0.shape), _host(c0))
        assert (r1 is None) if not with_c1 else np.array_equal(r1.reshape(c1.shape), _host(c1))


def _lift_ctx(ts: tuple, inner: tuple, N: int = 16, n_inner: int = 64, sigma: float = 3.2):
    return EncodingContext(ring=RingContext(primes=ts, N=N, device="cpu"), n_inner=n_inner,
                           inner_primes=inner, error_stddev=sigma)


def _primes(count, below, n_inner=64):
    from ringsnark_tpu_torch.ops.primes import find_ntt_primes as tfind

    return tuple(tfind(count, 2 * n_inner, bits=(below - 1).bit_length(), below=below))


TOP = _primes(3, 1 << 31)  # the largest NTT primes below 2^31
LINE = 4096  # a line of at least a CTA's kThreads * kPer = 1024 coefficients (3 primes' budget)
TOP_LINE = _primes(3, 1 << 31, LINE)
# (plain moduli t_l, inner primes, rows, level, scalar, t against Q_j, N',
# sigma): t above every Q_j with primes just under 2^31; Q_j just above t /
# 2; t above 2 Q_j (the lift alone: the kernel adds t*e only where t <= 2
# Q_j); two limbs at level 1 (the lift alone: the error is a fresh
# encryption's); the Z_q slots of three limbs; two words a side (k = 50 at
# sigma 5); and each again where a line holds a CTA's block (N' = 4096: the
# line, t/2 and the error's counters the thread's), two limbs at level 0
# (each CTA's limb from its line) and at level 1 (C < Cs)
LIFTS = {
    "t_above_q_near_2e31": (TOP[:1], _primes(3, TOP[0]), 3, 0, False, "q < t <= 2q", 64, 3.2),
    "q_just_above_t_half": (TOP[:1], _primes(2, TOP[0] // 2 + (1 << 20)), 2, 0, False,
                            "q < t <= 2q", 64, 3.2),
    "t_above_2q": (TOP[:1], _primes(2, 1 << 29), 2, 0, False, "2q < t", 64, 3.2),
    "two_limbs_level1": (_primes(2, 1 << 20), TOP, 3, 1, False, "t < q", 64, 3.2),
    "zq_scalar": (TOP, _primes(3, TOP[-1]), 5, 0, True, "q < t <= 2q", 64, 3.2),
    "two_words_a_side": (TOP[:1], _primes(3, TOP[0]), 3, 0, False, "q < t <= 2q", 64, 5.0),
    "line_t_above_q": (TOP_LINE[:1], _primes(3, TOP_LINE[0], LINE), 2, 0, False, "q < t <= 2q",
                       LINE, 3.2),
    "line_two_words_a_side": (TOP_LINE[:1], _primes(3, TOP_LINE[0], LINE), 2, 0, False,
                              "q < t <= 2q", LINE, 5.0),
    "line_two_limbs": (_primes(2, 1 << 20, LINE), TOP_LINE, 2, 0, False, "t < q", LINE, 3.2),
    "line_two_limbs_level1": (_primes(2, 1 << 20, LINE), TOP_LINE, 2, 1, False, "t < q", LINE,
                              3.2),
    "line_zq_scalar": (TOP_LINE, _primes(3, TOP_LINE[-1], LINE), 3, 0, True, "q < t <= 2q",
                       LINE, 3.2),
}
ORDER = {"t < q": lambda t, q: t < q, "q < t <= 2q": lambda t, q: q < t <= 2 * q,
         "2q < t": lambda t, q: 2 * q < t}


@pytest.mark.parametrize("case,error", [
    (case, error) for case in LIFTS for error in (False, True)
    if not (error and (LIFTS[case][3] or LIFTS[case][5] == "2q < t"))
], ids=lambda v: {False: "lift", True: "lift_error"}.get(v, v) if isinstance(v, bool) else v)
def test_kernel_replay_equals_plain_lift(case, error):
    """The lift kernel replayed in numpy with the wrapper's constants and
    geometry equals `_lift_centered` (as int32) and, with the error, the
    plain `_lift_error_plain` (the error's rows 9 to 9 + rows of a 16-row
    draw): coefficients 0, t/2, t/2 + 1 and t - 1 besides random ones, t_l
    above Q_j, primes just under 2^31, the Z_q slot at coefficient 0, one
    and two words a side, lines shorter than a CTA's block and lines of
    many blocks, level 1.  The plain versions equal the JAX package's
    `_lift_centered` (where t <= 2 Q_j) and, through one NTT (the port's
    plain one; NTT(lift + t e) = NTT(lift) + t NTT(e)), its lift plus t *
    `_sample_error_ntt` (one key, the same rows of the draw)."""
    import prng_replay

    from ringsnark_tpu.rings.context import RingContext as JRingContext
    from ringsnark_tpu_torch.ops import cuda_prng

    ts, inner, rows, level, scalar, order, n_inner, sigma = LIFTS[case]
    N = 1 if scalar else 16
    ctx = _lift_ctx(ts, inner, N, n_inner, sigma)
    L = ctx.L
    assert all(ORDER[order](ti, q) for ti in ctx.ring.primes for q in inner)
    assert cuda_prng._error_lift_ok(ctx) == (order != "2q < t")
    assert (bgv._cbd_k(sigma) > 32) == (sigma == 5.0)  # two words a side
    rng = np.random.default_rng(len(case))
    width = 1 if scalar else ctx.n_inner
    ts = np.array(ctx.ring.primes, np.int64)
    pt = rng.integers(0, ts[:, None], (rows, L, width))
    edges = np.stack([0 * ts, ts // 2, ts // 2 + 1, ts - 1], axis=-1)  # [L, 4]
    if scalar:
        pt[:4, :, 0] = edges.T[:rows]
    else:
        pt[0, :, :4] = edges
    pt = torch.from_numpy(pt.astype(np.int32))
    k4 = _host(cuda_prng.lift_consts(ctx))
    C = ctx.L_inner - level
    jctx = JEncodingContext(ring=JRingContext(primes=tuple(ctx.ring.primes), N=N),
                            n_inner=n_inner, inner_primes=tuple(inner), error_stddev=sigma)
    if error:
        key, batch, draw = prng.key(72), (16,), (9, 9 + rows)
        geo, _ = cuda_prng._enc_geometry(ctx, batch, draw)
        want = bgv._lift_error_plain(ctx, pt, key, batch, draw)
        got = prng_replay.lift(_host(pt), k4, C, geo, scalar, (key, bgv._cbd_k(ctx.error_stddev)))
        jwant = j_lift_error_ntt(jctx, jnp.asarray(_u(pt)), 72, batch, draw)
        assert np.array_equal(_u(tntt.negacyclic_ntt_rev(want, ctx.inner_plan(0))),
                              np.asarray(jwant))
    else:
        want = bgv._lift_centered(ctx, pt, level).to(torch.int32)
        geo = cuda_prng.geometry((rows, L, width))
        got = prng_replay.lift(_host(pt), k4, C, geo, False)
        if order != "2q < t":
            jlift = jbgv._lift_centered(jctx, jnp.asarray(_u(pt)), level)
            assert np.array_equal(_u(want), np.asarray(jlift))
    assert np.array_equal(got.reshape(want.shape), _host(want))


def test_lift_wrapper_refuses_an_oversize_launch(monkeypatch):
    """A lift whose output reaches 2^32 words (the kernel's 32-bit offsets)
    raises a ValueError naming its size before anything is allocated or
    launched: the Z_q slots of 2^15 rows lifted with the error to L' = 4
    primes at N' = 32768; one row fewer passes the check."""
    from ringsnark_tpu_torch.ops import cuda_prng

    n_inner = 1 << 15
    ctx = _lift_ctx(_primes(1, 1 << 30, n_inner), _primes(4, 1 << 31, n_inner), 1, n_inner)

    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(cuda_prng, "_check_device", lambda device, name: torch.device(device))
    monkeypatch.setattr(cuda_prng, "_lib", no_launch)
    monkeypatch.setattr(cuda_prng, "lift_consts", no_launch)
    rows = (1 << 32) // (ctx.L_inner * n_inner)
    assert rows == 1 << 15 and ctx.L == 1
    pt = torch.zeros((rows, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{1 << 32} output words"):
        cuda_prng.lift_error(ctx, pt, prng.key(73), (rows,), None, 21)
    with pytest.raises(AssertionError, match="launched"):  # past the check: the constants
        cuda_prng.lift_error(ctx, pt[1:], prng.key(73), (rows - 1,), None, 21)
