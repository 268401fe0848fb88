"""The prover's MAC (`encoding/mac.py`, `ops/cuda_mac.py`, `csrc/mac.cu`) on
the CPU, exact (`==`: the arithmetic is modular integer):

* `mac_rows` on CPU tensors equals the expression the three provers held
  inline before (`torch.remainder(c.to(int64) * pt, Q).sum(0)`); the
  provers themselves stay held to the JAX package by test_torch_seeded.py,
  test_torch_streamed.py and test_torch_rinocchio.py;
* both kernels' schedules replayed in numpy (`tests/mac_replay.py`, with
  the launcher's persistent walk at 1 to 1000 resident CTAs, the column
  tiling, the operand's Shoup constant and the pair sums in 32 bits, and
  `prng_replay` for the drawn c1 at the 32-bit counter halves) equal
  `mac_plain`: primes just under 2^31 with terms near p^2, every word at
  Q_j - 1, the smallest and largest primes the contexts make, a row count
  that is odd and one row, a level above 0, one to four operands, the Z_q
  broadcast operand, and the seeded prove's one-operand sub-chunk at a
  slab's offset (its last short sub-chunk);
* a rehearsal: with `cuda_mac._lib()` replaced by the replay over host
  memory, the resident, seeded and streamed provers (ringGroth16 and
  Rinocchio) at L = 1, 2 and the Z_q provers run through the wrappers and
  give the plain proofs; and with `cuda_prng._lib()` replaced by the lift
  and encryption kernels' replay (`tests/prng_replay.py`) as well, every
  generator and prover encrypts and lifts through the card's schedule (one
  forward NTT an encryption) and gives the plain keys and proofs;
* a tensor on the card never reaches `mac_plain`, and the wrapper refuses
  what the kernels do not take, a modulus the reduction does not take
  among it.
"""

import contextlib
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mac_replay
import prng_replay
from ringsnark_tpu_torch.encoding import EncodingContext, bgv, mac
from ringsnark_tpu_torch.encoding.context import _HE_STD_128, default_inner_primes
from ringsnark_tpu_torch.ops import cuda_mac, cuda_prng
from ringsnark_tpu_torch.ops import ntt as tntt
from ringsnark_tpu_torch.rings.context import default_context
from ringsnark_tpu_torch.utils import interop, prng


def _ctx(L: int, n_inner: int, L_inner: int, N: int = 8, primes=None) -> EncodingContext:
    """Inner primes just under 2^31 (the largest = 1 mod 2N'), or `primes`
    (the ring's then = 1 mod 4096, so none is one of them)."""
    ring = default_context(L=L, N=N, order=4096 if primes else 2 * n_inner, device="cpu")
    return EncodingContext(ring=ring, n_inner=n_inner, inner_primes=primes or
                           default_inner_primes(n_inner, ring.primes, L_inner))


@functools.lru_cache(maxsize=None)
def _context_primes() -> tuple:
    """(smallest, largest) inner prime that the contexts make: every degree
    of the security table at its whole budget, and the test degrees."""
    primes = [p for n in _HE_STD_128 for p in default_inner_primes(n, ())]
    primes += [p for n in (64, 256, 512) for p in default_inner_primes(n, (), 4)]
    assert all((p - 1) % 128 == 0 for p in primes)  # an inner prime of N' = 64
    return min(primes), max(primes)


def _residues(rng, ctx, level: int, rows: int, extreme, width=None) -> torch.Tensor:
    """int32 [rows, L, C, width or N'] below each Q_j; `extreme`: half the
    words within 16 of Q_j - 1, so terms come near Q_j^2; "top": every word
    Q_j - 1."""
    primes = np.array(ctx.level_primes(level), dtype=np.int64)[None, None, :, None]
    shape = (rows, ctx.L, len(ctx.level_primes(level)), width or ctx.n_inner)
    x = rng.integers(0, primes, shape, dtype=np.int64)
    if extreme == "top":
        x = np.broadcast_to(primes - 1, shape)
    elif extreme:
        near = primes - 1 - rng.integers(0, 16, shape, dtype=np.int64)
        x = np.where(rng.random(shape) < 0.5, near, x)
    return torch.from_numpy(x.astype(np.int32))


def _accs(rng, ctx, level: int, P: int) -> list:
    """Accumulators that already hold sums (the MAC adds into them)."""
    shape = (ctx.L, ctx.L_inner - level, ctx.n_inner)
    return [tuple(torch.from_numpy(rng.integers(0, 1 << 40, shape, dtype=np.int64))
                  for _ in range(2)) for _ in range(P)]


def _inline(ctx, level, c0, c1, pts, accs):
    """The expression the provers held before (encoding.py, seeded.py,
    streamed.py)."""
    Q = ctx.inner_consts(level)
    for (a0, a1), pt in zip(accs, pts):
        n = pt.shape[0]
        ptntt = pt.to(torch.int64)
        a0 += torch.remainder(c0[:n].to(torch.int64) * ptntt, Q).sum(0)
        a1 += torch.remainder(c1[:n].to(torch.int64) * ptntt, Q).sum(0)


def _copy(accs):
    return [tuple(a.clone() for a in pair) for pair in accs]


def _bcast(pt: torch.Tensor, n_inner: int) -> torch.Tensor:
    """`bgv.plain_to_inner_ntt`'s Z_q operand: [rows, L, C, 1] expanded over N'."""
    return pt[..., :1].contiguous().expand(*pt.shape[:-1], n_inner)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32).astype(np.uint64)


# ---------------------------------------------------------------------------
# mac_rows on the CPU == the inline expression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,level,bcast", [(1, 0, False), (2, 0, False), (2, 1, False),
                                           (3, 0, True)],
                         ids=["P1", "P2", "level1", "bcast_P3"])
def test_mac_rows_on_cpu_equals_inline_expression(P, level, bcast):
    rng = np.random.default_rng(P + 10 * level)
    ctx = _ctx(2, 64, 3)
    n = 9
    c0, c1 = (_residues(rng, ctx, level, n, True) for _ in range(2))
    pts = [_residues(rng, ctx, level, n - 3 * k, True) for k in range(P)]
    if bcast:
        pts = [_bcast(pt, ctx.n_inner) for pt in pts]
    accs = _accs(rng, ctx, level, P)
    want = _copy(accs)
    _inline(ctx, level, c0, c1, pts, want)
    mac.mac_rows(ctx, level, c0, c1, pts, accs)
    for (a0, a1), (w0, w1) in zip(accs, want):
        assert torch.equal(a0, w0) and torch.equal(a1, w1)


def test_mac_rows_drawn_on_cpu_equals_inline_over_the_draw():
    """A `Drawn` c1 is the uniform mask's rows: the same sums as the
    materialised draw."""
    rng = np.random.default_rng(5)
    ctx = _ctx(1, 64, 4)
    drawn = mac.Drawn(prng.key(3), (32,), (7, 20))
    c0 = _residues(rng, ctx, 0, 13, False)
    c1 = bgv._uniform_plain(ctx, drawn.key, drawn.batch_shape, drawn.rows)
    pts = [_residues(rng, ctx, 0, 13, False), _residues(rng, ctx, 0, 4, False)]
    accs = _accs(rng, ctx, 0, 2)
    want = _copy(accs)
    _inline(ctx, 0, c0, c1, pts, want)
    mac.mac_rows(ctx, 0, c0, drawn, pts, accs)
    for (a0, a1), (w0, w1) in zip(accs, want):
        assert torch.equal(a0, w0) and torch.equal(a1, w1)


# ---------------------------------------------------------------------------
# the kernels' schedules replayed == mac_plain
# ---------------------------------------------------------------------------

REPLAY_CASES = {
    # the north star's width (L=1, L'=4, N'=16384): 40 rows over 7 CTAs
    "north_star_P2_ragged": dict(L=1, Lp=4, n_inner=16384, level=0, n=40, rows=(40, 27),
                                 ctas=7),
    "north_star_one_row": dict(L=1, Lp=4, n_inner=16384, level=0, n=1, rows=(1,), ctas=1000),
    # the seeded prove's one-operand sub-chunk: a slab's last, short one
    # (rows 1536..1573 of a 4096-row slab), one CTA a tile and a half
    "seeded_P1_last_sub_chunk": dict(L=1, Lp=4, n_inner=16384, level=0, n=37, rows=(37,),
                                     ctas=97, slab=4096, lo=1536),
    "level1_P2": dict(L=2, Lp=4, n_inner=512, level=1, n=33, rows=(33, 33), ctas=3),
    "narrow_P1_ragged": dict(L=1, Lp=2, n_inner=256, level=0, n=1501, rows=(1501,), ctas=5),
    "zq_broadcast_P2": dict(L=1, Lp=3, n_inner=4096, level=0, n=50, rows=(50, 37), bcast=True,
                            N=1, ctas=11),
    "rinocchio_P4": dict(L=1, Lp=3, n_inner=512, level=0, n=70, rows=(70, 70, 69, 12), ctas=1),
    # every word Q_j - 1: the largest terms, pair sums 2 (Q_j - 1)^2 mod Q_j
    "every_word_q_minus_1": dict(L=2, Lp=3, n_inner=256, level=0, n=9, rows=(9, 4),
                                 extreme="top", ctas=4),
    # the extreme primes the contexts make, with extreme words
    "smallest_context_prime": dict(L=1, Lp=1, n_inner=64, level=0, n=21, rows=(21, 20),
                                   prime=0, ctas=2),
    "largest_context_prime": dict(L=1, Lp=1, n_inner=64, level=0, n=21, rows=(21,),
                                  prime=1, extreme="top", ctas=6),
}


@pytest.mark.parametrize("case,drawn", [
    (case, drawn) for case in REPLAY_CASES for drawn in (False, True)
    if not (drawn and REPLAY_CASES[case]["level"])  # the seeded prove's c1 is at level 0
], ids=lambda v: {False: "mac", True: "mac_drawn"}.get(v, v) if isinstance(v, bool) else v)
def test_kernel_replay_equals_plain(case, drawn):
    cfg = REPLAY_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    primes = (_context_primes()[cfg["prime"]],) if "prime" in cfg else None
    ctx = _ctx(cfg["L"], cfg["n_inner"], cfg["Lp"], cfg.get("N", 8), primes)
    level, n, bcast = cfg["level"], cfg["n"], cfg.get("bcast", False)
    extreme = cfg.get("extreme", True)
    q, mu = cuda_mac.barrett(ctx.level_primes(level))
    c0 = _residues(rng, ctx, level, n, extreme)
    slab, lo = cfg.get("slab", n + 11), cfg.get("lo", 5)
    c1 = mac.Drawn(prng.key(len(case)), (slab,), (lo, lo + n)) if drawn else \
        _residues(rng, ctx, level, n, extreme)
    pts = [_residues(rng, ctx, level, r, extreme, 1 if bcast else None) for r in cfg["rows"]]
    if bcast:
        pts = [pt.expand(*pt.shape[:-1], ctx.n_inner) for pt in pts]
    accs = _accs(rng, ctx, level, len(pts))
    want = _copy(accs)
    mac.mac_plain(ctx, level, c0, c1, pts, want)
    got = [tuple(a.numpy().copy() for a in pair) for pair in accs]
    host_pts = [_host(pt[..., 0] if bcast else pt) for pt in pts]
    if drawn:
        geo, _ = cuda_prng._enc_geometry(ctx, c1.batch_shape, c1.rows)
        table = cuda_prng._table(cuda_prng.uniform_columns(ctx.inner_primes, c1.key)).astype(np.uint64)
        mac_replay.mac(_host(c0), None, host_pts, bcast, got, q, mu, cfg["ctas"],
                       (table, geo.n_axis, geo.lo))
    else:
        mac_replay.mac(_host(c0), _host(c1), host_pts, bcast, got, q, mu, cfg["ctas"])
    for (g0, g1), (w0, w1) in zip(got, want):
        assert np.array_equal(g0, w0.numpy()) and np.array_equal(g1, w1.numpy())


def test_plan_and_barrett_constants():
    """The launcher's walk takes every (tile, row) unit once at any number
    of CTAs, a run never crossing a tile; mu_j = floor(2^64 / Q_j); each
    operand word's Shoup constant is floor(w 2^32 / Q_j) or one less, and
    the term's reduction is exact at the extreme words (0, 1, Q_j - 1, c
    words up to 2^31 - 1) for the smallest and largest primes the contexts
    make and across the moduli it takes, [2, 2^31); `barrett` refuses any
    other modulus by name."""
    for n, width, ctas in ((512, 65536, 264), (37, 65536, 97), (910, 36864, 396),
                           (1, 64, 8), (7, 3 * mac_replay.TILE, 1000), (10 ** 4, 4, 3)):
        runs = mac_replay.walk(n, width, ctas)
        assert all(0 <= r < r + rows <= n for _, r, rows in runs)
        assert len(runs) <= min(ctas, -(-width // mac_replay.TILE) * n) - 1 + \
            -(-width // mac_replay.TILE)
    primes = (*_context_primes(), 2, 3, 65537, (1 << 31) - 1)
    q, mu = cuda_mac.barrett(primes)
    assert [int(m) for m in mu] == [(1 << 64) // p for p in primes]
    rng = np.random.default_rng(6)
    for p, m in zip(q.astype(np.uint64), mu):
        P = int(p)
        w = np.unique(np.array([0, 1, 2, P // 2, P - 2, P - 1, *rng.integers(0, P, 8)],
                               np.uint64) % p)
        a = np.unique(np.array([0, 1, P - 1, (1 << 31) - 1, (1 << 31) - 2,
                                *rng.integers(0, 1 << 31, 8)], np.uint64))
        w_sh = mac_replay.shoup_of(w, m)
        exact = np.array([(int(x) << 32) // P for x in w], np.uint64)
        assert ((w_sh == exact) | (w_sh + np.uint64(1) == exact)).all()
        aa, ww = np.meshgrid(a, w)
        hh = np.broadcast_to(w_sh[:, None], ww.shape)
        got = mac_replay.mul_mod(aa.ravel(), ww.ravel(), hh.ravel(), p)
        assert got.tolist() == [int(x) * int(y) % P for x, y in zip(aa.ravel(), ww.ravel())]
    for bad in (0, 1, 1 << 31, (1 << 31) + 11, (1 << 32) - 5):
        with pytest.raises(ValueError, match=f"modulus {bad} "):
            cuda_mac.barrett((_context_primes()[1], bad))


# ---------------------------------------------------------------------------
# the rehearsal: every prover through the wrappers, the library replayed
# ---------------------------------------------------------------------------

@pytest.fixture
def replayed(monkeypatch):
    """`mac_rows` takes CPU tensors for the card's: the wrappers run (shape,
    dtype, contiguity and alignment checks; the launch plan; the C
    functions' arguments) and the library is the numpy replay."""
    fake = mac_replay.lib()

    def install():
        monkeypatch.setattr(cuda_mac, "_lib", lambda: fake)
        monkeypatch.setattr(cuda_mac, "_check_device", lambda x, name: None)
        monkeypatch.setattr(mac, "_on_card", lambda x: True)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: SimpleNamespace(cuda_stream=0))
        cuda_mac.reset_launch_counts()
        return fake

    return install


def _params(L: int, N: int = 16, n_inner: int = 64):
    from ringsnark_tpu_torch.scripts.common import bench_params

    return bench_params(L, N, n_inner, 4, 4, "cpu")


def _prove(system: str, params, seed: int):
    """(proof as numpy, verifier) of one prover on the squaring chain, M=16."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, rinocchio, seeded, streamed

    comp, primary, aux = build_synthetic_square_chain(params.ring, 16,
                                                      np.random.default_rng(seed))
    rng, key = np.random.default_rng(seed + 1), prng.key(seed + 2)
    if system == "resident":
        kp = groth16.generator(comp, params, rng, key)
        return kp, lambda: groth16.prover(kp.pk, primary, aux), groth16.verifier, primary
    if system == "seeded":
        kp = seeded.generator_seeded(comp, params, rng, key, slab=8)
        return kp, lambda: seeded.prover_seeded(kp.pk, primary, aux), groth16.verifier, primary
    stream = streamed.stream_prove if system == "streamed" else streamed.stream_prove_rinocchio
    verifier = groth16.verifier if system == "streamed" else rinocchio.verifier

    def run():
        return stream(comp, params, primary, aux, np.random.default_rng(seed + 1), key, slab=8,
                      phase_rows=8)[:2]
    return None, run, verifier, primary


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("system", ["resident", "seeded", "streamed", "streamed_rinocchio"])
def test_rehearsal_provers_through_replayed_kernels(replayed, system, L):
    """Each prover through the wrappers over the replayed library gives the
    plain proof bit for bit, and launches the kernel it should (the seeded
    prove draws c1 in `mac_drawn` and nothing else)."""
    params = _params(L)
    kp, prove, verifier, primary = _prove(system, params, 30 + L)
    plain = prove()
    fake = replayed()
    got = prove()
    if kp is None:  # the streamed provers return (proof, vk)
        (plain, _), (got, vk) = plain, got
    else:
        vk = kp.vk
    assert verifier(vk, primary, got)
    for g, w in zip(interop.proof_to_numpy(got), interop.proof_to_numpy(plain)):
        assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    drawn = system == "seeded"
    assert cuda_mac.launch_counts["mac_drawn" if drawn else "mac"] > 0
    assert cuda_mac.launch_counts["mac" if drawn else "mac_drawn"] == 0
    assert len(fake.calls) == sum(cuda_mac.launch_counts.values())
    if system == "streamed_rinocchio":
        assert max(P for P, *_ in fake.calls) == 4  # the four witness vectors in one launch


@pytest.mark.parametrize("system", ["seeded", "streamed"])
def test_rehearsal_zq_broadcast_operand(replayed, system):
    """Z_q (N=1, L=3): the broadcast operand goes to the kernels as
    [rows, L, L'] and the proofs equal the plain ones."""
    params = _params(3, N=1, n_inner=64)
    kp, prove, verifier, primary = _prove(system, params, 40)
    plain = prove()
    fake = replayed()
    got = prove()
    if kp is None:
        plain, got = plain[0], got[0]
    for g, w in zip(interop.proof_to_numpy(got), interop.proof_to_numpy(plain)):
        assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    assert fake.calls and all(bcast for _, bcast, *_ in fake.calls)


@pytest.fixture
def replayed_prng(monkeypatch, replayed):
    """The card's encryption schedule on CPU tensors: `bgv` takes the
    context for the card's, so the lift (with its error) and the encryption
    go through `cuda_prng`'s wrappers (checks, constants, geometry,
    the C functions' arguments) to the numpy replay, the NTT between them
    runs its plain twin; the MAC's library is replayed too.  Returns the
    installer and the forward NTTs each `bgv.encrypt` call made."""
    per_call = []

    def install(ctas: int = 5):
        replayed()
        fake = prng_replay.lib(ctas)
        monkeypatch.setattr(cuda_prng, "_lib", lambda: fake)
        monkeypatch.setattr(cuda_prng, "_check_device", lambda d, name: torch.device(d))
        monkeypatch.setattr(bgv, "_on_card", lambda ctx: True)
        fwd, encrypt = tntt.negacyclic_ntt_rev, bgv.encrypt
        calls = [0]

        def counted_fwd(*a, **k):
            calls[0] += 1
            return fwd(*a, **k)

        def counted_encrypt(*a, **k):
            before = calls[0]
            out = encrypt(*a, **k)
            per_call.append(calls[0] - before)
            return out

        monkeypatch.setattr(tntt, "negacyclic_ntt_rev", counted_fwd)
        monkeypatch.setattr(bgv, "encrypt", counted_encrypt)
        cuda_prng.reset_launch_counts()
        return fake

    yield install, per_call


def _generate_and_prove(system: str, params, seed: int):
    """(keypair arrays or None, proof, verifier's verdict) of one system,
    generator and prover both run (the streamed systems in one pass)."""
    kp, prove, verifier, primary = _prove(system, params, seed)
    got = prove()
    if kp is None:
        proof, vk = got
        return None, proof, verifier(vk, primary, proof)
    return interop.keypair_to_numpy(kp), got, verifier(kp.vk, primary, got)


@pytest.mark.parametrize("system,L,N", [
    ("resident", 1, 16), ("resident", 2, 16), ("seeded", 1, 16), ("seeded", 2, 16),
    ("streamed", 1, 16), ("streamed_rinocchio", 2, 16), ("seeded", 3, 1), ("streamed", 3, 1),
], ids=lambda v: v if isinstance(v, str) else None)
def test_rehearsal_encryption_through_replayed_kernels(replayed_prng, system, L, N):
    """Each system's generator and prover with the lift, the encryption and
    the MAC through the wrappers over the replayed libraries give the plain
    keys and proof bit for bit (Z_q at N = 1 with its scalar lift); every
    encryption makes one forward NTT, and launches `lift` and `encrypt`
    and no `cbd_error` or `uniform`; the seeded batches' encryptions keep
    no c1."""
    install, per_call = replayed_prng
    params = _params(L, N=N)
    plain_kp, plain, _ = _generate_and_prove(system, params, 50 + L)
    fake = install()
    got_kp, got, ok = _generate_and_prove(system, params, 50 + L)
    assert ok
    for g, w in zip(interop.proof_to_numpy(got), interop.proof_to_numpy(plain)):
        assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    if plain_kp is not None:
        flat = [(k, np.asarray(v)) for k, v in _flatten(got_kp)]
        assert [k for k, _ in flat] == [k for k, _ in _flatten(plain_kp)]
        assert all(np.array_equal(v, w) for (_, v), (_, w) in zip(flat, _flatten(plain_kp)))
    counts = cuda_prng.launch_counts
    assert per_call and all(n == 1 for n in per_call), per_call
    assert counts["encrypt"] == len(per_call) and counts["lift"] >= len(per_call)
    assert counts["cbd_error"] == counts["uniform"] == 0
    kinds = {(kind, err, scalar) for kind, err, scalar, *_ in fake.calls if kind == "lift"}
    # Z_q's encryption lifts its slot to N' coefficients (the scalar mode);
    # its operand stays [rows, L, L', 1] (a lift of width 1) under a broadcast
    assert kinds == {("lift", True, N == 1), ("lift", False, False)}
    # the seeded batches keep c0 alone; alpha, beta and gamma_io both halves
    with_c1 = {c1 for kind, c1, *_ in fake.calls if kind == "encrypt"}
    assert with_c1 == ({False, True} if system == "seeded" else {True})


def _flatten(tree, prefix=""):
    """(path, leaf) of a nested dict / list / tuple of arrays, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# no fallback, and the refusals
# ---------------------------------------------------------------------------

def test_card_tensor_never_reaches_plain(monkeypatch):
    """A tensor taken for the card's goes to the wrapper, which raises on a
    tensor that is not on the card: nothing falls back to mac_plain."""
    rng = np.random.default_rng(1)
    ctx = _ctx(1, 64, 2)
    c = _residues(rng, ctx, 0, 4, False)
    monkeypatch.setattr(mac, "_on_card", lambda x: True)
    monkeypatch.setattr(mac, "mac_plain", lambda *a: pytest.fail("fell back to mac_plain"))
    for c1 in (c, mac.Drawn(prng.key(1), (4,), (0, 4))):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            mac.mac_rows(ctx, 0, c, c1, [c], _accs(rng, ctx, 0, 1))


def test_drawn_c1_is_at_level_0(monkeypatch):
    """A drawn c1 is a fresh encryption's: both versions refuse a level
    above 0 (a switched c1 is no longer the draw)."""
    rng = np.random.default_rng(4)
    ctx = _ctx(1, 64, 3)
    c = _residues(rng, ctx, 1, 4, False)
    drawn = mac.Drawn(prng.key(2), (4,), (0, 4))
    with pytest.raises(ValueError, match="level 0"):
        mac.mac_plain(ctx, 1, c, drawn, [c], _accs(rng, ctx, 1, 1))
    monkeypatch.setattr(cuda_mac, "_check_device", lambda x, name: None)
    with pytest.raises(ValueError, match="level 0"):
        cuda_mac.mac_drawn(ctx, 1, c, drawn, [c], _accs(rng, ctx, 1, 1))


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


REFUSED = {
    "c0_not_contiguous": (lambda c, pt, acc: (c.transpose(0, 1).contiguous().transpose(0, 1),
                                              c, [pt], [acc]), "contiguous"),
    "c1_int64": (lambda c, pt, acc: (c, c.long(), [pt], [acc]), "int32"),
    "operand_longer": (lambda c, pt, acc: (c, c, [torch.cat([pt, pt])], [acc]), "operand shape"),
    "operand_misaligned": (lambda c, pt, acc: (c, c, [_misaligned(pt)], [acc]), "16-byte"),
    "accumulator_int32": (lambda c, pt, acc: (c, c, [pt], [(acc[0].int(), acc[1])]), "int64"),
    "accumulators_missing": (lambda c, pt, acc: (c, c, [pt, pt], [acc]), "accumulator pairs"),
    "operands_of_two_kinds": (lambda c, pt, acc: (c, c, [pt, _bcast(pt, pt.shape[-1])],
                                                  [acc, acc]), "one kind"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses(monkeypatch, case):
    rng = np.random.default_rng(2)
    ctx = _ctx(2, 64, 2)
    c = _residues(rng, ctx, 0, 4, False)
    monkeypatch.setattr(cuda_mac, "_check_device", lambda x, name: None)
    monkeypatch.setattr(cuda_mac, "_lib", lambda: pytest.fail("launched a refused call"))
    make, match = REFUSED[case]
    c0, c1, pts, accs = make(c, c[:3].clone(), _accs(rng, ctx, 0, 1)[0])
    before = dict(cuda_mac.launch_counts)
    with pytest.raises((ValueError, TypeError), match=match):
        cuda_mac.mac(ctx, 0, c0, c1, pts, accs)
    assert cuda_mac.launch_counts == before


_OUTSIDE = "is outside"
_TWO_WORDS = "draws two words"


@pytest.mark.parametrize("modulus, drawn, refusal", [
    pytest.param((1 << 31) + 11, False, _OUTSIDE, id="mac-prime_above_2^31"),
    pytest.param(1 << 31, False, _OUTSIDE, id="mac-2^31"),
    pytest.param((1 << 31) + 11, True, _OUTSIDE, id="mac_drawn-prime_above_2^31"),
    pytest.param(1 << 31, True, _OUTSIDE, id="mac_drawn-2^31"),
    # a span up to 2^16 draws a high word too (JAX's multiplier 225 here)
    pytest.param(65521, True, _TWO_WORDS, id="mac_drawn-prime_below_2^16"),
])
def test_wrapper_refuses_a_modulus_the_reduction_does_not_take(monkeypatch, modulus, drawn,
                                                              refusal):
    """A modulus outside [2, 2^31) (2 Q_j would not fit 32 bits), or for a
    drawn c1 one whose draw takes two words, is refused by name before any
    launch: nothing switches to another reduction or draw."""
    rng = np.random.default_rng(8)
    ctx = _ctx(1, 64, 2)
    c = _residues(rng, ctx, 0, 4, False)
    primes = (ctx.inner_primes[0], modulus)
    wide = SimpleNamespace(L=ctx.L, L_inner=2, n_inner=ctx.n_inner,
                           inner_primes=primes, level_primes=lambda level: primes[level:])
    monkeypatch.setattr(cuda_mac, "_check_device", lambda x, name: None)
    monkeypatch.setattr(cuda_mac, "_lib", lambda: pytest.fail("launched a refused call"))
    before = dict(cuda_mac.launch_counts)
    with pytest.raises(ValueError, match=f"modulus {modulus} {refusal}"):
        if drawn:
            cuda_mac.mac_drawn(wide, 0, c, mac.Drawn(prng.key(1), (4,), (0, 4)), [c],
                               _accs(rng, ctx, 0, 1))
        else:
            cuda_mac.mac(wide, 0, c, c, [c], _accs(rng, ctx, 0, 1))
    assert cuda_mac.launch_counts == before


def test_drawn_rows_must_be_c0s(monkeypatch):
    rng = np.random.default_rng(3)
    ctx = _ctx(1, 64, 2)
    c = _residues(rng, ctx, 0, 4, False)
    monkeypatch.setattr(cuda_mac, "_check_device", lambda x, name: None)
    with pytest.raises(ValueError, match="not c0's"):
        cuda_mac.mac_drawn(ctx, 0, c, mac.Drawn(prng.key(1), (8,), (0, 5)), [c],
                           _accs(rng, ctx, 0, 1))


MAC_SASS = """
        Function : _ZN38_GLOBAL__N__0b7f743a_6_mac_cu_a304b63e16mac_drawn_kernelILi2ELb0EEEvPKj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR4][R2.64+0x10] ;
        /*0030*/              @!P0 LDG.E.128.CONSTANT R12, desc[UR4][R2.64+0x20] ;
        /*0040*/              @!P0 LDG.E.128.CONSTANT R16, desc[UR4][R2.64+0x30] ;
        /*0050*/                   LDG.E.128.CONSTANT R20, desc[UR4][R2.64+0x40] ;
        /*0060*/                   LDG.E.128.CONSTANT R24, desc[UR4][R2.64+0x50] ;
        /*0070*/                   IMAD.HI.U32 R5, R4, R6, RZ ;
        /*0080*/                   SHF.L.W.U32.HI R7, R4, 0xd, R4 ;
        /*0090*/                   VIMNMX.U32 R5, R5, R7, PT ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   ATOMG.E.ADD.64.STRONG.GPU PT, R2, desc[UR4][R8.64], R4 ;
        /*00c0*/               @P2 BRA 0xb0 ;
        /*00d0*/                   EXIT ;
"""


def test_sass_mix_labels_the_mac_row_loops():
    """scripts/sass_mix names a MAC kernel's loop over rows `rows`, takes its
    rows a pass from the 16-byte loads (c0 and two operands a row for
    mac_drawn_kernel<2,0>: six loads, two rows) and gives its classes per
    column and row (four columns a thread); a loop with no row loads is
    `other`."""
    from ringsnark_tpu_torch.scripts import sass_mix

    insns = sass_mix.functions(MAC_SASS)["mac_drawn_kernel<2,0>"]
    loops = sass_mix.innermost_loops(insns)
    assert loops == [(0x10, 0xa0), (0xb0, 0xc0)]
    got = []
    for a, b in loops:
        body = [(x, t) for x, t in insns if a <= x <= b]
        got.append(sass_mix.row_loop("mac_drawn_kernel<2,0>", sass_mix.mix(body), body))
    assert got[0]["label"] == "rows" and got[0]["rows"] == 2
    assert got[0]["per_column_row"]["instructions"] == 10 / 8
    assert got[0]["per_column_row"]["fma"] == 1 / 8 and got[0]["per_column_row"]["mem"] == 6 / 8
    assert got[1] == {"label": "other"}
    assert sass_mix.row_loop("encrypt_kernel<0>", sass_mix.mix(body), body) == {}
