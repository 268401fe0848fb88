"""The witness map's kernels (``csrc/witness.cu``) on the CPU: the CSR that
``relations/r1cs.py`` derives, the kernels replayed in numpy from the
wrapper's own geometry (``tests/witness_replay.py``: one launch for every
matrix of a call, the persistent walk at 1, 3 and 1000 CTAs, the stage
ring, the 16-byte and 4-byte paths, the long rows shared by a CTA and their
partial sums, the Shoup terms, the slot-major warp tiles; ``mulmod``'s
words) and the plain `spmv`, all held to the JAX package's
``CompiledR1CS.eval_matrices`` and ``eval_instance_arrays`` bit for bit:

* systems with duplicate (row, column) entries, empty rows and more output
  rows than constraints; dense coefficients read at a slot offset; the
  transposed orientation (the instance map); long rows (at a 1024-slot
  window, at n = 1, gathering from all three row blocks), a row of exactly
  LONG_ROW nonzeros and one past it; a window at an unaligned offset and
  an odd width; L = 3 at n = 1; residues p - 1 at the smallest and largest
  primes the contexts make;
* an index outside the system refused when the CSR is derived, a modulus
  at or above 2^31 refused by name;
* ``mulmod`` (full and slot-constant b, with and without the added c, in
  place) against the int64 ``mul_mod``/``add_mod``;
* a rehearsal: the resident, seeded, streamed and Rinocchio provers with
  the library replaced by the replay (``cuda_witness._lib``, the device
  check and the dispatch stubbed, as ``tests/test_torch_mac.py``'s
  ``replayed``) give the plain proofs, which the other test files hold to
  the JAX proofs; the slot-chunked map (``slot_chunk=2``, trap d) equals
  the unchunked one through the replay.
"""

import contextlib
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringsnark_tpu.reductions import r1cs_to_qrp as jred
from ringsnark_tpu.relations.r1cs import CompiledR1CS as JCompiled
from ringsnark_tpu.rings.context import RingContext as JRingContext
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.utils.domain import RootsDomain as JRootsDomain
from ringsnark_tpu_torch.encoding.context import _HE_STD_128, default_inner_primes
from ringsnark_tpu_torch.ops import cuda_witness
from ringsnark_tpu_torch.ops.modops import add_mod, mul_mod
from ringsnark_tpu_torch.reductions import r1cs_to_qrp as tred
from ringsnark_tpu_torch.relations.r1cs import LONG_ROW, CompiledR1CS, derive_csr
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.utils import interop
from ringsnark_tpu_torch.utils.domain import RootsDomain

import witness_replay


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _context_primes() -> tuple:
    """(smallest, largest) prime that the contexts make: the inner primes
    of every degree of the security table, and the ring's default primes."""
    primes = [p for n in _HE_STD_128 for p in default_inner_primes(n, ())]
    primes += list(jdefault_context(L=3, N=1, order=1 << 12).primes)
    assert all((p - 1) % 128 == 0 for p in primes)  # a domain of M = 64 exists mod each
    return min(primes), max(primes)


@pytest.fixture
def replayed(monkeypatch):
    """The witness map's wrappers take CPU tensors for the card's: the
    checks, the CSR, the launch arguments run; the library is the numpy
    replay (`spmv` walking `ctas` CTAs)."""

    def install(ctas: int = 5):
        fake = witness_replay.lib(ctas)
        monkeypatch.setattr(cuda_witness, "_lib", lambda: fake)
        monkeypatch.setattr(cuda_witness, "_check_device", lambda x, name: None)
        monkeypatch.setattr(cuda_witness, "on_card", lambda x: True)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: SimpleNamespace(cuda_stream=0))
        cuda_witness.reset_launch_counts()
        return fake

    return install


# ---------------------------------------------------------------------------
# systems held in both packages
# ---------------------------------------------------------------------------

CASES = {
    # duplicate (row, col) entries, empty rows, 8 more output rows than
    # constraints; scalar coefficients
    "duplicates_empty_rows": dict(L=2, N=1, m=24, nv=17, nnz=70, num_rows=32, empty=(3, 9, 23),
                                  dup=12),
    # dense coefficients (nc = N), the window [2, 6) of 8 slots
    "dense_slot_window": dict(L=2, N=8, m=12, nv=10, nnz=40, num_rows=16, dense=True, lo=2,
                              width=4),
    # one row of 300 nonzeros and the constant column in 150 constraints (a
    # long row of the transposed CSR)
    "long_rows": dict(L=1, N=4, m=200, nv=30, nnz=500, num_rows=256, long_row=300,
                      const_col=150),
    # a long row at a 1024-slot window (every slot tile shares it) and at n = 1
    "long_row_1024_slots": dict(L=1, N=1024, m=40, nv=20, nnz=60, num_rows=64, long_row=100,
                                const_col=40),
    "long_row_n1": dict(L=2, N=1, m=60, nv=25, nnz=90, num_rows=64, long_row=300,
                        const_col=50),
    # a row of exactly LONG_ROW nonzeros (a tile's) and one of LONG_ROW + 1 (its own item)
    "threshold_rows": dict(L=2, N=8, m=30, nv=40, nnz=50, num_rows=32,
                           exact={7: LONG_ROW, 9: LONG_ROW + 1}),
    # the window [1, 1001) of 1024 slots: 4-byte words (dense coefficients too)
    "unaligned_window": dict(L=1, N=1024, m=20, nv=15, nnz=40, num_rows=32, dense=True, lo=1,
                             width=1000),
    # the window [4, 1004): 16-byte words, the last slot tile part full
    "odd_width_aligned": dict(L=2, N=1024, m=20, nv=15, nnz=40, num_rows=32, dense=True, lo=4,
                              width=1000),
    # a long row gathering from every row of all three blocks
    "long_row_three_blocks": dict(L=2, N=16, m=20, nv=30, nnz=40, num_rows=32, long_row=80,
                                  const_col=0, spread=True),
    # Z_q with three limbs: a thread's row, the limbs' tiles adjacent
    "zq_L3_n1": dict(L=3, N=1, m=40, nv=30, nnz=90, num_rows=64),
    # a COO already in row order (as compile emits it): its own index and
    # coefficient tensors read in place, rows of one to six nonzeros
    "in_row_order": dict(L=2, N=4, m=20, nv=15, nnz=60, num_rows=32, in_order=True),
    # every word and coefficient p - 1 at the contexts' extreme primes
    "smallest_prime_p_minus_1": dict(L=1, N=1, m=16, nv=9, nnz=50, num_rows=16, prime=0,
                                     top=True),
    "largest_prime_p_minus_1": dict(L=1, N=1, m=16, nv=9, nnz=50, num_rows=32, prime=1,
                                    top=True),
}


def _system(name):
    """(JAX compiled system and ring, the port's on the CPU, z as numpy
    uint32 [1+nv, L, N], the numpy COO) for a case of CASES."""
    cfg = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if "prime" in cfg:
        jring = JRingContext(primes=(_context_primes()[cfg["prime"]],), N=cfg["N"])
    else:
        jring = jdefault_context(L=cfg["L"], N=cfg["N"], order=1 << 12)
    m, nv, L, N = cfg["m"], cfg["nv"], cfg["L"], cfg["N"]
    primes = np.array(jring.primes, dtype=np.uint64)[:, None]
    coo = []
    for _ in range(3):
        rows = rng.integers(0, m, cfg["nnz"])
        rows = np.where(np.isin(rows, cfg.get("empty", ()) + tuple(cfg.get("exact", {}))), 0,
                        rows)
        cols = rng.integers(0, nv + 1, cfg["nnz"])
        for r, count in cfg.get("exact", {}).items():  # rows of exactly `count` nonzeros
            rows = np.concatenate([rows, np.full(count, r)])
            cols = np.concatenate([cols, rng.integers(0, nv + 1, count)])
        if cfg.get("dup"):  # repeat some (row, col) pairs
            k = rng.integers(0, cfg["nnz"], cfg["dup"])
            rows, cols = np.concatenate([rows, rows[k]]), np.concatenate([cols, cols[k]])
        if cfg.get("long_row"):
            rows = np.concatenate([rows, np.full(cfg["long_row"], 5)])
            cols = np.concatenate([cols, np.arange(cfg["long_row"]) % (nv + 1) if cfg.get("spread")
                                   else rng.integers(0, nv + 1, cfg["long_row"])])
            rows = np.concatenate([rows, rng.integers(0, m, cfg["const_col"])])
            cols = np.concatenate([cols, np.zeros(cfg["const_col"], np.int64)])
        if cfg.get("in_order"):
            order = np.argsort(rows, kind="stable")
            rows, cols = rows[order], cols[order]
        nc = N if cfg.get("dense") else 1
        co = rng.integers(0, primes[None], (rows.size, L, nc), dtype=np.uint64)
        if cfg.get("top"):
            co = np.broadcast_to(primes[None] - 1, co.shape)
        coo.append((rows.astype(np.int32), cols.astype(np.int32), co.astype(np.uint32)))
    z = rng.integers(0, primes[None], (nv + 1, L, N), dtype=np.uint64)
    if cfg.get("top"):
        z = np.broadcast_to(primes[None] - 1, z.shape)
    z = np.ascontiguousarray(z.astype(np.uint32))
    jcomp = JCompiled(ctx=jring, num_constraints=m, num_variables=nv, primary_input_size=1,
                      rows=tuple(jnp.asarray(r) for r, _, _ in coo),
                      cols=tuple(jnp.asarray(c) for _, c, _ in coo),
                      coeffs=tuple(jnp.asarray(co) for _, _, co in coo))
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    tcomp = interop.compiled_from_numpy(tring, {
        "rows": [r for r, _, _ in coo], "cols": [c for _, c, _ in coo],
        "coeffs": [co for _, _, co in coo], "num_constraints": m, "num_variables": nv,
        "primary_input_size": 1})
    return jring, jcomp, tring, tcomp, z, coo


@pytest.mark.parametrize("case", CASES)
def test_spmv_replay_and_plain_equal_jax(replayed, case):
    """A.z, B.z, C.z: JAX's eval_matrices == the plain spmv == the replayed
    kernel over the CSRs, one launch a call, in both layouts, at 1, 3 and
    1000 CTAs, over all slots and over a slot window (the wide operands read
    at the window's offset in place), the assignment as one tensor (each
    slot its own row 0) and as three row blocks (the constant row a
    one-slot block, so z's row 0 the same in every slot there, with JAX's
    result on that z); the CSR's rows hold each row's nonzeros once, in the
    COO's order; its long-row list is the rows of more than LONG_ROW
    nonzeros."""
    cfg = CASES[case]
    jring, jcomp, tring, tcomp, z, coo = _system(case)
    num_rows = cfg["num_rows"]
    zc = z.copy()
    zc[0] = zc[0, :, :1]  # the provers' constant row, the same in every slot
    want, want_c = ([np.asarray(w) for w in jcomp.eval_matrices(jnp.asarray(x),
                                                                num_rows=num_rows)]
                    for x in (z, zc))
    zt, ztc = (torch.from_numpy(x.view(np.int32)) for x in (z, zc))
    plain = tcomp.eval_matrices(zt, num_rows)
    for w, g in zip(want, plain):
        assert np.array_equal(_u(g), w)
    for k, (rows, cols, _) in enumerate(coo):
        csr = tcomp.csr(k)
        order = np.arange(rows.size) if csr.perm is None else csr.perm.numpy()
        ptr = np.arange(csr.rows + 1) if csr.unit else csr.ptr.numpy()
        assert np.array_equal(rows[order], np.repeat(np.arange(csr.rows), np.diff(ptr)))
        assert np.array_equal(csr.idx.numpy(), cols[order])
        assert np.array_equal(csr.head.numpy()[np.diff(ptr) > 0], cols[order][ptr[:-1]][
            np.diff(ptr) > 0])
        for r in range(csr.rows):  # a stable sort: the COO's order within a row
            assert (np.diff(order[ptr[r]:ptr[r + 1]]) > 0).all()
        assert csr.long_len == LONG_ROW
        assert np.array_equal(csr.longs.numpy(), np.flatnonzero(np.diff(ptr) > LONG_ROW))
    if cfg.get("long_row"):
        assert 5 in tcomp.csr(0).longs.tolist()
        assert (tcomp.csr(0, transposed=True).nlong > 0) == (cfg["const_col"] > LONG_ROW)
    if cfg.get("exact"):
        assert tcomp.csr(0).longs.tolist() == [9]  # 7 has exactly LONG_ROW nonzeros
    if cfg.get("in_order"):  # no copy of the COO's indices or coefficients
        assert tcomp.csr(0).perm is None and tcomp.csr(0).idx is tcomp.cols[0]
        assert tcomp.csr_coeffs(0, tcomp.csr(0)) is tcomp.coeffs[0]
    lo, width = cfg.get("lo", 0), cfg.get("width")
    sl = slice(lo, lo + width) if width else slice(None)
    three = (ztc[:1, :, :1], ztc[1:4], ztc[4:])  # three row blocks, read in place
    calls = [(three, want_c, slot_major, ctas) for slot_major in (False, True)
             for ctas in (1, 3, 1000)]
    calls.append(((zt,), want, True, 5))
    n = width or z.shape[-1]
    vec = 1 if n % 4 or lo % 4 else 4
    for blocks, expect, slot_major, ctas in calls:
        fake = replayed(ctas)
        got = tcomp.evaluate(blocks, num_rows, lo=lo, width=width, slot_major=slot_major)
        for w, g in zip(expect, got):
            g = g.permute(2, 1, 0) if slot_major else g
            assert np.array_equal(_u(g.contiguous()), w[..., sl])
        assert cuda_witness.launch_counts["spmv"] == 1 == len(fake.calls)
        (_, mats, _, n_, _, v, nlong, grid), = fake.calls
        assert mats == 3 and n_ == n and v == vec and 1 <= grid <= ctas
        assert nlong == sum(tcomp.csr(k).nlong for k in range(3))


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c].get("dense")])
def test_instance_map_replay_and_plain_equal_jax(replayed, case):
    """The transposed orientation: eval_instance_arrays' At, Bt, Ct (u the
    Lagrange values at t, one row per constraint of the domain) from JAX ==
    plain == the replay over the transposed CSR."""
    cfg = CASES[case]
    jring, jcomp, tring, tcomp, _, _ = _system(case)
    jdom, tdom = JRootsDomain(jring, cfg["m"]), RootsDomain(tring, cfg["m"])
    jt = jdom.random_exceptional(np.random.default_rng(5))
    tt = tdom.random_exceptional(np.random.default_rng(5))
    want = jred.eval_instance_arrays(jcomp, jt.res, jdom)
    plain = tred.eval_instance_arrays(tcomp, tt.res, tdom)
    replayed(3)
    got = tred.eval_instance_arrays(tcomp, tt.res, tdom)
    for w, p, g in zip(want, plain, got):
        assert np.array_equal(_u(p), np.asarray(w)) and np.array_equal(_u(g), np.asarray(w))
    assert cuda_witness.launch_counts["spmv"] == 1


def test_derivation_refuses_out_of_range_and_wide_moduli():
    """An index outside the system is refused when its CSR is derived (and
    never later: no read of the card on a call); a modulus outside [2, 2^31)
    is refused by name."""
    ring = RingContext(primes=(_context_primes()[1],), N=1, device="cpu")
    one = torch.zeros((3, 1, 1), dtype=torch.int32)
    good, bad = torch.tensor([0, 1, 2]), torch.tensor([0, 3, 1])
    for rows, cols, which in ((bad, good, "scatter"), (good, bad, "gather"),
                              (good, torch.tensor([0, -1, 1]), "gather")):
        comp = CompiledR1CS(ctx=ring, num_constraints=3, num_variables=2, primary_input_size=1,
                            rows=(rows,) * 3, cols=(cols,) * 3, coeffs=(one,) * 3)
        with pytest.raises(IndexError, match=which):
            comp.csr(0)
    with pytest.raises(IndexError, match="scatter"):
        derive_csr(good, good, 2, 3)
    for bad_p in (0, 1, 1 << 31, (1 << 32) - 5):
        with pytest.raises(ValueError, match=f"modulus {bad_p} "):
            cuda_witness.moduli((_context_primes()[0], bad_p))


@pytest.mark.parametrize("b_kind", ["full", "slot_constant", "row_constant"])
@pytest.mark.parametrize("add", [False, True])
def test_mulmod_replay_equals_plain(replayed, b_kind, add):
    """y = a * b (+ c) mod p_l through the wrapper and the replay == the
    int64 mul_mod / add_mod, every word p - 1 in half the rows, at the
    extreme primes; in place into a (and into c)."""
    primes = _context_primes()
    ring = RingContext(primes=primes, N=1, device="cpu")
    rng = np.random.default_rng(len(b_kind) + add)
    p = np.array(primes, np.int64)[None, :, None]
    shape = (6, 2, 12)

    def words(shape):
        x = rng.integers(0, p, shape)
        return torch.from_numpy(np.where(rng.random(shape) < 0.5, p - 1, x).astype(np.int32))

    a = words(shape)
    b = {"full": words(shape), "slot_constant": words((6, 2, 1)),
         "row_constant": words((1, 2, 12))}[b_kind]
    c = words(shape) if add else None
    want = mul_mod(a, b, ring.p)
    want = add_mod(want, c, ring.p) if add else want
    fake = replayed()
    assert torch.equal(tred._mulmod(ring, a, b, c), want)
    target = c if add else a
    assert torch.equal(tred._mulmod(ring, a, b, c, out=target), want) and torch.equal(target, want)
    assert cuda_witness.launch_counts["mulmod"] == 2 and all(v for *_, v, _ in fake.calls)


# ---------------------------------------------------------------------------
# the rehearsal: every prover through the wrappers, the library replayed
# ---------------------------------------------------------------------------

def _prove(system: str, params, seed: int):
    """(keypair or None, the prove, its verifier, primary) of one prover on
    the squaring chain, M=16."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.snark import groth16, rinocchio, seeded, streamed
    from ringsnark_tpu_torch.utils import prng

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


@pytest.mark.parametrize("L,N", [(1, 16), (2, 16), (3, 1)], ids=["Rq", "Rq_L2", "Zq_L3"])
@pytest.mark.parametrize("system", ["resident", "seeded", "streamed", "streamed_rinocchio"])
def test_rehearsal_provers_through_replayed_kernels(replayed, system, L, N):
    """Each prover through the witness map's wrappers over the replayed
    library gives the plain proof bit for bit (the plain proofs equal the
    JAX package's: test_torch_groth16, _seeded, _streamed, _rinocchio),
    verifies, and launched `spmv` (and `mulmod` where M > 1)."""
    from ringsnark_tpu_torch.scripts.common import bench_params

    params = bench_params(L, N, 64, 4, 4, "cpu")
    kp, prove, verifier, primary = _prove(system, params, 50 + L)
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
    assert cuda_witness.launch_counts["spmv"] > 0 and cuda_witness.launch_counts["mulmod"] > 0
    assert len(fake.calls) == sum(cuda_witness.launch_counts[k] for k in cuda_witness.KERNELS)


@pytest.mark.parametrize("outputs", ["prover", "mid", "all"])
def test_chunked_map_equals_unchunked_through_replay(replayed, outputs):
    """Trap d: the map over windows of two slots (N=8) equals the map over
    all eight, each through the replayed kernels, and both equal the JAX
    unchunked map (prover mode: witness_map_kernel_chunked(outputs="prover")
    with zero d's; ZK: random per-slot d's)."""
    from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain

    jring = jdefault_context(L=2, N=8, order=1 << 12)
    jcomp, jprim, jaux = jsquare_chain(jring, 6, np.random.default_rng(3))
    jdom = JRootsDomain(jring, jcomp.num_constraints)
    full, io, mid = jred._assignment_batches(jring, jprim, jaux)
    rng = np.random.default_rng(4)
    if outputs == "prover":
        jd = [jnp.zeros((2, 1), jnp.uint32)] * 3
    else:
        jd = [JRingElem.random_invertible_element(jring, rng).res for _ in range(3)]
    want = jred.witness_map_kernel_chunked(jcomp, full.res, io.res, mid.res, *jd, jdom,
                                           slot_chunk=8, outputs=outputs)
    tring = RingContext(primes=jring.primes, N=8, device="cpu")
    tcomp = interop.compiled_from_numpy(tring, {
        "rows": [np.asarray(r) for r in jcomp.rows], "cols": [np.asarray(c) for c in jcomp.cols],
        "coeffs": [np.asarray(c) for c in jcomp.coeffs], "num_constraints": 6,
        "num_variables": jcomp.num_variables, "primary_input_size": jcomp.primary_input_size})
    tdom = RootsDomain(tring, 6)

    def t(x):
        return torch.from_numpy(np.array(np.asarray(x), dtype=np.uint32).view(np.int32))

    replayed()
    if outputs == "prover":
        runs = [tred.prover_witness_map_chunked(tcomp, t(jprim.res), t(jaux.res), tdom,
                                                slot_chunk=k) for k in (2, 1024)]
    else:
        td = [t(d) for d in jd]
        runs = [tred.witness_map_kernel_chunked(tcomp, t(full.res), t(io.res), t(mid.res), *td,
                                                tdom, slot_chunk=k, outputs=outputs)
                for k in (2, 1024)]
    for chunked, whole, w in zip(*runs, want):
        assert torch.equal(chunked, whole)
        assert np.array_equal(_u(chunked), np.asarray(w))
    assert cuda_witness.launch_counts["spmv"] > 0

