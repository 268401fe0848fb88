"""ringsnark_tpu_torch's threefry PRNG against jax.random, on the CPU, bit
for bit: key, split, fold_in, bits and 32-bit randint (unsigned, and signed
with a `minval`) on odd shapes, and
draws made by row range equal to the slices of the whole draw (the property
the chunked encode and the seeded MAC rely on)."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ringsnark_tpu_torch.utils import interop, prng

SHAPES = [(1,), (7,), (3, 5, 7), (2, 1, 3, 33)]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.key(seed)


def _pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, 2**62 + 11])
def test_key_split_fold_in(seed):
    jk, tk = _key(seed)
    assert _pair(jk) == tk
    assert interop.key_from_numpy(np.asarray(jk)) == tk
    assert np.array_equal(interop.key_to_numpy(tk), np.asarray(jk))
    for n in (1, 2, 3, 6):
        assert [_pair(r) for r in jax.random.split(jk, n)] == prng.split(tk, n)
    for data in (0, 1, 4095, 2**32 - 1):
        assert _pair(jax.random.fold_in(jk, data)) == prng.fold_in(tk, data)
    typed = jax.random.key(seed, impl="threefry2x32")
    assert interop.key_from_numpy(jax.random.key_data(typed)) == tk


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(shape):
    jk, tk = _key(103)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.bits(tk, shape, "cpu").numpy(), want)


@pytest.mark.parametrize("maxval", [7, 65537, 2147352577, 2147483647, 1 << 31])
@pytest.mark.parametrize("shape", SHAPES[1:3])
def test_randint(shape, maxval):
    """uint32 randint; spans above 2^16 take JAX's wrapped multiplier."""
    jk, tk = _key(5)
    want = np.asarray(jax.random.randint(jk, shape, 0, maxval, dtype=jnp.uint32))
    assert np.array_equal(prng.randint(tk, shape, maxval, "cpu").numpy(), want.astype(np.int64))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("span", [13, 1 << 16, 2147352577])
def test_randint_with_minval(span, signed):
    """A span of 13 draws the high word (the multiplier 2^32 mod 13 is not
    zero); JAX reduces the unsigned span and adds `minval` afterwards.  The
    outer BGV's error draw is the signed span 13: [-6, 7)."""
    jk, tk = _key(6)
    lo = -(span // 2) if signed else 3
    dtype = jnp.int32 if signed else jnp.uint32
    want = np.asarray(jax.random.randint(jk, (2, 1, 19), lo, lo + span, dtype=dtype))
    got = prng.randint(tk, (2, 1, 19), lo + span, "cpu", minval=lo).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got.min() >= lo and got.max() < lo + span


@pytest.mark.parametrize("axis,rows", [(0, (1, 3)), (1, (2, 5)), (2, (0, 7)), (2, (6, 7)),
                                       (1, (3, 3))])
def test_row_range_equals_slice_of_whole_draw(axis, rows):
    shape = (3, 5, 7)
    _, tk = _key(11)
    whole_bits = prng.bits(tk, shape, "cpu").numpy()
    whole_int = prng.randint(tk, shape, 2147352577, "cpu").numpy()
    sl = tuple(slice(*rows) if d == axis else slice(None) for d in range(3))
    part_bits = prng.bits(tk, shape, "cpu", rows=rows, axis=axis).numpy()
    part_int = prng.randint(tk, shape, 2147352577, "cpu", rows=rows, axis=axis).numpy()
    assert np.array_equal(part_bits, whole_bits[sl])
    assert np.array_equal(part_int, whole_int[sl])


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        prng.key(-1)
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), (2,), (1 << 31) + 1, "cpu")
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), (2,), 5, "cpu", minval=5)
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), (2,), 0, "cpu", minval=-(1 << 31) - 1)


def test_contexts_and_draws_default_to_the_card():
    """A context built without a device is on the card ("cuda:0"), without
    touching CUDA; a draw names its device, there is no CPU default."""
    import inspect

    from ringsnark_tpu_torch.rings.context import RingContext, default_context

    p = 2013265921  # 15 * 2^27 + 1: NTT-friendly for N=8
    ring = RingContext(primes=(p,), N=8)
    assert ring.device == "cuda:0"
    assert default_context().device == "cuda:0"
    assert default_context(L=1, N=8, device="cpu").device == "cpu"
    for fn in (prng.bits, prng.randint):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        prng.bits(prng.key(0), (2,))


# The threefry kernel (csrc/prng.cu) replayed in numpy with the wrapper's
# own geometry and key column (tests/prng_replay.py) equals the plain
# torch-op draws: row ranges inside an axis, a short last sub-chunk, spans
# above and below 2^16 with and without minval, unsigned values past 2^31,
# and counters above 2^32 in a view that allocates only its rows.
REPLAYED_DRAWS = {
    "bits_inner_axis": ((3, 5, 7), (1, 4), 1, 0, 0),
    "bits_whole": ((2, 1, 3, 33), None, 0, 0, 0),
    "bits_last_axis": ((3, 5, 7), (6, 7), 2, 0, 0),
    "prime_short_last_sub_chunk": ((16, 1, 64), (12, 16), 0, 2147352577, 0),
    "prime_lo_not_0": ((16, 2, 64), (5, 9), 0, 2147352577, 0),
    "span_2e16": ((4, 3, 40), (1, 3), 0, 1 << 16, 0),
    "fhe_signed_span_13": ((4, 1, 50), None, 0, 13, -6),
    "unsigned_past_2e31": ((3, 70), (1, 3), 0, 1 << 31, (1 << 31) - 7),
    "counter_past_2e32_bits": ((1 << 20, 1 << 13), ((1 << 20) - 3, 1 << 20), 0, 0, 0),
    "counter_past_2e32_prime": ((1 << 20, 1 << 13), ((1 << 20) - 2, 1 << 20), 0, 2147352577, 0),
    "counter_past_2e32_span_13": ((2, 1 << 31, 3), (1 << 30, (1 << 30) + 2), 1, 13, -6),
}


@pytest.mark.parametrize("case", list(REPLAYED_DRAWS))
def test_kernel_replay_equals_plain_draw(case):
    import prng_replay

    from ringsnark_tpu_torch.ops import cuda_prng

    shape, rows, axis, span, minval = REPLAYED_DRAWS[case]
    _, tk = _key(40 + list(REPLAYED_DRAWS).index(case))
    geo = cuda_prng.geometry(shape, rows, axis)
    got = prng_replay.draw([cuda_prng.column(tk, span, minval)], geo).astype(np.int64)
    if span:
        want = prng.randint(tk, shape, minval + span, "cpu", rows=rows, axis=axis,
                            minval=minval).numpy()
        want = want & 0xFFFFFFFF  # the kernel's uint32 words
    else:
        want = prng.bits(tk, shape, "cpu", rows=rows, axis=axis).numpy()
    assert np.array_equal(got.reshape(want.shape), want)
    if math.prod(shape) > 0xFFFFFFFF:
        assert (geo.outer * geo.n_axis * geo.A * geo.I) > 1 << 32 and want.size < 1 << 16


SASS = """
        Function : _ZN39_GLOBAL__N__cd773981_7_prng_cu_7401b96114encrypt_kernelILb0EEEvPjS1_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R4, R2, R3, RZ ;
        /*0020*/              @!P0 BRA 0x60 ;
        /*0030*/                   SHF.L.W.U32.HI R5, R4, 0xd, R4 ;
        /*0040*/                   IMAD.IADD R6, R5, 0x1, R4 ;
        /*0050*/                   POPC R7, R6 ;
        /*0060*/                   LOP3.LUT R5, R6, R5, RZ, 0x3c, !PT ;
        /*0070*/                   STG.E desc[UR4][R8.64], R5 ;
        /*0080*/               @P1 BRA 0x30 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0 ;
        Function : _ZN38_GLOBAL__N__e8257140_6_ntt_cu_650b0a3510ntt_kernelILb1EEEvPKj
        /*0000*/                   EXIT ;
"""


def test_sass_mix_reads_kernels_and_loops():
    """scripts/sass_mix on a listing in cuobjdump's form: the kernels it
    reads by name and template arguments (the NTT's too), the innermost
    loop of a backward branch (not the trap that branches to itself), the
    instructions by pipe, rotations and stores."""
    from ringsnark_tpu_torch.scripts import sass_mix

    funcs = sass_mix.functions(SASS)
    assert list(funcs) == ["encrypt_kernel<0>", "ntt_kernel<1>"]
    assert sass_mix.ntt_parts("ntt_kernel<1>", funcs["ntt_kernel<1>"])["loops"] == []
    insns = funcs["encrypt_kernel<0>"]
    assert sass_mix.innermost_loops(insns) == [(0x30, 0x80)]
    loop = sass_mix.mix([(a, t) for a, t in insns if 0x30 <= a <= 0x80])
    assert loop == {"instructions": 6, "alu": 2, "fma": 1, "xu": 1, "mem": 1, "uniform": 0,
                    "control": 1, "other": 0, "rotations": 1, "stores": 1}
    assert sass_mix.mix(insns)["instructions"] == 11


NTT_SASS = """
        Function : _ZN38_GLOBAL__N__e8257140_6_ntt_cu_650b0a3510ntt_kernelILb0ELi14EEEvPKj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.EF R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*0030*/                   IMAD.HI.U32 R5, R4, R9, RZ ;
        /*0040*/                   VIMNMX.U32 R5, R5, R4, PT ;
        /*0050*/                   STS [R12], R5 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   LDS.128 R12, [R13] ;
        /*0080*/                   STS.128 [R13], R12 ;
        /*0090*/                   SHFL.BFLY PT, R5, R5, 0x1, 0x1f ;
        /*00a0*/                   STG.E.EF.128 desc[UR4][R2.64], R12 ;
        /*00b0*/               @P0 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_mix_reads_the_ntt_kernel():
    """scripts/sass_mix's NTT report: each loop's shared and global loads
    and stores as instructions and 32-bit words (a 128-bit access moves
    four), barriers and shuffles, per residue of a pass, the residues being
    the words the pass stores to device memory."""
    from ringsnark_tpu_torch.scripts import sass_mix

    funcs = sass_mix.functions(NTT_SASS)
    assert list(funcs) == ["ntt_kernel<0,14>"]
    parts = sass_mix.ntt_parts("ntt_kernel<0,14>", funcs["ntt_kernel<0,14>"])
    assert parts["kernel"] == {"lds": 1, "lds_words": 4, "sts": 2, "sts_words": 5, "ldg": 2,
                               "ldg_words": 5, "stg": 1, "stg_words": 4, "bar": 1, "shfl": 1}
    (loop,) = parts["loops"]
    assert (loop["first"], loop["last"], loop["residues"]) == ("0x10", "0xb0", 4)
    assert loop["per_residue"]["instructions"] == 11 / 4
    assert loop["per_residue"]["fma"] == 1 / 4 and loop["per_residue"]["alu"] == 1 / 4
    assert sass_mix.ntt_parts("lift_kernel<1,0>", funcs["ntt_kernel<0,14>"]) == {}


def _lift_sass() -> str:
    """A lift_kernel<1,0> listing: a straight draw of two coefficients (80
    rotations, 80 xors, 60 IMAD adds, 4 popcounts) between a branch and the
    column loop (4 stores, 10 ALU, 8 IMAD a pass), then a general draw's
    loop (40 rotations a pass) and a straight run of one column's store."""
    lines, addr = [], 0

    def emit(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 0x10
        return addr - 0x10

    emit("LDC R1, c[0x0][0x28]")
    emit("@P0 BRA 0x{end:x}")
    for _ in range(80):
        emit("SHF.L.W.U32.HI R5, R4, 0xd, R4")
        emit("LOP3.LUT R5, R6, R5, RZ, 0x3c, !PT")
    for _ in range(60):
        emit("IMAD R6, R5, R7, R4")
    for _ in range(4):
        emit("POPC R7, R6")
    col = emit("LDG.E.128.CONSTANT R8, desc[UR4][R2.64]")
    for _ in range(10):
        emit("IMNMX.U32 R9, R9, R10, PT")
    for _ in range(8):
        emit("IMAD R9, R9, R11, R12")
    for _ in range(4):
        emit("STG.E desc[UR4][R2.64], R9")
    emit(f"@P1 BRA 0x{col:x}")
    words = emit("IADD3 R4, R4, 0x1, RZ")
    for _ in range(40):
        emit("SHF.L.W.U32.HI R5, R4, 0xd, R4")
    emit(f"@P2 BRA 0x{words:x}")
    end = emit("ISETP.GE.AND P0, PT, R4, R5, PT")
    emit("STG.E desc[UR4][R2.64], R9")
    emit("EXIT")
    emit(f"BRA 0x{addr:x}")
    body = "\n".join(lines).replace("{end:x}", f"{end:x}")
    return ("\n        Function : _ZN39_GLOBAL__N__cd773981_7_prng_cu_7401b96111lift_kernel"
            "ILb1ELb0EEEvPjPKjPK5uint47LiftGeo3Cbd\n" + body + "\n")


def test_sass_mix_reads_the_lift_draw_and_columns():
    """scripts/sass_mix gives lift_kernel's draw per coefficient from its
    straight run with the most rotations (40 a coefficient), its columns
    per store from the loop that stores and from a straight run that
    stores, and a hashing loop per coefficient-word."""
    from ringsnark_tpu_torch.scripts import sass_mix

    insns = sass_mix.functions(_lift_sass())["lift_kernel<1,0>"]
    loops = sass_mix.innermost_loops(insns)
    assert len(loops) == 2
    parts = sass_mix.lift_parts("lift_kernel<1,0>", insns, loops)
    draw = parts["draw"]
    assert draw["coefficients"] == 2
    assert draw["per_coefficient"]["alu"] == 80 and draw["per_coefficient"]["fma"] == 30
    assert draw["per_coefficient"]["xu"] == 2
    loop_cols, run_cols = parts["columns"]
    assert loop_cols["loop"] and loop_cols["stores"] == 4
    assert loop_cols["per_column"]["alu"] == 10 / 4 and loop_cols["per_column"]["fma"] == 2
    assert not run_cols["loop"] and run_cols["stores"] == 1 and run_cols["per_column"]["alu"] == 1
    assert parts["column"] == loop_cols
    (words,) = parts["loops"]
    assert words["label"] == "draw_words" and words["per_coefficient_word"]["alu"] == 41
    assert sass_mix.lift_parts("encrypt_kernel<0>", insns, loops) == {}


@pytest.mark.parametrize("ops,nbytes,want", [
    (dict(alu=44, fma=5, either=33), 8, "alu"),  # the encryption a word: the ALU binds
    (dict(alu=1, fma=7), 0, "fma"),  # a MAC term: the multiplier binds
    (dict(alu=30, fma=30, either=60), 0, "issue"),  # balanced: one instruction a lane a clock
    (dict(popc=8), 0, "popc"),
    (dict(alu=1), 4000, "bytes"),
], ids=["alu", "fma", "issue", "popc", "bytes"])
def test_chip_smoke_bound_takes_the_busiest_pipe(ops, nbytes, want):
    """chip_smoke's bound: the larger of the bytes at the memory rate and
    the busiest of the ALU, the FMA pipe's multiplier, popcount and the
    issue rate, two-input adds spread over both pipes."""
    import chip_smoke as cs

    o = cs.Ops(**ops)
    times = {"alu": o.alu / cs.ALU_OPS_PER_S, "fma": o.fma / cs.FMA_OPS_PER_S,
             "popc": o.popc / cs.POPC_OPS_PER_S, "issue": sum(o) / cs.ISSUE_OPS_PER_S,
             "bytes": nbytes / cs.HBM_BYTES_PER_S}
    assert max(times, key=times.get) == want
    ms, by = cs.prng_bound(o, nbytes)
    assert ms == max(times.values()) * 1e3 and by == ("bytes" if want == "bytes" else "operations")
    assert 2 * cs.HASH + cs.MOD == cs.Ops(alu=83, fma=2, either=62)


def test_chip_smoke_lift_error_column_counted_at_its_least():
    """The lift's column with the error counts what the kernel's design
    needs: the two minimums on the ALU and the multiply-adds by big, neg
    and sgn on the FMA pipe, below the count with its steps as selects.  At
    the north star's sub-chunk (512 rows, L' = 4, N' = 16384, one word a
    side) the operations need 0.0473 ms and the bytes 0.0501 ms, so the
    bytes bind; counted as selects the ALU would (0.0551 ms)."""
    import chip_smoke as cs

    assert cs.LIFT_ERROR_COLUMN == cs.Ops(alu=2, fma=6, either=1)
    assert cs.SELECT_LIFT_ERROR_COLUMN == cs.Ops(alu=6, fma=3, either=4)
    coeffs, Lp = 512 * 16384, 4
    one = cs.cbd_ops(1) + cs.LIFT_COEFF + cs.LIFT_SIGN + Lp * cs.LIFT_ERROR_COLUMN
    assert one == cs.Ops(alu=94, fma=26, either=67, popc=2)
    least = coeffs * one
    select = coeffs * (cs.cbd_ops(1) + cs.LIFT_COEFF + Lp * cs.SELECT_LIFT_ERROR_COLUMN)
    nbytes = 4 * coeffs + 4 * coeffs * Lp
    assert cs.ops_seconds(least) * 1e3 == pytest.approx(0.04733, abs=1e-5)
    ms, by = cs.prng_bound(least, nbytes)
    assert by == "bytes" and ms == pytest.approx(0.05008, abs=1e-5)
    ms, by = cs.prng_bound(select, nbytes)
    assert by == "operations" and ms == pytest.approx(0.05509, abs=1e-5)
