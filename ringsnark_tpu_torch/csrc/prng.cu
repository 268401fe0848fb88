// Threefry-2x32 draws and symmetric-BGV encryption, for Hopper (sm_90a).
//
// Replaces what ringsnark_tpu_torch writes as int64 torch ops, the plain
// versions (utils/prng.py: bits, randint; encoding/bgv.py: _uniform_plain,
// _error_coeffs_plain, _lift_centered, _lift_error_plain, _encrypt_from_u),
// the counterpart of the JAX package's jax.random draws, lift and
// encryption in ringsnark_tpu/encoding/bgv.py (`_lift_centered` :49,
// `_sample_uniform` :85, `_sample_error_ntt` :110, `_encrypt_from_m` :159).
// The JAX package has no Pallas kernel for them: XLA fuses its threefry.
//
// Contract (bit for bit the plain versions' and jax.random's under
// jax_threefry_partitionable=True): element j (flat, row-major) of a draw
// of shape S under the key k is y0 ^ y1 of threefry2x32(k, (j >> 32,
// j & 0xFFFFFFFF)), j the index in the *whole* S, so a launch that makes
// rows [lo, lo + R) of one axis of S gives the slice of the whole draw.
// randint(k, S, minval, minval + span) draws two such words per value, from
// (k_hi, k_lo) = split(k), and reduces them in uint32 as JAX does: off =
// lo_word mod span; where mult = ((2^16 mod span)^2 mod 2^32) mod span is
// not 0 (spans of 2^16 or less), off = ((hi_word mod span) * mult + off)
// mod span; then + minval.  For spans above 2^16 (every inner prime Q_j)
// mult is 0 and the high word is not drawn.
//
// Geometry (ops/cuda_prng.geometry): the whole draw is viewed as
// [outer, n_axis, A, I], the launch's rows on n_axis; word (o, r, a, i)
// has the counter o * step + ((lo + r) * A + a) * I + i, step = n_axis * A
// * I, in 64 bits.  Key column c (a table of at most kMaxCols columns: the
// L' inner primes of an encryption) sits between a and i in the output:
// out[o][r][a][c][i].  A line is the I words of one (o, r, a, c).
//
// Kernels:
// * draw_kernel: the uint32 words (span 0: `bits`) or randint values of
//   every column: prng.bits, prng.randint and the uniform mask a of an
//   encryption (column j: randint mod Q_j under split(k_a, L')[j]).
// * cbd_kernel: the centred-binomial error, k = 21 at sigma = 3.2: the
//   words of bits(k_e, (2, n_words, slab, L, N')) (outer = 2 * n_words at a
//   stride of `slab` rows), the last word of a side masked to k - 32 *
//   (n_words - 1) bits, popcount of side 0 minus side 1, written as its
//   residue mod every Q_j (coefficient form).  No path launches it since
//   lift_kernel draws the error (scripts/bench_encode_profile; held in
//   chip_smoke phase 2d).
// * lift_kernel: the plaintext's centred lift into every Q_j
//   (bgv._lift_centered's two conditional steps) and, with kError, plus
//   t_l * e mod Q_j for the CBD error drawn as cbd_kernel draws it (one
//   draw a coefficient, written as its L' residues): u = lift(pt) + t*e,
//   which one forward NTT takes to NTT(m) + t*NTT(e).  (It replaces a
//   lift kernel that redid the limb's work in every column: the line and
//   its limb, v > t/2, the constants' load, a 64-bit offset and the
//   error's residue from its sign.)
// * encrypt_kernel: c0 = u_ntt - a*s mod Q_j, c1 = a where the caller keeps
//   it, the uniform mask a drawn in registers.  The NTT is linear mod Q_j
//   and every residue canonical, so c0 = NTT(lift(pt) + t*e) - a*s is
//   m - a*s + t*NTT(e) bit for bit: one NTT an encryption, not two, and no
//   error tensor between the kernels.  (It replaces an encryption kernel
//   that read m and the error's NTT and always wrote c1.)
//
// What bounds them on this card: integer operations on the ALU.  A hash
// is 20 rounds of add, rotate (one funnel shift) and xor plus six key
// injections; its 20 rotations and 21 xors run only on the ALU (64 lanes
// an SM), its 31 adds on the ALU or the FMA pipe beside it, so one 32-bit
// word takes 41 ALU slots against 4 bytes of writing it: about twice as
// long as the bytes.  The lift without error moves 4 + 4 L' bytes a
// coefficient and is bound by them; with the error it hashes 2 n_words
// words a coefficient, and each of its L' columns needs a multiply-add by
// v > t/2, a Shoup product and two minimums.  The encryption hashes one
// word, reads u and writes
// c0 (and c1): 44 ALU slots a word against 8 (12) bytes, so the
// operations bind c0 alone and the bytes c0 with c1 (chip_smoke.py's Ops
// counts them; scripts/sass_mix.py prints what the compiler issues).
// What the design does about it: everything in
// registers, no shared memory; the rotations are funnel shifts and the
// round constants immediates; mod span is a multiply-high with a host
// constant mu = floor(2^32 / span) and one conditional subtract, never a
// division; the key table rides in the launch's parameters
// (__grid_constant__), so a launch needs no copy to the device.  The lift
// with its error steers the hash's 31 adds onto the FMA pipe
// (threefry.cuh's add, the key's injections hoisted into HashKey on the
// host), so the ALU issues only the 41 rotations and xors of a word, and
// draws one word a side (k <= 32, every context's) with no loop, a
// thread's 2 kPer hashes in lockstep.  Where a line holds a CTA's block
// (every path's N'), the thread's kPer coefficients share their line, so
// the limb's constants, t/2 and the counters' high words are the
// thread's; v > t/2 and the error's sign are taken once a coefficient and
// enter every column as multiply-adds (lift_word), and stores use 32-bit
// offsets and immediates.  The encryption keeps the compiler's adds
// (threefry_hl): with the injections' sums hoisted for the FMA pipe it
// spilled 12-16 bytes at its 80 registers a thread.  The
// encryption kernel is persistent: as many CTAs as the device keeps
// resident (three an SM at 80 registers a thread; the launcher reads the
// occupancy) each take an equal run of (tile, row) units, a tile being one
// (limb a, prime c, slice of kEncThreads * kEncWords words), rows fastest.
// A tile's column key and mu stay in registers, and a span above 2^16 (every
// inner prime) takes a loop with no test a word.  A thread
// holds its 8 words' s pairs in registers for all the rows of a tile, so s
// is read once a tile, not once a row; the next row's u is loaded into
// registers before this row's hashes run (software pipelining in
// registers: a word is used once, by the thread that loads it, so a
// cp.async ring in shared memory only adds a copy, and it was slower in a
// trial); the counter's low word advances by A * I a row
// with one carry test (a line's counters start at a multiple of I, a power
// of two, so no word of a line carries).  Stores follow the next reader:
// with c1 (the streamed loop, whose MAC reads c0 and c1 at once, and
// encode) plain write-back stores; without (the seeded setup, whose c0
// goes into the CRS and is not read again there) evict-first stores.
//
// C interface: ringsnark_prng_draw, ringsnark_prng_cbd, ringsnark_prng_lift
// and ringsnark_prng_encrypt return cudaGetLastError() after the launch (0
// on success) or cudaErrorInvalidValue for a configuration they refuse; the
// Python wrapper (ops/cuda_prng.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "modarith.cuh"  // reduce_once, add_mod, sub_mod, shoup_mul, refused
#include "threefry.cuh"  // Column, Columns, HashKey, threefry_n, draw_value, cbd_value, columns_of

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // words a thread a line, kThreads apart
constexpr unsigned kMaxGridY = 65535;

struct Moduli {
  uint32_t q[kMaxCols];
};

struct Geo {
  uint64_t step;  // counter distance between outer blocks: n_axis * A * I
  uint64_t base;  // counter of row lo: lo * A * I
  uint32_t R, A, C, I;  // rows drawn, positions a, key columns, words a line
  uint32_t L;  // outer limbs: s is indexed by a mod L
  uint32_t lines;  // lines of the launch
};

// The first word of this thread in a line; the line of blockIdx.y.
__device__ __forceinline__ uint32_t first_word() {
  return blockIdx.x * (kThreads * kPer) + threadIdx.x;
}

__global__ void __launch_bounds__(kThreads)
    draw_kernel(uint32_t* __restrict__ out, const __grid_constant__ Columns cols, Geo g) {
  // line = ((o R + r) A + a) C + c
  for (uint32_t line = blockIdx.y; line < g.lines; line += gridDim.y) {
    const uint32_t c = line % g.C;
    uint32_t t = line / g.C;
    const uint32_t a = t % g.A;
    t /= g.A;
    const uint32_t r = t % g.R;
    const uint32_t o = t / g.R;
    const Column& col = cols.c[c];
    const uint64_t ctr = o * g.step + g.base + (static_cast<uint64_t>(r) * g.A + a) * g.I;
    uint32_t* dst = out + static_cast<size_t>(line) * g.I;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t i = first_word() + k * kThreads;
      if (i < g.I) dst[i] = draw_value(col, ctr + i);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cbd_kernel(uint32_t* __restrict__ out, const __grid_constant__ Moduli q, uint32_t k0,
               uint32_t k1, uint32_t n_words, uint32_t last_mask, Geo g) {
  // line = r A + a; the outer blocks (side, word) are summed, not written
  const HashKey key = hash_key(k0, k1);
  for (uint32_t line = blockIdx.y; line < g.lines; line += gridDim.y) {
    const uint32_t a = line % g.A;
    const uint32_t r = line / g.A;
    const uint64_t ctr = g.base + (static_cast<uint64_t>(r) * g.A + a) * g.I;
    uint32_t* dst = out + static_cast<size_t>(line) * g.C * g.I;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t i = first_word() + k * kThreads;
      if (i >= g.I) continue;
      const int e = cbd_value<false>(key, ctr + i, g.step, n_words, last_mask, 1u);
      for (uint32_t c = 0; c < g.C; ++c) {
        dst[static_cast<size_t>(c) * g.I + i] =
            e < 0 ? q.q[c] - static_cast<uint32_t>(-e) : static_cast<uint32_t>(e);
      }
    }
  }
}

// The error of a lift: the key k_e with its injections hoisted (made on the
// host) and cbd_kernel's counters (step, base); `one` is 1 (threefry.cuh's
// add: the hash's adds on the FMA pipe).
struct Cbd {
  uint64_t step, base;
  HashKey key;
  uint32_t n_words, last_mask, one;
};

struct LiftGeo {
  uint32_t n;      // coefficients of the launch: rows * A * I, below 2^32
  uint32_t log_i;  // I = 2^log_i coefficients a line (r, a)
  uint32_t A, C, Cs;  // outer limbs; columns written; columns of a constants row
};

constexpr int kLiftLog = 10;  // a CTA's coefficients, kThreads * kPer = 2^kLiftLog
static_assert((1 << kLiftLog) == kThreads * kPer, "a CTA's block is a power of two");

// The sign of a coefficient's error e, taken once: neg = e < 0 (0 or 1),
// sgn = 1 - 2 neg (+-1 as a 32-bit word), mag = |e|.
struct Sign {
  uint32_t neg, sgn, mag;
};

__device__ __forceinline__ Sign sign_of(int e) {
  const uint32_t neg = static_cast<uint32_t>(e) >> 31;
  const uint32_t sgn = 1u - 2u * neg;
  return Sign{neg, sgn, static_cast<uint32_t>(e) * sgn};
}

// One coefficient v < t < 2^31 in one column kk = (Q - t as a 32-bit word,
// Q, t mod Q, its Shoup constant), with big = (v > t/2), 0 or 1, taken
// once a coefficient.  x = v + big (Q - t) is bgv._lift_centered's first
// step; without the error its second, x >= Q ? x - Q : x in signed 32-bit
// words, where both equal the plain version's int64 bit for bit (x lies in
// (-2^31, 2^31)).  With the error t <= 2 Q, and t is odd (an EncodingContext's
// plain moduli are 1 mod 2N'), so t < 2 Q and x is already v's residue, in
// [0, Q): no second step.  Then t e = sgn (t |e| mod Q) and x + neg Q + sgn
// (t |e| mod Q) lies in [0, 2 Q): one conditional subtract.  The multiplies
// by big, neg and sgn are IMADs (imad), so the column's ALU work is the two
// minimums.
template <bool kError>
__device__ __forceinline__ uint32_t lift_word(uint32_t v, uint32_t big, const Sign& s,
                                              const uint4& kk) {
  const uint32_t q = kk.y;
  const uint32_t x = imad(big, kk.x, v);
  if constexpr (!kError) {
    return static_cast<int32_t>(x) >= static_cast<int32_t>(q) ? x - q : x;
  } else {
    const uint32_t te = shoup_mul(s.mag, make_uint2(kk.z, kk.w), q);  // t |e| mod Q
    return reduce_once(imad(s.sgn, te, imad(s.neg, q, x)), q);
  }
}

// v > t/2 as 0 or 1, for v, t/2 < 2^31: the sign bit of t/2 - v.
__device__ __forceinline__ uint32_t big_of(uint32_t v, uint32_t half) { return (half - v) >> 31; }

// Where a line holds at least a CTA's block (I >= 2^kLiftLog: every path's
// N' from 4096 up), the CTA's kPer * kThreads coefficients are one line's:
// the line, its limb's constants row and t/2 are the thread's, the error's
// counters of a side share their high word (a line's counters start at a
// multiple of I, so no word of a block carries), and a thread's column
// stores are one 32-bit offset and immediates.  The kPer coefficients'
// 2 kPer hashes (one word a side) run in lockstep; a thread's columns take
// their constants once, for all kPer coefficients.
template <bool kError, bool kScalar>
__device__ __forceinline__ void lift_block(uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ pt,
                                           const uint4* __restrict__ k, const LiftGeo& g,
                                           const Cbd& cbd) {
  const uint32_t x0 = blockIdx.x * (kThreads * kPer) + threadIdx.x;  // coefficient j: + j kThreads
  const uint32_t line = x0 >> g.log_i;
  const uint32_t i0 = x0 & ((1u << g.log_i) - 1);
  const uint4* kc = k + (line % g.A) * g.Cs;
  const uint4 k0 = __ldg(kc);
  const uint32_t half = (k0.y - k0.x) >> 1;  // t/2: Q - (Q - t)
  uint32_t v[kPer], big[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = kScalar ? (j == 0 && i0 == 0 ? __ldg(pt + line) : 0u) : __ldg(pt + x0 + j * kThreads);
    big[j] = big_of(v[j], half);
  }
  Sign s[kPer] = {};
  if constexpr (kError) {
    const uint64_t c0 = cbd.base + x0, c1 = c0 + cbd.step;  // word 0 of sides 0 and 1
    if (cbd.n_words == 1) {
      // each side's x0 = hi + k0, added once for its kPer counters
      const uint32_t h0 = static_cast<uint32_t>(c0 >> 32) + cbd.key.k0;
      const uint32_t h1 = static_cast<uint32_t>(c1 >> 32) + cbd.key.k0;
      uint32_t h[2 * kPer], lo[2 * kPer], y[2 * kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = h0;
        lo[j] = static_cast<uint32_t>(c0) + j * kThreads;
        h[kPer + j] = h1;
        lo[kPer + j] = static_cast<uint32_t>(c1) + j * kThreads;
      }
      threefry_n<true, 2 * kPer>(cbd.key, h, lo, cbd.one, y);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] = sign_of(__popc(y[j] & cbd.last_mask) - __popc(y[kPer + j] & cbd.last_mask));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] = sign_of(cbd_value<true>(cbd.key, c0 + j * kThreads, cbd.step, cbd.n_words,
                                       cbd.last_mask, cbd.one));
      }
    }
  }
  uint32_t off = ((line * g.C) << g.log_i) + i0;
  for (uint32_t c = 0; c < g.C; ++c, off += 1u << g.log_i) {
    const uint4 kk = __ldg(kc + c);
    uint32_t* __restrict__ dst = out + off;
#pragma unroll
    for (int j = 0; j < kPer; ++j) dst[j * kThreads] = lift_word<kError>(v[j], big[j], s[j], kk);
  }
}

// Lines shorter than a CTA's block (the test sizes, the Z_q operand's I = 1):
// each coefficient its own line, constants and counter.
template <bool kError, bool kScalar>
__device__ __forceinline__ void lift_lines(uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ pt,
                                           const uint4* __restrict__ k, const LiftGeo& g,
                                           const Cbd& cbd) {
  const uint32_t mask = (1u << g.log_i) - 1;
  const uint32_t b = blockIdx.x * (kThreads * kPer);  // below n: no 32-bit wrap past it
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j * kThreads + threadIdx.x >= g.n - b) break;
    const uint32_t x = b + j * kThreads + threadIdx.x;
    const uint32_t line = x >> g.log_i;
    const uint32_t i = x & mask;
    const uint4* kc = k + (line % g.A) * g.Cs;
    const uint4 k0 = __ldg(kc);
    const uint32_t v = kScalar ? (i == 0 ? __ldg(pt + line) : 0u) : __ldg(pt + x);
    const uint32_t big = big_of(v, (k0.y - k0.x) >> 1);
    const Sign s = kError ? sign_of(cbd_value<true>(cbd.key, cbd.base + x, cbd.step,
                                                    cbd.n_words, cbd.last_mask, cbd.one))
                          : Sign{};
    uint32_t* __restrict__ dst = out + ((line * g.C) << g.log_i) + i;
    for (uint32_t c = 0; c < g.C; ++c) {
      dst[c << g.log_i] = lift_word<kError>(v, big, s, __ldg(kc + c));
    }
  }
}

// out[r][a][c][i] = lift(pt) (+ t_a * e mod Q_c with kError); pt [R, A, I],
// or [R, A] with kScalar (the coefficient at i = 0, zero beyond); k[a][c] =
// (Q_c - t_a as a 32-bit word, Q_c, t_a mod Q_c, its Shoup constant).
// Coefficient x = (r A + a) I + i, the error's counter base + x
// (cbd_kernel's, the error's rows being the launch's), drawn once a
// coefficient and written as its C residues; a thread takes kPer
// coefficients kThreads apart; 32-bit offsets (fewer than 2^32 words out).
template <bool kError, bool kScalar>
__global__ void __launch_bounds__(kThreads)
    lift_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ pt,
                const uint4* __restrict__ k, LiftGeo g, const __grid_constant__ Cbd cbd) {
  if (g.log_i >= kLiftLog) {
    lift_block<kError, kScalar>(out, pt, k, g, cbd);
  } else {
    lift_lines<kError, kScalar>(out, pt, k, g, cbd);
  }
}

constexpr int kEncThreads = 256;
constexpr int kEncWords = 8;  // words a thread holds, kEncThreads apart
constexpr int kEncCtasPerSm = 3;  // the registers a thread may hold: 80 of 255
constexpr uint32_t kEncTile = kEncThreads * kEncWords;  // words of a tile's slice of I

struct EncGeo {
  uint64_t base;   // counter of the launch's row 0: lo * A * I
  uint64_t units;  // (tile, row) units: A * C * slices * R
  uint32_t R, A, C, I, L, slices;
};

// c0 = u - a*s mod Q_c and, with kC1, c1 = a, for the units [b U / grid,
// (b + 1) U / grid) of CTA b: unit = tile * R + r, tile = (a C + c) *
// slices + slice.  u, c0, c1 [R, A, C, I]; s pairs [L, C, I] (limb a mod
// L); word i of row r has the counter base + (r A + a) I + i.
template <bool kC1>
__global__ void __launch_bounds__(kEncThreads, kEncCtasPerSm)
    encrypt_kernel(uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                   const uint32_t* __restrict__ u, const uint2* __restrict__ s,
                   const __grid_constant__ Columns cols, EncGeo g) {
  const uint64_t end = g.units * (blockIdx.x + 1) / gridDim.x;
  const size_t row_words = static_cast<size_t>(g.A) * g.C * g.I;
  const uint32_t row_ctr = g.A * g.I;  // counter distance between rows
  for (uint64_t unit = g.units * blockIdx.x / gridDim.x; unit < end;) {
    const uint32_t tile = static_cast<uint32_t>(unit / g.R);
    const uint32_t r = static_cast<uint32_t>(unit % g.R);
    const uint64_t left = end - unit;  // rows of this tile in the CTA's run
    const uint32_t n = left < g.R - r ? static_cast<uint32_t>(left) : g.R - r;
    unit += n;
    const uint32_t slice = tile % g.slices;
    const uint32_t c = (tile / g.slices) % g.C;
    const uint32_t a = tile / g.slices / g.C;
    const Column& col = cols.c[c];
    const uint32_t Q = col.span;
    const uint32_t i0 = slice * kEncTile + threadIdx.x;
    // this thread's words of s, kept for every row of the tile
    const uint2* srow = s + static_cast<size_t>((a % g.L) * g.C + c) * g.I;
    uint2 sv[kEncWords];
#pragma unroll
    for (int j = 0; j < kEncWords; ++j) {
      const uint32_t i = i0 + j * kEncThreads;
      sv[j] = i < g.I ? __ldg(srow + i) : make_uint2(0u, 0u);
    }
    size_t off = ((static_cast<size_t>(r) * g.A + a) * g.C + c) * g.I + i0;
    const uint64_t ctr = g.base + (static_cast<uint64_t>(r) * g.A + a) * g.I + i0;
    uint32_t lo = static_cast<uint32_t>(ctr), hi = static_cast<uint32_t>(ctr >> 32);
    uint32_t cur[kEncWords], nxt[kEncWords];
#pragma unroll
    for (int j = 0; j < kEncWords; ++j) {
      cur[j] = i0 + j * kEncThreads < g.I ? __ldg(u + off + j * kEncThreads) : 0u;
    }
    // The rows of the tile.  A span above 2^16 (every inner prime) draws
    // one word and has no minval: that loop keeps the column's key and mu
    // in registers and tests nothing a word; any other column takes
    // draw_value_hl whole.
    const auto rows = [&](auto one_word) {
      const uint32_t k0 = col.lo0, k1 = col.lo1, mu = col.mu;
      for (uint32_t k = 0; k < n; ++k) {
        const bool more = k + 1 < n;
#pragma unroll
        for (int j = 0; j < kEncWords; ++j) {  // the next row's u, in flight during the hashes
          nxt[j] = more && i0 + j * kEncThreads < g.I
                       ? __ldg(u + off + row_words + j * kEncThreads) : 0u;
        }
#pragma unroll
        for (int j = 0; j < kEncWords; ++j) {
          const uint32_t w = lo + j * kEncThreads;
          const uint32_t av = decltype(one_word)::value
                                  ? mod_span(threefry_hl(k0, k1, hi, w), Q, mu)
                                  : draw_value_hl(col, hi, w);
          const uint32_t v = sub_mod(cur[j], shoup_mul(av, sv[j], Q), Q);
          if (i0 + j * kEncThreads < g.I) {
            if (kC1) {
              c0[off + j * kEncThreads] = v;
              c1[off + j * kEncThreads] = av;
            } else {
              __stcs(c0 + off + j * kEncThreads, v);
            }
          }
          cur[j] = nxt[j];
        }
        off += row_words;
        lo += row_ctr;
        hi += lo < row_ctr;  // the row's one carry test
      }
    };
    if (col.mult == 0 && col.minval == 0) {
      rows(std::true_type{});
    } else {
      rows(std::false_type{});
    }
  }
}

// The geometry of a launch, or false where the launch is refused: every
// extent positive and below 2^31, the rows inside the axis, every counter
// of the whole draw below 2^64, 1 to kMaxCols columns, the lines of the
// launch below 2^31 and its words below 2^31, or 2^32 where `words32` (the
// lift's unsigned 32-bit offsets).  A line spans the outer blocks and the
// columns or not, as the kernel writes them.
bool make_geo(long long outer, long long n_axis, long long lo, long long rows, long long A,
              long long I, int C, int L, bool lines_over_outer, bool lines_over_cols,
              Geo& g, bool words32 = false) {
  using u128 = unsigned __int128;
  const long long limit = 1LL << 31;
  if (outer < 1 || outer >= limit || rows < 1 || rows >= limit || A < 1 || A >= limit ||
      I < 1 || I >= limit || C < 1 || C > kMaxCols || L < 1 || n_axis < rows || lo < 0 ||
      lo > n_axis - rows) {
    return false;
  }
  const u128 counters = static_cast<u128>(outer) * static_cast<u128>(n_axis);
  if (counters > (static_cast<u128>(1) << 64) ||
      counters * static_cast<u128>(A) * static_cast<u128>(I) > (static_cast<u128>(1) << 64)) {
    return false;
  }
  const u128 lines = static_cast<u128>(lines_over_outer ? outer : 1) * rows * A *
                     (lines_over_cols ? C : 1);
  const u128 words = lines * static_cast<u128>(I) * (lines_over_cols ? 1 : C);
  if (lines >= static_cast<u128>(limit) ||
      words >= static_cast<u128>(limit) << (words32 ? 1 : 0)) {
    return false;
  }
  g.step = static_cast<uint64_t>(n_axis) * A * I;
  g.base = static_cast<uint64_t>(lo) * A * I;
  g.R = static_cast<uint32_t>(rows);
  g.A = static_cast<uint32_t>(A);
  g.C = static_cast<uint32_t>(C);
  g.I = static_cast<uint32_t>(I);
  g.L = static_cast<uint32_t>(L);
  g.lines = static_cast<uint32_t>(lines);
  return true;
}

dim3 grid_of(const Geo& g) {
  return dim3((g.I + kThreads * kPer - 1) / (kThreads * kPer), g.lines < kMaxGridY ? g.lines
                                                                                    : kMaxGridY);
}

}  // namespace

// out: uint32 [outer, rows, A, C, I]; table: host uint32 [C, 8] (Column).
extern "C" int ringsnark_prng_draw(void* out, const void* table, int C, long long outer,
                                   long long n_axis, long long lo, long long rows, long long A,
                                   long long I, void* stream) {
  Geo g;
  if (!make_geo(outer, n_axis, lo, rows, A, I, C, 1, true, true, g)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const Columns cols = columns_of(static_cast<const uint32_t*>(table), C);
  draw_kernel<<<grid_of(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), cols, g);
  return static_cast<int>(cudaGetLastError());
}

// out: uint32 [rows, A, C, I]; moduli: host uint32 [C]; the words of side s,
// word w are outer block s * n_words + w of [2 n_words, n_axis, A, I].
extern "C" int ringsnark_prng_cbd(void* out, const void* moduli, int C, unsigned int k0,
                                  unsigned int k1, int n_words, unsigned int last_mask,
                                  long long n_axis, long long lo, long long rows, long long A,
                                  long long I, void* stream) {
  Geo g;
  if (n_words < 1 || n_words > 64 ||
      !make_geo(2LL * n_words, n_axis, lo, rows, A, I, C, 1, false, false, g)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  Moduli q = {};
  for (int c = 0; c < C; ++c) q.q[c] = static_cast<const uint32_t*>(moduli)[c];
  cbd_kernel<<<grid_of(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), q, k0, k1, static_cast<uint32_t>(n_words), last_mask, g);
  return static_cast<int>(cudaGetLastError());
}

// out: uint32 [rows, A, C, I], fewer than 2^32 words; pt: uint32 [rows, A,
// I], or [rows, A] where scalar (coefficient 0 of I); k: uint4 [A, Cs] (Q_c
// - t_a as a 32-bit word, Q_c, t_a mod Q_c, its Shoup constant), the first
// C columns written; I a power of two.  With n_words > 0, plus t_a * e mod
// Q_c for the CBD error of key (k0, k1): the words of side s, word w are
// outer block s * n_words + w of [2 n_words, n_axis, A, I], the launch's
// rows at lo (cbd_kernel's); t_a <= 2 Q_c there.
extern "C" int ringsnark_prng_lift(void* out, const void* pt, const void* k, int C, int Cs,
                                   int scalar, unsigned int k0, unsigned int k1, int n_words,
                                   unsigned int last_mask, long long n_axis, long long lo,
                                   long long rows, long long A, long long I, void* stream) {
  Geo g;
  if (n_words < 0 || n_words > 64 || Cs < C || (I & (I - 1)) != 0 ||
      !make_geo(n_words ? 2LL * n_words : 1, n_words ? n_axis : rows, n_words ? lo : 0, rows, A,
                I, C, 1, false, false, g, true)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const LiftGeo lg{g.lines * g.I, static_cast<uint32_t>(__builtin_ctzll(I)), g.A, g.C,
                   static_cast<uint32_t>(Cs)};
  const Cbd cbd{g.step, g.base, hash_key(k0, k1), static_cast<uint32_t>(n_words), last_mask, 1u};
  const dim3 grid(static_cast<unsigned>((static_cast<uint64_t>(lg.n) + kThreads * kPer - 1) /
                                        (kThreads * kPer)));
  auto* o = static_cast<uint32_t*>(out);
  const auto* p = static_cast<const uint32_t*>(pt);
  const auto* kk = static_cast<const uint4*>(k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_words && scalar) {
    lift_kernel<true, true><<<grid, kThreads, 0, st>>>(o, p, kk, lg, cbd);
  } else if (n_words) {
    lift_kernel<true, false><<<grid, kThreads, 0, st>>>(o, p, kk, lg, cbd);
  } else if (scalar) {
    lift_kernel<false, true><<<grid, kThreads, 0, st>>>(o, p, kk, lg, cbd);
  } else {
    lift_kernel<false, false><<<grid, kThreads, 0, st>>>(o, p, kk, lg, cbd);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The CTAs of an encrypt_kernel launch over `units` units on the current
// device: those it keeps resident (its SMs times the CTAs an SM holds, read
// from the runtime once a process), at most one a unit; 0 where the runtime
// cannot say.  Every word is written once whatever the grid, so the grid
// moves no result.
template <bool kC1>
uint64_t encrypt_grid(uint64_t units) {
  static const int per_sm = [] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, encrypt_kernel<kC1>, kEncThreads,
                                                         0) == cudaSuccess ? n : 0;
  }();
  int dev = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  const uint64_t resident = static_cast<uint64_t>(sms) * per_sm;
  return resident < units ? resident : units;
}

}  // namespace

// c0 (and c1 unless it is null): uint32 [rows, A, C, I]; u: the same; s:
// (value, Shoup) pairs [L, C, I]; table: host uint32 [C, 8], span = Q_c; I
// a power of two.
extern "C" int ringsnark_prng_encrypt(void* c0, void* c1, const void* u, const void* s,
                                      const void* table, int C, int L, long long n_axis,
                                      long long lo, long long rows, long long A, long long I,
                                      void* stream) {
  Geo g;
  if (L < 1 || A % L != 0 || (I & (I - 1)) != 0 ||
      !make_geo(1, n_axis, lo, rows, A, I, C, L, false, true, g)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* words = static_cast<const uint32_t*>(table);
  for (int c = 0; c < C; ++c) {
    const uint32_t span = words[8 * c + 4];
    if (span < 2 || span > (1u << 31)) return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t slices = (g.I + kEncTile - 1) / kEncTile;
  const EncGeo eg{g.base, static_cast<uint64_t>(g.A) * g.C * slices * g.R, g.R, g.A, g.C, g.I,
                  g.L, slices};
  const uint64_t grid = c1 ? encrypt_grid<true>(eg.units) : encrypt_grid<false>(eg.units);
  if (grid < 1) return static_cast<int>(refused(cudaErrorInvalidValue));
  const Columns cols = columns_of(words, C);
  auto* o0 = static_cast<uint32_t*>(c0);
  auto* o1 = static_cast<uint32_t*>(c1);
  const auto* uu = static_cast<const uint32_t*>(u);
  const auto* ss = static_cast<const uint2*>(s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o1) {
    encrypt_kernel<true><<<static_cast<unsigned>(grid), kEncThreads, 0, st>>>(o0, o1, uu, ss,
                                                                              cols, eg);
  } else {
    encrypt_kernel<false><<<static_cast<unsigned>(grid), kEncThreads, 0, st>>>(o0, o1, uu, ss,
                                                                               cols, eg);
  }
  return static_cast<int>(cudaGetLastError());
}
