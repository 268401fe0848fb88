// Threefry-2x32 draws and symmetric-BGV encryption, for Hopper (sm_90a).
//
// Replaces the PRNG that ringsnark_tpu_torch wrote as int64 torch ops
// (utils/prng.py: bits, randint; encoding/bgv.py: _sample_uniform,
// _sample_error_coeffs, _encrypt_from_m), the counterpart of the JAX
// package's jax.random draws in ringsnark_tpu/encoding/bgv.py
// (`_sample_uniform` :85, `_sample_error_ntt` :110, `_encrypt_from_m` :159).
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
//   residue mod every Q_j (coefficient form; the NTT kernel takes it on).
// * encrypt_kernel: the uniform a of one element drawn in registers, c1 =
//   a, c0 = m - a*s + t*e mod Q_j (m, e, s in inner-NTT form), with Shoup
//   constants for s (one per residue, made once per key) and t mod Q_j.
//   No int64 temporary, and a is never written and read back.
//
// What bounds them on this card: integer operations.  A hash is 20 rounds
// of add, rotate (one funnel shift) and xor plus five key injections, about
// 73 int32 operations for one 32-bit word; writing that word takes 4 bytes,
// so at 64 INT32 lanes an SM the hash takes about 3x as long as the bytes
// (the encryption moves 16 bytes a word: m, e in; c0, c1 out, and is
// within 1.5x of its bytes).  What the design does about it: one thread
// per output word (4 words a thread a line), everything in registers, no
// shared memory; the rotations are funnel shifts and the round constants
// immediates; the division of a line into (o, r, a, c) happens once a line,
// not once a word; mod span is a multiply-high with a host constant mu =
// floor(2^32 / span) and one conditional subtract, never a division; the
// key table rides in the launch's parameters (__grid_constant__), so a
// launch needs no copy to the device.
//
// C interface: ringsnark_prng_draw, ringsnark_prng_cbd and
// ringsnark_prng_encrypt return cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for a configuration they refuse; the
// Python wrapper (ops/cuda_prng.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, add_mod, sub_mod, shoup_mul, refused
#include "threefry.cuh"  // Column, Columns, kMaxCols, threefry_word, draw_value, columns_of

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
  uint32_t L;  // outer limbs: s and t mod Q_j are indexed by a mod L
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
  for (uint32_t line = blockIdx.y; line < g.lines; line += gridDim.y) {
    const uint32_t a = line % g.A;
    const uint32_t r = line / g.A;
    const uint64_t ctr = g.base + (static_cast<uint64_t>(r) * g.A + a) * g.I;
    uint32_t* dst = out + static_cast<size_t>(line) * g.C * g.I;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t i = first_word() + k * kThreads;
      if (i >= g.I) continue;
      int e = 0;
      for (uint32_t w = 0; w < n_words; ++w) {
        const uint32_t mask = w + 1 == n_words ? last_mask : 0xFFFFFFFFu;
        e += __popc(threefry_word(k0, k1, w * g.step + ctr + i) & mask);
        e -= __popc(threefry_word(k0, k1, (n_words + w) * g.step + ctr + i) & mask);
      }
      for (uint32_t c = 0; c < g.C; ++c) {
        dst[static_cast<size_t>(c) * g.I + i] =
            e < 0 ? q.q[c] - static_cast<uint32_t>(-e) : static_cast<uint32_t>(e);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    encrypt_kernel(uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                   const uint32_t* __restrict__ m, const uint32_t* __restrict__ e,
                   const uint2* __restrict__ s, const uint2* __restrict__ tq,
                   const __grid_constant__ Columns cols, Geo g) {
  // line = (r A + a) C + c; c0, c1, m, e are [R, A, C, I]; s [L, C, I], tq [L, C]
  for (uint32_t line = blockIdx.y; line < g.lines; line += gridDim.y) {
    const uint32_t c = line % g.C;
    const uint32_t t = line / g.C;
    const uint32_t a = t % g.A;
    const uint32_t r = t / g.A;
    const uint32_t limb = (a % g.L) * g.C + c;
    const Column& col = cols.c[c];
    const uint32_t Q = col.span;
    const uint2 tw = __ldg(tq + limb);
    const uint2* srow = s + static_cast<size_t>(limb) * g.I;
    const uint64_t ctr = g.base + (static_cast<uint64_t>(r) * g.A + a) * g.I;
    const size_t off = static_cast<size_t>(line) * g.I;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t i = first_word() + k * kThreads;
      if (i >= g.I) continue;
      const uint32_t av = draw_value(col, ctr + i);
      const uint32_t as = shoup_mul(av, __ldg(srow + i), Q);
      const uint32_t te = shoup_mul(__ldg(e + off + i), tw, Q);
      c1[off + i] = av;
      c0[off + i] = add_mod(sub_mod(__ldg(m + off + i), as, Q), te, Q);
    }
  }
}

// The geometry of a launch, or false where the launch is refused: every
// extent positive and below 2^31, the rows inside the axis, every counter
// of the whole draw below 2^64, 1 to kMaxCols columns, and the lines and
// words of the launch below 2^31 (32-bit indices in the kernels).  A line
// spans the outer blocks and the columns or not, as the kernel writes them.
bool make_geo(long long outer, long long n_axis, long long lo, long long rows, long long A,
              long long I, int C, int L, bool lines_over_outer, bool lines_over_cols,
              Geo& g) {
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
  if (lines >= static_cast<u128>(limit) || words >= static_cast<u128>(limit)) return false;
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

// c0, c1, m, e: uint32 [rows, A, C, I]; s: (value, Shoup) pairs [L, C, I];
// tq: pairs [L, C] (t_l mod Q_c); table: host uint32 [C, 8], span = Q_c.
extern "C" int ringsnark_prng_encrypt(void* c0, void* c1, const void* m, const void* e,
                                      const void* s, const void* tq, const void* table, int C,
                                      int L, long long n_axis, long long lo, long long rows,
                                      long long A, long long I, void* stream) {
  Geo g;
  if (L < 1 || A % L != 0 || !make_geo(1, n_axis, lo, rows, A, I, C, L, false, true, g)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* words = static_cast<const uint32_t*>(table);
  for (int c = 0; c < C; ++c) {
    const uint32_t span = words[8 * c + 4];
    if (span < 2 || span > (1u << 31)) return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const Columns cols = columns_of(words, C);
  encrypt_kernel<<<grid_of(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(c0), static_cast<uint32_t*>(c1), static_cast<const uint32_t*>(m),
      static_cast<const uint32_t*>(e), static_cast<const uint2*>(s),
      static_cast<const uint2*>(tq), cols, g);
  return static_cast<int>(cudaGetLastError());
}
