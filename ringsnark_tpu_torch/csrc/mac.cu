// The prover's multiply-accumulate (MAC) for Hopper (sm_90a): the exact
// int64 sums acc_k[l, j, i] += sum_r (c[r, l, j, i] * pt_k[r, l, j, i] mod
// Q_j) of one row sub-chunk, for both ciphertext components c0 and c1 and
// up to kMaxOps plaintext operands pt_k at once.
//
// Replaces the int64 torch ops that ringsnark_tpu_torch wrote in three
// places (encoding.mac_accumulate, seeded._mac_accs, streamed._encode_mac;
// now encoding/mac.py:mac_plain), the counterpart of the JAX package's
// jitted MAC: `_seeded_mac_kernel` and its scan body `_mac_accs_u64`
// (ringsnark_tpu/snark/seeded.py:295-389), which regenerates each slab's c1
// from the key, and `inner_product` (ringsnark_tpu/encoding/encoding.py:193).
// The JAX package has no Pallas kernel for it: XLA fuses the scan.
//
// Contract (bit for bit mac_plain's): every term c * pt mod Q_j is reduced
// to its canonical residue in [0, Q_j) and the terms are added in exact
// 64-bit integers.  A batch has fewer than 2^32 rows and a term is below
// 2^31, so no sum reaches 2^63 and integer addition in any order (pairs of
// rows, partial sums per thread, then atomics) gives the same bits as
// mac_plain's.  The sums are neither Montgomery-form nor lazily reduced:
// parallel/sharded.py and stream_sharded.py add the ranks' partial sums as
// they are.  The operands must be what every path hands over today, a
// requirement on every producer that the kernels do not check: pt_k
// canonical (an NTT's or the lift's output, w < Q_j) and c0, c1
// non-negative int32 words (a < 2^31; the encryption's and the draw's are
// canonical too).  A word outside (a lazily reduced NTT output, say) gives
// a wrong sum where mac_plain's stays exact; tests/test_torch_cuda.py
// feeds the kernels plain_to_inner_ntt's output to hold the NTT to it.
//
// The reduction (mul_mod): Q_j in [2, 2^31), mu_j = floor(2^64 / Q_j) split
// into 32-bit halves.  Once a word of an operand, its Shoup constant
// w_sh = floor(w * mu / 2^32) = w * mu_hi + umulhi(w, mu_lo): with W =
// floor(w 2^32 / Q), mu > 2^64 / Q - 1 gives w mu / 2^32 > w 2^32 / Q -
// w / 2^32 > w 2^32 / Q - 1/2, so w_sh is W or W - 1, and w_sh <= W < 2^32
// (w < Q) makes the 32-bit sum exact.  Then t = umulhi(a, w_sh): a w_sh /
// 2^32 <= a w / Q, and a (W - 1) / 2^32 > a (w 2^32 / Q - 2) / 2^32 = a w /
// Q - a / 2^31 > a w / Q - 1 for a < 2^31, so t is floor(a w / Q) or one
// less and r = a w - t Q lies in [0, 2 Q), below 2^32: the wrapped 32-bit
// a * w - t * Q is r exactly, and min(r, r - Q) is the canonical term.
// Three multiplies a term and two a word of an operand, where a 64-bit
// Barrett step on the 64-bit product takes seven a term.  The wrapper
// refuses any other modulus (ops/cuda_mac.barrett).  Two canonical
// terms sum below 2^32, so each pair of rows is added in 32 bits and the
// pair's sum once into the 64-bit accumulator: half the 64-bit adds.
//
// Layout: c0, c1 and a plaintext operand are int32 rows [n, L, C, I]
// (C = L'_lvl, I = N'); the columns (l, j, i) of a row are contiguous.  A
// thread owns kVec = 4 adjacent columns (16-byte loads; I % 4 == 0, so the
// four share one Q_j), a tile is the kTile columns of one CTA's threads.
// Operand k has rows_k <= n rows (rows past them pair with zero
// coefficients).  The Z_q operand (N = 1) is a broadcast over i: it is read
// as [rows_k, L, C], one word per (r, l, j), and its Shoup constant is made
// once for the thread's four columns.  Each thread adds its partial sums to
// the int64 accumulators [L, C, I] with atomicAdd on unsigned 64-bit words.
//
// mac_drawn_kernel: the same sums with c1 drawn in registers, the seeded
// prove's uniform mask (ops/cuda_prng.uniform's words, csrc/threefry.cuh):
// word (r, l, j, i) of rows [lo, lo + n) of a draw [n_axis, L, N'] has the
// counter (lo + r) L N' + l N' + i under key column j, so c1 is never
// written or read.  A word is one hash reduced mod Q_j: the launcher takes
// only columns whose JAX multiplier is 0 (no high word: every span above
// 2^16) and minval 0, as every inner prime's mask is, and refuses any other.
//
// What bounds them on this card: mac_kernel moves (2 + P) * 4 bytes a
// column and row for 2P terms of three multiplies each, so its bytes at
// 3.35 TB/s; mac_drawn_kernel reads (1 + P) * 4 bytes and hashes one
// threefry word (41 ALU operations) a column and row, so its bytes or its
// operations, as P and the shape say (chip_smoke.py's Ops).
// What the design does about it: both kernels are persistent, as many
// CTAs as the device keeps resident (the launcher reads the occupancy),
// each walking an equal run of (tile, row) units, rows fastest, so a
// thread keeps its tile's modulus, constants and key column in registers
// and its sums for all the rows of the run, with one set of atomics at the
// end of each tile's run (not one per row split).  Rows go in pairs; the
// next pair's c0, c1 and operand words are loaded into registers before
// this pair's hashes and products run (software pipelining in registers,
// as encrypt_kernel does: a word is used once, by the thread that loads
// it).  Offsets and the counter's low word are 32-bit: the launcher takes
// at most 2^32 words a tensor, and a line's counters start at a multiple
// of N' (a power of two), so only the step between rows can carry, tested
// once a row.  The moduli, constants and key columns ride in the launch's
// __grid_constant__ parameters, so a launch needs no copy to the device.
//
// C interface: ringsnark_mac and ringsnark_mac_drawn return
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for a configuration they refuse; the Python wrapper
// (ops/cuda_mac.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, shoup_of, mul_mod, refused
#include "threefry.cuh"  // Column, Columns, kMaxCols, HashKey, threefry, mod_span

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // adjacent columns a thread
constexpr int kMaxOps = 4;  // plaintext operands a launch
constexpr uint32_t kTile = kThreads * kVec;  // columns a tile

// The inner primes of the level and the halves of mu_j = floor(2^64 / Q_j).
struct Moduli {
  uint32_t q[kMaxCols];
  uint32_t mu_hi[kMaxCols];
  uint32_t mu_lo[kMaxCols];
};

// The plaintext operands, their rows and their accumulators (int64 [L, C, I]).
struct Operands {
  const uint32_t* pt[kMaxOps];
  unsigned long long* acc0[kMaxOps];
  unsigned long long* acc1[kMaxOps];
  uint32_t rows[kMaxOps];
};

struct Shape {
  uint64_t units;  // (tile, row) units: tiles * n
  uint64_t base;   // mac_drawn: the counter of row 0, lo * L * I
  uint32_t n;      // rows of c0 (and c1)
  uint32_t C, I;
  uint32_t width;   // L * C * I columns a row
  uint32_t groups;  // column groups of kVec: width / kVec
  uint32_t lc;      // L * C: a broadcast operand's words a row
  uint32_t row_ctr;  // mac_drawn: the counter's step between rows, L * I
  uint32_t one;      // 1 (threefry.cuh's add)
};

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One row of a thread's columns: c0's words, c1's where it is given, and
// each operand's (kVec words, or the broadcast word).
template <int P, bool kBcast>
struct Row {
  uint32_t a[kVec], b[kVec];
  uint32_t w[P][kBcast ? 1 : kVec];
};

// Row r (offsets off into the rows, boff into a broadcast operand), or
// zeros where it is not `live`; an operand's words past its rows are zero.
template <int P, bool kBcast, bool kDrawn>
__device__ __forceinline__ void load_row(Row<P, kBcast>& x, const uint32_t* __restrict__ c0,
                                         const uint32_t* __restrict__ c1, const Operands& ops,
                                         uint32_t r, uint32_t off, uint32_t boff, bool live) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uint4 a = live ? load4(c0 + off) : z;
  const uint4 b = !kDrawn && live ? load4(c1 + off) : z;
  x.a[0] = a.x, x.a[1] = a.y, x.a[2] = a.z, x.a[3] = a.w;
  x.b[0] = b.x, x.b[1] = b.y, x.b[2] = b.z, x.b[3] = b.w;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool in = live && r < ops.rows[k];
    if constexpr (kBcast) {
      x.w[k][0] = in ? __ldg(ops.pt[k] + boff) : 0u;
    } else {
      const uint4 w = in ? load4(ops.pt[k] + off) : z;
      x.w[k][0] = w.x, x.w[k][1] = w.y, x.w[k][2] = w.z, x.w[k][3] = w.w;
    }
  }
}

// The CTA's run of units [b U / grid, (b + 1) U / grid): unit = tile * n +
// r.  For each tile of the run, a thread with columns there adds the terms
// of the run's rows of that tile into its sums, then the sums into the
// accumulators.
template <int P, bool kBcast, bool kDrawn>
__device__ __forceinline__ void mac_body(const uint32_t* __restrict__ c0,
                                         const uint32_t* __restrict__ c1, const Operands& ops,
                                         const Moduli& mod, const Columns* keys, const Shape& s) {
  const uint64_t end = s.units * (blockIdx.x + 1) / gridDim.x;
  for (uint64_t unit = s.units * blockIdx.x / gridDim.x; unit < end;) {
    const uint32_t tile = static_cast<uint32_t>(unit / s.n);
    const uint32_t r0 = static_cast<uint32_t>(unit % s.n);
    const uint64_t left = end - unit;  // rows of this tile in the CTA's run
    const uint32_t rows = left < s.n - r0 ? static_cast<uint32_t>(left) : s.n - r0;
    unit += rows;
    const uint32_t g = tile * kThreads + threadIdx.x;
    if (g >= s.groups) continue;
    const uint32_t f = g * kVec;  // first column of the thread: (l, j, i)
    const uint32_t i = f % s.I;
    const uint32_t lj = f / s.I;  // l * C + j
    const uint32_t j = lj % s.C;
    const uint32_t q = mod.q[j], mu_hi = mod.mu_hi[j], mu_lo = mod.mu_lo[j];

    uint64_t s0[P][kVec], s1[P][kVec];
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) s0[k][v] = s1[k][v] = 0;
    }

    // The rows of the run in pairs.  A drawn word is one hash reduced mod
    // the span (the launcher takes only columns with no high word and minval
    // 0: every inner prime's uniform mask), with the column's key, its
    // injections' sums and mu in registers and the hash's adds on the FMA
    // pipe.
    const Column col = kDrawn ? keys->c[j] : Column{};
    const HashKey key = hash_key(col.lo0, col.lo1);
    uint32_t lo = 0, hi = 0;  // the counter of (row, l, i), 32-bit halves
    if constexpr (kDrawn) {
      const uint64_t ctr = s.base + static_cast<uint64_t>(r0) * s.row_ctr + (lj / s.C) * s.I + i;
      lo = static_cast<uint32_t>(ctr);
      hi = static_cast<uint32_t>(ctr >> 32);
    }
    const auto draw = [&](uint32_t h, uint32_t w) {
      return mod_span(threefry<true>(key, h, w, s.one), col.span, col.mu);
    };
    uint32_t off = r0 * s.width + f, boff = r0 * s.lc + lj;
    Row<P, kBcast> cur0, cur1, nxt0, nxt1;
    load_row<P, kBcast, kDrawn>(cur0, c0, c1, ops, r0, off, boff, true);
    load_row<P, kBcast, kDrawn>(cur1, c0, c1, ops, r0 + 1, off + s.width, boff + s.lc, 1 < rows);
    for (uint32_t k = 0; k < rows; k += 2) {
      const bool odd = k + 1 < rows;  // the pair's second row (the same for the CTA)
      // the next pair, in flight during this pair's hashes and products
      load_row<P, kBcast, kDrawn>(nxt0, c0, c1, ops, r0 + k + 2, off + 2 * s.width,
                                  boff + 2 * s.lc, k + 2 < rows);
      load_row<P, kBcast, kDrawn>(nxt1, c0, c1, ops, r0 + k + 3, off + 3 * s.width,
                                  boff + 3 * s.lc, k + 3 < rows);
      if constexpr (kDrawn) {
        const uint32_t lo1 = lo + s.row_ctr, hi1 = hi + (lo1 < s.row_ctr);
#pragma unroll
        for (int v = 0; v < kVec; ++v) cur0.b[v] = draw(hi, lo + v);
        if (odd) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) cur1.b[v] = draw(hi1, lo1 + v);
        }
        lo = lo1 + s.row_ctr;
        hi = hi1 + (lo < s.row_ctr);  // one carry test a row
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int u = kBcast ? 0 : v;
          const uint32_t w0 = cur0.w[p][u], w1 = cur1.w[p][u];
          const uint32_t h0 = shoup_of(w0, mu_hi, mu_lo), h1 = shoup_of(w1, mu_hi, mu_lo);
          // two canonical terms sum below 2^32: one 64-bit add a pair
          s0[p][v] += mul_mod(cur0.a[v], w0, h0, q) + mul_mod(cur1.a[v], w1, h1, q);
          s1[p][v] += mul_mod(cur0.b[v], w0, h0, q) + mul_mod(cur1.b[v], w1, h1, q);
        }
      }
      cur0 = nxt0;
      cur1 = nxt1;
      off += 2 * s.width;
      boff += 2 * s.lc;
    }

#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (r0 >= ops.rows[k]) continue;  // no row of this run meets operand k
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        atomicAdd(ops.acc0[k] + f + v, static_cast<unsigned long long>(s0[k][v]));
        atomicAdd(ops.acc1[k] + f + v, static_cast<unsigned long long>(s1[k][v]));
      }
    }
  }
}

// Registers: two CTAs an SM (128 a thread) where P <= 2, else one.
template <int P>
constexpr int kMinCtas = P <= 2 ? 2 : 1;

template <int P, bool kBcast>
__global__ void __launch_bounds__(kThreads, kMinCtas<P>)
    mac_kernel(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
               const __grid_constant__ Operands ops, const __grid_constant__ Moduli mod,
               Shape s) {
  mac_body<P, kBcast, false>(c0, c1, ops, mod, nullptr, s);  // c1 given: no key is read
}

template <int P, bool kBcast>
__global__ void __launch_bounds__(kThreads, kMinCtas<P>)
    mac_drawn_kernel(const uint32_t* __restrict__ c0, const __grid_constant__ Operands ops,
                     const __grid_constant__ Moduli mod, const __grid_constant__ Columns keys,
                     Shape s) {
  mac_body<P, kBcast, true>(c0, nullptr, ops, mod, &keys, s);
}

// The launch's Shape, Operands and Moduli, or false where it is refused:
// 1 to kMaxOps operands of 1 to n rows each, 1 to kMaxCols moduli in [2,
// 2^31) with mu = floor(2^64 / q), I a multiple of kVec, a row of at most
// 2^31 - 1 words and at most 2^32 words a tensor (32-bit offsets).
bool make_launch(int P, const uint64_t* ptrs, const long long* rows, const uint32_t* q,
                 const uint64_t* mu, int C, long long n, long long L, long long I, Shape& s,
                 Operands& ops, Moduli& mod) {
  using u128 = unsigned __int128;
  if (P < 1 || P > kMaxOps || C < 1 || C > kMaxCols || n < 1 || n >= (1LL << 32) || L < 1 ||
      L >= (1LL << 31) || I < kVec || I >= (1LL << 31) || I % kVec != 0) {
    return false;
  }
  const long long width = L * C * I;  // each factor below 2^31: no overflow
  if (width >= (1LL << 31) || static_cast<u128>(width) * static_cast<u128>(n) > (1ULL << 32)) {
    return false;
  }
  for (int c = 0; c < C; ++c) {
    if (q[c] < 2 || q[c] >= (1u << 31) ||
        static_cast<u128>(mu[c]) != (static_cast<u128>(1) << 64) / q[c]) {
      return false;
    }
    mod.q[c] = q[c];
    mod.mu_hi[c] = static_cast<uint32_t>(mu[c] >> 32);
    mod.mu_lo[c] = static_cast<uint32_t>(mu[c]);
  }
  for (int k = 0; k < P; ++k) {
    if (rows[k] < 1 || rows[k] > n || ptrs[k] == 0) return false;
    ops.pt[k] = reinterpret_cast<const uint32_t*>(ptrs[k]);
    ops.acc0[k] = reinterpret_cast<unsigned long long*>(ptrs[kMaxOps + k]);
    ops.acc1[k] = reinterpret_cast<unsigned long long*>(ptrs[2 * kMaxOps + k]);
    ops.rows[k] = static_cast<uint32_t>(rows[k]);
  }
  const uint32_t groups = static_cast<uint32_t>(width / kVec);
  s.units = static_cast<uint64_t>((width + kTile - 1) / kTile) * static_cast<uint64_t>(n);
  s.base = 0;
  s.n = static_cast<uint32_t>(n);
  s.C = static_cast<uint32_t>(C);
  s.I = static_cast<uint32_t>(I);
  s.width = static_cast<uint32_t>(width);
  s.groups = groups;
  s.lc = static_cast<uint32_t>(L * C);
  s.row_ctr = static_cast<uint32_t>(L * I);
  s.one = 1;
  return true;
}

// The CTAs of a launch over `units` units on the current device: those the
// kernel keeps resident (its SMs times the CTAs an SM holds, read from the
// runtime once a process and kernel), at most one a unit; 0 where the
// runtime cannot say.  The sums are exact, so the grid moves no result.
template <typename Kernel>
uint64_t resident_grid(Kernel kernel, int& per_sm, uint64_t units) {
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess) {
    per_sm = 0;
  }
  int dev = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  const uint64_t resident = static_cast<uint64_t>(sms) * per_sm;
  return resident < units ? resident : units;
}

template <bool kDrawn, bool kBcast, int P>
cudaError_t launch_p(const uint32_t* c0, const uint32_t* c1, const Operands& ops,
                     const Moduli& mod, const Columns* keys, const Shape& s,
                     cudaStream_t stream) {
  static int per_sm = 0;
  if constexpr (kDrawn) {
    const uint64_t grid = resident_grid(mac_drawn_kernel<P, kBcast>, per_sm, s.units);
    if (grid < 1) return refused(cudaErrorInvalidValue);
    mac_drawn_kernel<P, kBcast>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(c0, ops, mod, *keys, s);
  } else {
    const uint64_t grid = resident_grid(mac_kernel<P, kBcast>, per_sm, s.units);
    if (grid < 1) return refused(cudaErrorInvalidValue);
    mac_kernel<P, kBcast><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(c0, c1, ops, mod,
                                                                                s);
  }
  return cudaGetLastError();
}

template <bool kDrawn, bool kBcast>
cudaError_t launch(int P, const uint32_t* c0, const uint32_t* c1, const Operands& ops,
                   const Moduli& mod, const Columns* keys, const Shape& s,
                   cudaStream_t stream) {
  switch (P) {
    case 1:
      return launch_p<kDrawn, kBcast, 1>(c0, c1, ops, mod, keys, s, stream);
    case 2:
      return launch_p<kDrawn, kBcast, 2>(c0, c1, ops, mod, keys, s, stream);
    case 3:
      return launch_p<kDrawn, kBcast, 3>(c0, c1, ops, mod, keys, s, stream);
    case 4:
      return launch_p<kDrawn, kBcast, 4>(c0, c1, ops, mod, keys, s, stream);
    default:
      return refused(cudaErrorInvalidValue);
  }
}

}  // namespace

// c0, c1: uint32 [n, L, C, I]; ptrs: host uint64 [3 * kMaxOps] (the P
// operands, then their acc0, then their acc1; int64 [L, C, I] each); rows:
// host int64 [P]; q: host uint32 [C]; mu: host uint64 [C]; bcast: the
// operands are [rows_k, L, C] broadcast over I.
extern "C" int ringsnark_mac(const void* c0, const void* c1, const void* ptrs, const void* rows,
                             int P, int bcast, const void* q, const void* mu, int C, long long n,
                             long long L, long long I, void* stream) {
  Shape s;
  Operands ops = {};
  Moduli mod = {};
  if (c0 == nullptr || c1 == nullptr ||
      !make_launch(P, static_cast<const uint64_t*>(ptrs), static_cast<const long long*>(rows),
                   static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(mu), C, n, L,
                   I, s, ops, mod)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* a = static_cast<const uint32_t*>(c0);
  const uint32_t* b = static_cast<const uint32_t*>(c1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bcast ? launch<false, true>(P, a, b, ops, mod, nullptr, s, st)
                                : launch<false, false>(P, a, b, ops, mod, nullptr, s, st));
}

// As ringsnark_mac with c1 drawn: rows [lo, lo + n) of the uniform draw
// [n_axis, L, I] under the key table (host uint32 [C, 8], column j's span
// Q_j with multiplier 0 and minval 0: ops/cuda_prng.uniform_columns); I a
// power of two.
extern "C" int ringsnark_mac_drawn(const void* c0, const void* table, long long n_axis,
                                   long long lo, const void* ptrs, const void* rows, int P,
                                   int bcast, const void* q, const void* mu, int C, long long n,
                                   long long L, long long I, void* stream) {
  using u128 = unsigned __int128;
  Shape s;
  Operands ops = {};
  Moduli mod = {};
  if (c0 == nullptr || table == nullptr || lo < 0 || n_axis < lo + n || (I & (I - 1)) != 0 ||
      static_cast<u128>(n_axis) * static_cast<u128>(L > 0 ? L : 0) *
              static_cast<u128>(I > 0 ? I : 0) >
          (static_cast<u128>(1) << 64) ||
      !make_launch(P, static_cast<const uint64_t*>(ptrs), static_cast<const long long*>(rows),
                   static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(mu), C, n, L,
                   I, s, ops, mod)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* words = static_cast<const uint32_t*>(table);
  for (int c = 0; c < C; ++c) {
    // span Q_j, one word a value (JAX's multiplier 0, as for every Q_j above
    // 2^16) and minval 0
    if (words[8 * c + 4] != mod.q[c] || words[8 * c + 5] != 0 || words[8 * c + 7] != 0) {
      return static_cast<int>(refused(cudaErrorInvalidValue));
    }
  }
  const Columns keys = columns_of(words, C);
  s.base = static_cast<uint64_t>(lo) * static_cast<uint64_t>(L) * static_cast<uint64_t>(I);
  const uint32_t* a = static_cast<const uint32_t*>(c0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bcast ? launch<true, true>(P, a, nullptr, ops, mod, &keys, s, st)
                                : launch<true, false>(P, a, nullptr, ops, mod, &keys, s, st));
}
