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
// Contract (bit for bit mac_plain's): every term is the 64-bit product of
// two words below 2^32, reduced to the canonical [0, Q_j) by a Barrett
// step with mu_j = floor(2^64 / Q_j): q = umul64hi(x, mu_j) is floor(x /
// Q_j) or one less for every x < 2^64, so x - q Q_j lies in [0, 2 Q_j) and
// fits 32 bits; one conditional subtract makes it canonical.  The terms are
// added in 64 bits.  A batch has fewer than 2^32 rows and a term is below
// 2^31, so no sum reaches 2^63 and integer addition in any order (partial
// sums per thread, then atomics) gives the same bits as mac_plain's.  The
// sums are neither Montgomery-form nor lazily reduced: parallel/sharded.py
// and stream_sharded.py add the ranks' partial sums as they are.
//
// Layout: c0, c1 and a plaintext operand are int32 rows [n, L, C, I]
// (C = L'_lvl, I = N'); the columns (l, j, i) of a row are contiguous.  A
// thread owns kVec = 4 adjacent columns (16-byte loads; I % 4 == 0, so the
// four share one Q_j) and walks the rows of its split: grid.x tiles the
// columns by kThreads * kVec, grid.y splits the rows (ops/cuda_mac.plan
// picks the split so the grid fills the card's SMs).  Operand k has rows_k
// <= n rows (rows past them pair with zero coefficients).  The Z_q
// operand (N = 1) is a broadcast over i: it is read as [rows_k, L, C], one
// word per (r, l, j).  Each thread adds its partial sums to the int64
// accumulators [L, C, I] with atomicAdd on unsigned 64-bit words.
//
// mac_drawn_kernel: the same sums with c1 drawn in registers, the seeded
// prove's uniform mask (ops/cuda_prng.uniform's words, csrc/threefry.cuh
// draw_value): word (r, l, j, i) of rows [lo, lo + n) of a draw [n_axis,
// L, N'] has the counter (lo + r) L N' + l N' + i under key column j, so c1
// is never written or read.
//
// What bounds them on this card: mac_kernel moves (2 + P) * 4 bytes a
// column and row for 2P terms of 7 integer multiplies each (the FMA pipe,
// 64 lanes an SM), so its bytes at 3.35 TB/s take longer than its
// operations; mac_drawn_kernel reads (1 + P) * 4 bytes and also hashes one
// threefry word (41 ALU operations) a column and row, so its bytes or its
// operations bind, as P and the shape say (chip_smoke.py's Ops).
// What the design does about it: c0 and c1 are read once for all P
// operands, every operand once, as int32 in 16-byte loads (the plain
// version converts each to int64 first and reads both components once per
// operand); the broadcast operand is read once a (r, l, j); nothing is
// written but 2P atomics a column and split; the moduli and Barrett
// constants, and the drawn path's key columns, ride in the launch's
// __grid_constant__ parameters, so a launch needs no copy to the device.
//
// C interface: ringsnark_mac and ringsnark_mac_drawn return
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for a configuration they refuse; the Python wrapper
// (ops/cuda_mac.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, refused
#include "threefry.cuh"  // Column, Columns, kMaxCols, draw_value, columns_of

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // adjacent columns a thread
constexpr int kMaxOps = 4;  // plaintext operands a launch
constexpr long long kMaxGridY = 65535;

// The inner primes of the level and mu_j = floor(2^64 / Q_j).
struct Moduli {
  uint32_t q[kMaxCols];
  uint64_t mu[kMaxCols];
};

// The plaintext operands, their rows and their accumulators (int64 [L, C, I]).
struct Operands {
  const uint32_t* pt[kMaxOps];
  unsigned long long* acc0[kMaxOps];
  unsigned long long* acc1[kMaxOps];
  uint32_t rows[kMaxOps];
};

struct Shape {
  uint32_t n;  // rows of c0 (and c1)
  uint32_t L, C, I;
  uint32_t groups;  // column groups of kVec: L * C * I / kVec
  uint32_t rows_per_split;  // rows a grid.y block walks
  uint64_t base;  // mac_drawn: the counter of the first row, lo * L * I
};

// a * b mod q, canonical, for any a, b < 2^32 and q in [2, 2^31).
__device__ __forceinline__ uint32_t mul_mod_exact(uint32_t a, uint32_t b, uint32_t q,
                                                  uint64_t mu) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t r = static_cast<uint32_t>(x) - static_cast<uint32_t>(__umul64hi(x, mu)) * q;
  return reduce_once(r, q);  // r in [0, 2q): exact in 32 bits
}

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int P, bool kBcast, bool kDrawn>
__device__ __forceinline__ void mac_body(const uint32_t* __restrict__ c0,
                                         const uint32_t* __restrict__ c1, const Operands& ops,
                                         const Moduli& mod, const Columns* keys, const Shape& s) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= s.groups) return;
  const uint32_t f = g * kVec;  // first column of the thread: (l, j, i)
  const uint32_t i = f % s.I;
  const uint32_t lj = f / s.I;  // l * C + j
  const uint32_t j = lj % s.C;
  const uint32_t l = lj / s.C;
  const uint32_t q = mod.q[j];
  const uint64_t mu = mod.mu[j];
  const uint32_t r0 = blockIdx.y * s.rows_per_split;
  const uint32_t r1 = min(s.n, r0 + s.rows_per_split);
  const size_t width = static_cast<size_t>(s.groups) * kVec;  // L * C * I
  const uint32_t lc = s.L * s.C;

  uint64_t s0[P][kVec], s1[P][kVec];
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) s0[k][v] = s1[k][v] = 0;
  }
#pragma unroll 2
  for (uint32_t r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * width + f;
    const uint4 a4 = load4(c0 + off);
    uint4 b4;
    if constexpr (kDrawn) {
      const Column& col = keys->c[j];
      const uint64_t ctr = s.base + (static_cast<uint64_t>(r) * s.L + l) * s.I + i;
      b4 = make_uint4(draw_value(col, ctr), draw_value(col, ctr + 1), draw_value(col, ctr + 2),
                      draw_value(col, ctr + 3));
    } else {
      b4 = load4(c1 + off);
    }
    const uint32_t a[kVec] = {a4.x, a4.y, a4.z, a4.w};
    const uint32_t b[kVec] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (r >= ops.rows[k]) continue;
      uint32_t w[kVec];
      if constexpr (kBcast) {
        const uint32_t v = __ldg(ops.pt[k] + static_cast<size_t>(r) * lc + lj);
        w[0] = w[1] = w[2] = w[3] = v;
      } else {
        const uint4 w4 = load4(ops.pt[k] + off);
        w[0] = w4.x;
        w[1] = w4.y;
        w[2] = w4.z;
        w[3] = w4.w;
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        s0[k][v] += mul_mod_exact(a[v], w[v], q, mu);
        s1[k][v] += mul_mod_exact(b[v], w[v], q, mu);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (r0 >= ops.rows[k]) continue;  // no row of this split meets operand k
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      atomicAdd(ops.acc0[k] + f + v, static_cast<unsigned long long>(s0[k][v]));
      atomicAdd(ops.acc1[k] + f + v, static_cast<unsigned long long>(s1[k][v]));
    }
  }
}

template <int P, bool kBcast>
__global__ void __launch_bounds__(kThreads)
    mac_kernel(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
               const __grid_constant__ Operands ops, const __grid_constant__ Moduli mod,
               Shape s) {
  mac_body<P, kBcast, false>(c0, c1, ops, mod, nullptr, s);  // c1 given: no key is read
}

template <int P, bool kBcast>
__global__ void __launch_bounds__(kThreads)
    mac_drawn_kernel(const uint32_t* __restrict__ c0, const __grid_constant__ Operands ops,
                     const __grid_constant__ Moduli mod, const __grid_constant__ Columns keys,
                     Shape s) {
  mac_body<P, kBcast, true>(c0, nullptr, ops, mod, &keys, s);
}

// The launch's Shape, Operands and Moduli, or false where it is refused:
// 1 to kMaxOps operands of 1 to n rows each, 1 to kMaxCols moduli in [2,
// 2^31) with mu = floor(2^64 / q), I a multiple of kVec, a row of at most
// 2^31 - 1 words, and at most kMaxGridY row splits.
bool make_launch(int P, const uint64_t* ptrs, const long long* rows, const uint32_t* q,
                 const uint64_t* mu, int C, long long n, long long L, long long I,
                 long long rows_per_split, Shape& s, Operands& ops, Moduli& mod, dim3& grid) {
  using u128 = unsigned __int128;
  if (P < 1 || P > kMaxOps || C < 1 || C > kMaxCols || n < 1 || n >= (1LL << 32) || L < 1 ||
      L >= (1LL << 31) || I < kVec || I >= (1LL << 31) || I % kVec != 0 || rows_per_split < 1) {
    return false;
  }
  const long long width = L * C * I;  // each factor below 2^31: no overflow
  const long long splits = (n + rows_per_split - 1) / rows_per_split;
  if (width >= (1LL << 31) || splits > kMaxGridY) return false;
  for (int c = 0; c < C; ++c) {
    if (q[c] < 2 || q[c] >= (1u << 31) ||
        static_cast<u128>(mu[c]) != (static_cast<u128>(1) << 64) / q[c]) {
      return false;
    }
    mod.q[c] = q[c];
    mod.mu[c] = mu[c];
  }
  for (int k = 0; k < P; ++k) {
    if (rows[k] < 1 || rows[k] > n || ptrs[k] == 0) return false;
    ops.pt[k] = reinterpret_cast<const uint32_t*>(ptrs[k]);
    ops.acc0[k] = reinterpret_cast<unsigned long long*>(ptrs[kMaxOps + k]);
    ops.acc1[k] = reinterpret_cast<unsigned long long*>(ptrs[2 * kMaxOps + k]);
    ops.rows[k] = static_cast<uint32_t>(rows[k]);
  }
  s.n = static_cast<uint32_t>(n);
  s.L = static_cast<uint32_t>(L);
  s.C = static_cast<uint32_t>(C);
  s.I = static_cast<uint32_t>(I);
  s.groups = static_cast<uint32_t>(width / kVec);
  s.rows_per_split = static_cast<uint32_t>(rows_per_split < n ? rows_per_split : n);
  s.base = 0;
  grid = dim3((s.groups + kThreads - 1) / kThreads, static_cast<unsigned>(splits));
  return true;
}

template <bool kDrawn, bool kBcast>
cudaError_t launch(int P, const uint32_t* c0, const uint32_t* c1, const Operands& ops,
                   const Moduli& mod, const Columns* keys, const Shape& s, dim3 grid,
                   cudaStream_t stream) {
#define RINGSNARK_MAC_CASE(p)                                                                 \
  case p:                                                                                     \
    if constexpr (kDrawn) {                                                                   \
      mac_drawn_kernel<p, kBcast><<<grid, kThreads, 0, stream>>>(c0, ops, mod, *keys, s);   \
    } else {                                                                                  \
      mac_kernel<p, kBcast><<<grid, kThreads, 0, stream>>>(c0, c1, ops, mod, s);            \
    }                                                                                         \
    break;
  switch (P) {
    RINGSNARK_MAC_CASE(1)
    RINGSNARK_MAC_CASE(2)
    RINGSNARK_MAC_CASE(3)
    RINGSNARK_MAC_CASE(4)
    default:
      return refused(cudaErrorInvalidValue);
  }
#undef RINGSNARK_MAC_CASE
  return cudaGetLastError();
}

}  // namespace

// c0, c1: uint32 [n, L, C, I]; ptrs: host uint64 [3 * kMaxOps] (the P
// operands, then their acc0, then their acc1; int64 [L, C, I] each); rows:
// host int64 [P]; q: host uint32 [C]; mu: host uint64 [C]; bcast: the
// operands are [rows_k, L, C] broadcast over I.
extern "C" int ringsnark_mac(const void* c0, const void* c1, const void* ptrs, const void* rows,
                             int P, int bcast, const void* q, const void* mu, int C, long long n,
                             long long L, long long I, long long rows_per_split, void* stream) {
  Shape s;
  Operands ops = {};
  Moduli mod = {};
  dim3 grid;
  if (c0 == nullptr || c1 == nullptr ||
      !make_launch(P, static_cast<const uint64_t*>(ptrs), static_cast<const long long*>(rows),
                   static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(mu), C, n, L,
                   I, rows_per_split, s, ops, mod, grid)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* a = static_cast<const uint32_t*>(c0);
  const uint32_t* b = static_cast<const uint32_t*>(c1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bcast ? launch<false, true>(P, a, b, ops, mod, nullptr, s, grid, st)
                                : launch<false, false>(P, a, b, ops, mod, nullptr, s, grid, st));
}

// As ringsnark_mac with c1 drawn: rows [lo, lo + n) of the uniform draw
// [n_axis, L, I] under the key table (host uint32 [C, 8], column j's span
// Q_j: ops/cuda_prng.uniform_columns).
extern "C" int ringsnark_mac_drawn(const void* c0, const void* table, long long n_axis,
                                   long long lo, const void* ptrs, const void* rows, int P,
                                   int bcast, const void* q, const void* mu, int C, long long n,
                                   long long L, long long I, long long rows_per_split,
                                   void* stream) {
  using u128 = unsigned __int128;
  Shape s;
  Operands ops = {};
  Moduli mod = {};
  dim3 grid;
  if (c0 == nullptr || table == nullptr || lo < 0 || n_axis < lo + n ||
      static_cast<u128>(n_axis) * static_cast<u128>(L > 0 ? L : 0) *
              static_cast<u128>(I > 0 ? I : 0) >
          (static_cast<u128>(1) << 64) ||
      !make_launch(P, static_cast<const uint64_t*>(ptrs), static_cast<const long long*>(rows),
                   static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(mu), C, n, L,
                   I, rows_per_split, s, ops, mod, grid)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* words = static_cast<const uint32_t*>(table);
  for (int c = 0; c < C; ++c) {
    if (words[8 * c + 4] != mod.q[c]) return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const Columns keys = columns_of(words, C);
  s.base = static_cast<uint64_t>(lo) * static_cast<uint64_t>(L) * static_cast<uint64_t>(I);
  const uint32_t* a = static_cast<const uint32_t*>(c0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bcast ? launch<true, true>(P, a, nullptr, ops, mod, &keys, s, grid, st)
                                : launch<true, false>(P, a, nullptr, ops, mod, &keys, s, grid, st));
}
