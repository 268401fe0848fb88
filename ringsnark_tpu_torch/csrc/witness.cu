// The witness map's two kernels for Hopper (sm_90a): the constraint
// evaluations A.z, B.z, C.z as a sparse matrix-vector product over the slots
// (spmv_kernel, with spmv_merge_kernel for rows split into segments), and
// the pointwise product y = a * b (+ c) mod p_l (mulmod_kernel).
//
// Replaces no TPU kernel: the JAX package computes both with XLA, no
// pl.pallas_call stands behind them.  spmv_kernel is the counterpart of
// CompiledR1CS.eval_matrices' gather, Barrett mul_mod and u64 segment_sum
// (ringsnark_tpu/relations/r1cs.py:222-241); mulmod_kernel of the pointwise
// mul_mod of the size-2M transforms in _witness_map_kernel
// (ringsnark_tpu/reductions/r1cs_to_qrp.py:444-448) and of the ZK patch
// (:452-457).  Both replace int64 torch ops of the port (relations/r1cs.py:
// spmv, ops/modops.py: mul_mod, add_mod), which stay as their plain versions
// on the CPU.
//
// spmv_kernel: out[r, l, i] = sum over the nonzeros k of row r of coef[k, l,
// i or 0] * z[idx[k], l, i] mod p_l, for the output rows r < rows (rows past
// the CSR's are zero).  The CSR (int32 row pointers, the int64 gather
// indices in row order, each row's first index again by row; none of it
// where every row is one nonzero, `unit`) is derived once per compiled
// system by relations/r1cs.py, which checks every index there; where the
// system's COO is already in row order (as `compile` and the models emit
// it) the indices and the coefficients are the COO's own tensors, read in
// place with their strides, so the CSR costs the card at most three words
// a row (none in the unit form: without it the Z_q squaring chain's peak
// memory rises 1.1 %, past its cell's bound).  The assignment z is up to
// kMaxBlocks row blocks (the constant one, the primary and the auxiliary
// rows of the prover, or one tensor), each with its own strides, so a slot
// window of the whole assignment is read in place: no concatenation and no
// copy of the window.  The output is [rows,
// L, n] (slot fastest: eval_matrices' layout) or slot-major [n, L, rows]
// (row fastest: what the interpolating inverse NTT takes, so the
// transposing copy before it is gone).
//
// Exactness: every modulus p_l lies in [2, 2^31) (the wrapper refuses any
// other by name), every coefficient and assignment word is canonical (< p_l:
// the coefficients are reduced when the system is compiled, the assignment
// is residues).  A term takes the coefficient word's Shoup constant made
// from mu_l = floor(2^64 / p_l)'s halves and mul_mod (modarith.cuh; exact
// for z < 2^31 and c < p_l, csrc/mac.cu's head proves it): the canonical
// residue of z * c.  Terms are summed with
// add_mod, which keeps the sum canonical (two canonical words sum below
// 2^32), so the result is the canonical residue of the exact sum in any
// order: bit for bit plain spmv's remainder of the int64 sum of remainders,
// and the JAX package's Barrett reduction of its u64 segment sum.
//
// Thread mapping: a CTA of kThreads threads takes one tile of kTile outputs,
// TR rows by TS slots of one limb (TS = the slots' next power of two, at
// most 32; TR = kTile / TS), over (limb, row tile, slot tile) flattened, so
// both extremes fill the card's 132 SMs: n = 1024 (the north star's chunk:
// a warp is 32 slots of one row, the gathers and stores 128-byte lines) and
// n = 1 (Z_q and the instance map: a warp is 32 rows).  What holds it below
// its bytes' rate is chains of dependent loads: a thread's four outputs
// (four rows of one slot, so one slot offset a thread) step through their
// rows together, every output's bounds and row head
// (the row's first gather index) loaded before any head's assignment word
// and coefficient, with no branch between them, so four chains are in
// flight at once and a row of one nonzero waits on two loads, not three (on
// an H100 these steps took the north star's chunk from 35 % to 55 % of its
// bytes bound).  A long row would serialise its warp: rows with more than
// seg_len nonzeros (seg_len about the square root of the longest row, at
// least 64) are cut into segments of seg_len, evaluated by a first launch
// into a scratch buffer of canonical partial sums, and added by
// spmv_merge_kernel into their output rows, so no thread adds more than
// about sqrt(longest row) terms in either launch.
// The slot-major store goes through a shared-memory tile (TS x (TR + 1)
// words, conflict-free), so its stores stay row-contiguous.
//
// mulmod_kernel: y[r, l, k] = a[r, l, k] * b[r, l, k] (+ c[r, l, k]) mod p_l
// over int32 [R, L, K] with any row and limb strides (the slot axis
// contiguous) and b's slot stride 1 or 0 (a constant along the slots: the
// ZK patch's d1, d2), in place where y is a or c.  Both operands vary, so a
// term takes the MAC's exact reduction: b's word gets its Shoup constant
// from mu_l = floor(2^64 / p_l)'s halves (shoup_of) and mul_mod reduces
// with it (modarith.cuh, proved in csrc/mac.cu's head: a < 2^31, b < p_l);
// c is added with add_mod.  Four adjacent words a thread (16-byte loads)
// where K and every stride are multiples of four, else one.
//
// What bounds them on this card: the bytes, at the main path's shapes.
// spmv at the north star's chunk reads z's window (2^18 rows x 1024 slots,
// 1 GiB) and writes its output (1 GiB), the CSR a few MiB; a term is five
// IMAD (two for the constant) and two ALU operations and the sum an add and
// a min: ~1.3 x 10^9 IMAD, 0.08 ms on the multiplier's 16.75 T/s, against
// 0.64 ms of bytes.  mulmod over [1024, 1, 2^19] reads two
// words and writes one (6 GiB, 1.9 ms) for 5 IMAD and 2 ALU operations.
//
// C interface: ringsnark_spmv and ringsnark_mulmod return
// cudaGetLastError() after the launches (0 on success) or
// cudaErrorInvalidValue for a configuration they refuse; the Python wrapper
// (ops/cuda_witness.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, add_mod, shoup_of, mul_mod, refused

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // outputs a thread (eight spill)
constexpr int kLogTile = 10;
constexpr int kTile = 1 << kLogTile;  // outputs a tile: TR rows x TS slots
static_assert(kTile == kThreads * kPerThread, "a tile is the CTA's outputs");
constexpr int kMaxTileSlots = 32;
static_assert(kThreads % kMaxTileSlots == 0, "a thread's outputs share one slot");
constexpr int kMaxBlocks = 3;  // row blocks of the assignment
constexpr int kMaxLimbs = 32;

// Rows [start, next block's start) of the assignment: word (row, l, i) at
// ptr + (row - start) * row + l * limb + i * slot (ptr at the window's first
// slot; a stride of 0 broadcasts).  The strides, and a row's offsets l *
// limb + i * slot, fit 32 bits (the launcher checks), so an address is one
// 32 x 32 -> 64-bit multiply-add.
struct Block {
  const uint32_t* ptr;
  uint32_t row, limb, slot, start;
};

struct Assignment {
  Block b[kMaxBlocks];
  int count;
};

struct Limbs {
  uint32_t p[kMaxLimbs];
  uint32_t mu_hi[kMaxLimbs];
  uint32_t mu_lo[kMaxLimbs];
};

struct SpmvShape {
  uint32_t L, n;       // limbs; slots of the output
  uint32_t rows;       // output rows (zero past csr_rows)
  uint32_t csr_rows;   // rows (or segments) with nonzeros to read
  uint32_t log_ts;     // TS = 1 << log_ts slots a tile, TR = kTile >> log_ts rows
  uint32_t slot_tiles, row_tiles;
  uint32_t seg_len;    // rows longer than this are left to the merge
  uint32_t unit;       // row r is nonzero r alone (no bounds are read)
  uint32_t coef_k, coef_l, coef_i;  // the coefficients' strides (coef_i 0: one for all slots)
};

// The assignment's word (c, l, i): c in the last block that starts at or
// below it.  Each field is selected on its own (a select of a block's
// address would read the parameters with an indexed load).
__device__ __forceinline__ uint32_t z_word(const Assignment& z, uint32_t c, uint32_t l,
                                           uint32_t i) {
  const bool in2 = z.count > 2 && c >= z.b[2].start;
  const bool in1 = !in2 && z.count > 1 && c >= z.b[1].start;
#define RINGSNARK_FIELD(f) (in2 ? z.b[2].f : (in1 ? z.b[1].f : z.b[0].f))
  const uint64_t off = static_cast<uint64_t>(c - RINGSNARK_FIELD(start)) * RINGSNARK_FIELD(row) +
                       (l * RINGSNARK_FIELD(limb) + i * RINGSNARK_FIELD(slot));
  return __ldg(RINGSNARK_FIELD(ptr) + off);
#undef RINGSNARK_FIELD
}

// The term coef * zw mod p: the coefficient word's Shoup constant made from
// mu's halves (coefficients and assignment words canonical, p < 2^31).
__device__ __forceinline__ uint32_t term(uint32_t zw, uint32_t w, uint32_t p, uint32_t mu_hi,
                                         uint32_t mu_lo) {
  return mul_mod(zw, w, shoup_of(w, mu_hi, mu_lo), p);
}

// kSeg: the rows are segments [seg[v].x, seg[v].y) of long rows, written as
// canonical partial sums into a [segments, L, n] scratch; else row v is
// [ptr[v], ptr[v + 1]) (nonzero v alone where `unit`), skipped when longer
// than seg_len (the merge writes it).  kSlotMajor: the output is [n, L,
// rows], else [rows, L, n].
template <bool kSlotMajor, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const int* __restrict__ bounds, const long long* __restrict__ idx,
                const long long* __restrict__ head, const uint32_t* __restrict__ coef,
                const __grid_constant__ Assignment z, const __grid_constant__ Limbs mod,
                const SpmvShape s, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile + kMaxTileSlots];  // TS x (TR + 1)
  uint32_t t = blockIdx.x;
  const uint32_t st = t % s.slot_tiles;
  t /= s.slot_tiles;
  const uint32_t rt = t % s.row_tiles;
  const uint32_t l = t / s.row_tiles;
  const uint32_t ts_mask = (1u << s.log_ts) - 1, log_tr = kLogTile - s.log_ts;
  const uint32_t tr = 1u << log_tr;
  const uint32_t r0 = rt << log_tr, i0 = st << s.log_ts;
  const uint32_t p = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
  // The thread's slot, the same for its four outputs (kThreads is a multiple
  // of TS), slot 0 where it is past n; its coefficients' offset in a row.
  const uint32_t slot = i0 + (threadIdx.x & ts_mask);
  const bool slot_live = slot < s.n;
  const uint32_t iv = slot_live ? slot : 0;
  const uint32_t ci = l * s.coef_l + iv * s.coef_i;

  // The thread's four outputs step through their rows together, their
  // loads in flight at once: first every output's bounds and head (its
  // row's first gather index), then every head's assignment word and
  // coefficient, so a row of one nonzero waits on two loads and the four
  // rows' waits overlap.  An output outside the tile's rows or slots reads
  // row 0 (at slot 0 where its slot is outside) and is dropped (no branch
  // keeps the loads apart).
  uint32_t val[kPerThread];
  int k[kPerThread], k_end[kPerThread];  // nnz < 2^31
  bool live[kPerThread];
  int steps = 0;
  if (s.csr_rows > 0) {
    uint32_t hz[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t r = r0 + ((threadIdx.x + j * kThreads) >> s.log_ts);  // slot fastest
      live[j] = r < s.csr_rows && slot_live;
      const uint32_t rs = live[j] ? r : 0;
      if constexpr (kSeg) {
        const int2 g = __ldg(reinterpret_cast<const int2*>(bounds) + rs);
        k[j] = g.x, k_end[j] = g.y;
      } else if (s.unit) {
        k[j] = static_cast<int>(rs), k_end[j] = static_cast<int>(rs) + 1;
        hz[j] = static_cast<uint32_t>(__ldg(idx + rs));
      } else {
        k[j] = __ldg(bounds + rs), k_end[j] = __ldg(bounds + rs + 1);
        hz[j] = static_cast<uint32_t>(__ldg(head + rs));
      }
    }
    if constexpr (!kSeg) {
      // the heads' terms (an empty row's coefficient reads as 0: a zero term)
      uint32_t zw[kPerThread], w[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        zw[j] = z_word(z, hz[j], l, iv);
        w[j] = k[j] < k_end[j]
                   ? __ldg(coef + (static_cast<uint64_t>(static_cast<uint32_t>(k[j])) * s.coef_k +
                                   ci))
                   : 0u;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        val[j] = term(zw[j], w[j], p, mu_hi, mu_lo);
        if (k_end[j] - k[j] > s.seg_len) k_end[j] = k[j];  // a long row: the merge writes it
        ++k[j];  // past the head
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) val[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (!live[j]) k_end[j] = k[j], val[j] = 0;
      steps = max(steps, k_end[j] - k[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) val[j] = 0, k[j] = k_end[j] = 0;
  }
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (k[j] < k_end[j]) {
        const uint32_t c = static_cast<uint32_t>(__ldg(idx + k[j]));
        const uint32_t w = __ldg(coef + (static_cast<uint64_t>(static_cast<uint32_t>(k[j])) *
                                              s.coef_k + ci));
        val[j] = add_mod(val[j], term(z_word(z, c, l, iv), w, p, mu_hi, mu_lo), p);
        ++k[j];
      }
    }
  }

  if constexpr (kSlotMajor) {
    // through shared memory: written slot fastest, stored row fastest
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t e = threadIdx.x + j * kThreads;
      tile[(e & ts_mask) * (tr + 1) + (e >> s.log_ts)] = val[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t e = threadIdx.x + j * kThreads;
      const uint32_t lr = e & (tr - 1), li = e >> log_tr;
      const uint32_t r = r0 + lr, i = i0 + li;
      if (r < s.rows && i < s.n) {
        out[static_cast<uint64_t>(i * s.L + l) * s.rows + r] = tile[li * (tr + 1) + lr];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t e = threadIdx.x + j * kThreads;
      const uint32_t r = r0 + (e >> s.log_ts), i = i0 + (e & ts_mask);
      if (r < s.rows && i < s.n) out[static_cast<uint64_t>(r * s.L + l) * s.n + i] = val[j];
    }
  }
}

// The long rows' output: long row j (output row rows_of[j]) adds the partial
// sums of its segments [seg_of[j], seg_of[j + 1]) of the scratch.
template <bool kSlotMajor>
__global__ void __launch_bounds__(kThreads)
    spmv_merge_kernel(const int* __restrict__ seg_of, const int* __restrict__ rows_of,
                      const uint32_t* __restrict__ scratch, const __grid_constant__ Limbs mod,
                      const SpmvShape s, uint32_t nlong, uint32_t* __restrict__ out) {
  const uint64_t total = static_cast<uint64_t>(nlong) * s.L * s.n;
  for (uint64_t f = blockIdx.x * static_cast<uint64_t>(kThreads) + threadIdx.x; f < total;
       f += static_cast<uint64_t>(gridDim.x) * kThreads) {
    const uint32_t i = static_cast<uint32_t>(f % s.n);
    const uint64_t jl = f / s.n;
    const uint32_t l = static_cast<uint32_t>(jl % s.L), j = static_cast<uint32_t>(jl / s.L);
    const uint32_t p = mod.p[l];
    uint32_t acc = 0;
    for (int g = __ldg(seg_of + j); g < __ldg(seg_of + j + 1); ++g) {
      acc = add_mod(acc, __ldg(scratch + (static_cast<long long>(g) * s.L + l) * s.n + i), p);
    }
    const long long r = __ldg(rows_of + j);
    out[kSlotMajor ? (static_cast<long long>(i) * s.L + l) * s.rows + r
                   : (r * s.L + l) * s.n + i] = acc;
  }
}

struct MulShape {
  uint32_t L;
  uint32_t groups;    // K / kVec: word groups a (row, limb)
  uint64_t units;     // R * L * groups
  long long a_r, a_l, b_r, b_l, b_k, c_r, c_l, y_r, y_l;  // strides in words
};

// kVec adjacent words a thread: 4 (16-byte loads; b's slot stride 1 or 0)
// or 1.  Loads are plain (not read-only): y may be a or c.
template <int kVec, bool kAdd>
__global__ void __launch_bounds__(kThreads)
    mulmod_kernel(uint32_t* y, const uint32_t* a, const uint32_t* b, const uint32_t* c,
                  const __grid_constant__ Limbs mod, const MulShape s) {
  for (uint64_t u = blockIdx.x * static_cast<uint64_t>(kThreads) + threadIdx.x; u < s.units;
       u += static_cast<uint64_t>(gridDim.x) * kThreads) {
    const uint32_t g = static_cast<uint32_t>(u % s.groups);
    const uint64_t rl = u / s.groups;
    const uint32_t l = static_cast<uint32_t>(rl % s.L);
    const long long r = static_cast<long long>(rl / s.L);
    const long long k = static_cast<long long>(g) * kVec;
    const uint32_t q = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
    const long long bo = r * s.b_r + l * s.b_l + k * s.b_k;
    uint32_t av[kVec], bv[kVec], cv[kVec], yv[kVec];
    if constexpr (kVec == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + r * s.a_r + l * s.a_l + k);
      av[0] = x.x, av[1] = x.y, av[2] = x.z, av[3] = x.w;
      if (s.b_k) {
        const uint4 w = *reinterpret_cast<const uint4*>(b + bo);
        bv[0] = w.x, bv[1] = w.y, bv[2] = w.z, bv[3] = w.w;
      } else {
        bv[0] = bv[1] = bv[2] = bv[3] = b[bo];
      }
      if constexpr (kAdd) {
        const uint4 v = *reinterpret_cast<const uint4*>(c + r * s.c_r + l * s.c_l + k);
        cv[0] = v.x, cv[1] = v.y, cv[2] = v.z, cv[3] = v.w;
      }
    } else {
      av[0] = a[r * s.a_r + l * s.a_l + k];
      bv[0] = b[bo];
      if constexpr (kAdd) cv[0] = c[r * s.c_r + l * s.c_l + k];
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const uint32_t w = bv[v];
      yv[v] = mul_mod(av[v], w, shoup_of(w, mu_hi, mu_lo), q);
      if constexpr (kAdd) yv[v] = add_mod(yv[v], cv[v], q);
    }
    uint32_t* yp = y + r * s.y_r + l * s.y_l + k;
    if constexpr (kVec == 4) {
      *reinterpret_cast<uint4*>(yp) = make_uint4(yv[0], yv[1], yv[2], yv[3]);
    } else {
      yp[0] = yv[0];
    }
  }
}

// The moduli of a launch, or false: 1 to kMaxLimbs, each in [2, 2^31) with
// mu = floor(2^64 / p) where mu is given.
bool make_limbs(const uint32_t* p, const uint64_t* mu, long long L, Limbs& mod) {
  using u128 = unsigned __int128;
  if (p == nullptr || L < 1 || L > kMaxLimbs) return false;
  for (int l = 0; l < L; ++l) {
    if (p[l] < 2 || p[l] >= (1u << 31)) return false;
    mod.p[l] = p[l];
    if (mu != nullptr) {
      if (static_cast<u128>(mu[l]) != (static_cast<u128>(1) << 64) / p[l]) return false;
      mod.mu_hi[l] = static_cast<uint32_t>(mu[l] >> 32);
      mod.mu_lo[l] = static_cast<uint32_t>(mu[l]);
    }
  }
  return true;
}

// A grid over `units` work items for the grid-stride kernels: at most 32
// CTAs an SM's worth, never more than the units need.
unsigned stride_grid(uint64_t units) {
  const uint64_t need = (units + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 32;
  return static_cast<unsigned>(need < cap ? (need ? need : 1) : cap);
}

}  // namespace

// ptr: int32 [csr_rows + 1] (null where `unit`: row r is nonzero r); idx:
// int64 [nnz] gather indices in row order; head: int64 [csr_rows], each
// row's first gather index (0 for an empty row; idx itself where unit);
// coef: uint32 words with strides coef_strides (host int64 [3]: nonzero,
// limb, slot; the slot's 0 where one coefficient serves every slot), at the
// window's first slot coef_lo; zptrs: host uint64 [nblocks] (each at its
// window's first slot); zmeta: host int64 [nblocks, 4] (first row, row,
// limb and slot strides); primes: host uint32 [L]; mu: host uint64 [L],
// floor(2^64 / p_l); out: uint32 [rows, L, n] or, where slot_major, [n, L,
// rows].  Rows longer than seg_len: nseg segments (int32 [nseg, 2] nonzero
// ranges) of nlong rows (seg_of int32 [nlong + 1], rows_of int32 [nlong]),
// their partial sums in scratch (uint32 [nseg, L, n]).
extern "C" int ringsnark_spmv(const void* ptr, const void* idx, const void* head,
                              const void* coef, const void* coef_strides, long long coef_lo,
                              const void* zptrs, const void* zmeta, int nblocks,
                              const void* primes, const void* mu, int L, long long csr_rows,
                              long long rows, long long n, int slot_major, int unit,
                              long long seg_len, const void* seg, const void* seg_of,
                              const void* rows_of, long long nseg, long long nlong,
                              void* scratch, void* out, void* stream) {
  Limbs mod = {};
  Assignment z = {};
  const long long* meta = static_cast<const long long*>(zmeta);
  const long long* cs = static_cast<const long long*>(coef_strides);
  const uint64_t* zp = static_cast<const uint64_t*>(zptrs);
  constexpr long long k32 = 1LL << 32;
  if (!make_limbs(static_cast<const uint32_t*>(primes), static_cast<const uint64_t*>(mu), L,
                  mod) ||
      mu == nullptr || out == nullptr || cs == nullptr || nblocks < 1 || nblocks > kMaxBlocks ||
      n < 1 || n >= (1LL << 31) || csr_rows < 0 || rows < csr_rows || rows >= (1LL << 31) ||
      (csr_rows > 0 && (idx == nullptr || coef == nullptr || (!unit && (ptr == nullptr ||
                                                                       head == nullptr)))) ||
      cs[0] < 0 || cs[0] >= k32 || cs[1] < 0 || cs[1] >= k32 || cs[2] < 0 || cs[2] > 1 ||
      coef_lo < 0 || (L - 1) * cs[1] + (coef_lo + n - 1) * cs[2] >= k32 || seg_len < 1 ||
      nseg < 0 || nlong < 0 || (nlong > 0 && (unit || seg == nullptr || seg_of == nullptr ||
                                              rows_of == nullptr || scratch == nullptr))) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  z.count = nblocks;
  for (int b = 0; b < nblocks; ++b) {
    const long long* m = meta + 4 * b;  // first row, row, limb and slot strides
    if (zp[b] == 0 || m[0] < 0 || m[0] >= k32 || (b == 0 && m[0]) ||
        (b > 0 && m[0] < m[-4]) || m[1] < 0 || m[1] >= k32 || m[2] < 0 || m[2] >= k32 ||
        m[3] < 0 || m[3] >= k32 || (L - 1) * m[2] + (n - 1) * m[3] >= k32) {
      return static_cast<int>(refused(cudaErrorInvalidValue));
    }
    z.b[b] = Block{reinterpret_cast<const uint32_t*>(zp[b]), static_cast<uint32_t>(m[1]),
                   static_cast<uint32_t>(m[2]), static_cast<uint32_t>(m[3]),
                   static_cast<uint32_t>(m[0])};
  }
  uint32_t log_ts = 0;
  while ((1LL << log_ts) < n && (1 << log_ts) < kMaxTileSlots) ++log_ts;
  SpmvShape s;
  s.L = static_cast<uint32_t>(L);
  s.n = static_cast<uint32_t>(n);
  s.log_ts = log_ts;
  s.slot_tiles = static_cast<uint32_t>((n + (1LL << log_ts) - 1) >> log_ts);
  s.seg_len = static_cast<uint32_t>(seg_len < (1LL << 31) ? seg_len : (1LL << 31));
  s.unit = unit ? 1 : 0;
  s.coef_k = static_cast<uint32_t>(cs[0]);
  s.coef_l = static_cast<uint32_t>(cs[1]);
  s.coef_i = static_cast<uint32_t>(cs[2]);
  if (L * n >= k32 || rows * L >= k32) {  // 32-bit products
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  const uint32_t* cw = static_cast<const uint32_t*>(coef) + coef_lo * cs[2];
  const long long* ip = static_cast<const long long*>(idx);
  const long long* hp = static_cast<const long long*>(head);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t log_tr = kLogTile - log_ts;
  auto grid = [&](long long nrows, SpmvShape& g) {
    g.row_tiles = static_cast<uint32_t>((nrows + (1LL << log_tr) - 1) >> log_tr);
    return static_cast<unsigned long long>(g.row_tiles) * g.slot_tiles * L;
  };
  if (nlong > 0) {  // the long rows' segments into the scratch
    SpmvShape g = s;
    g.rows = g.csr_rows = static_cast<uint32_t>(nseg);
    const unsigned long long ctas = grid(nseg, g);
    if (nseg < 1 || nseg >= (1LL << 31) || ctas >= (1ULL << 31)) {
      return static_cast<int>(refused(cudaErrorInvalidValue));
    }
    spmv_kernel<false, true><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(
        static_cast<const int*>(seg), ip, hp, cw, z, mod, g, static_cast<uint32_t*>(scratch));
  }
  s.rows = static_cast<uint32_t>(rows);
  s.csr_rows = static_cast<uint32_t>(csr_rows);
  const unsigned long long ctas = grid(rows, s);
  if (ctas < 1 || ctas >= (1ULL << 31)) return static_cast<int>(refused(cudaErrorInvalidValue));
  const int* pp = static_cast<const int*>(ptr);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (slot_major) {
    spmv_kernel<true, false><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(pp, ip, hp, cw, z,
                                                                               mod, s, o);
  } else {
    spmv_kernel<false, false><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(pp, ip, hp, cw,
                                                                                z, mod, s, o);
  }
  if (nlong > 0) {
    const unsigned mg = stride_grid(static_cast<uint64_t>(nlong) * L * n);
    const int* so = static_cast<const int*>(seg_of);
    const int* ro = static_cast<const int*>(rows_of);
    const uint32_t* sc = static_cast<const uint32_t*>(scratch);
    const uint32_t nl = static_cast<uint32_t>(nlong);
    if (slot_major) {
      spmv_merge_kernel<true><<<mg, kThreads, 0, st>>>(so, ro, sc, mod, s, nl, o);
    } else {
      spmv_merge_kernel<false><<<mg, kThreads, 0, st>>>(so, ro, sc, mod, s, nl, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// y, a, c: uint32 [R, L, K] with row and limb strides (the slot axis
// contiguous); b: the same shape with strides (b_k 0 or 1); c null: no add.
// strides: host int64 [9]: a_r, a_l, b_r, b_l, b_k, c_r, c_l, y_r, y_l.
// primes: host uint32 [L]; mu: host uint64 [L], floor(2^64 / p_l).
extern "C" int ringsnark_mulmod(void* y, const void* a, const void* b, const void* c,
                                long long R, long long L, long long K, const void* strides,
                                const void* primes, const void* mu, void* stream) {
  Limbs mod = {};
  const long long* st = static_cast<const long long*>(strides);
  if (y == nullptr || a == nullptr || b == nullptr || strides == nullptr || mu == nullptr ||
      !make_limbs(static_cast<const uint32_t*>(primes), static_cast<const uint64_t*>(mu), L,
                  mod) ||
      R < 1 || K < 1 || (st[4] != 0 && st[4] != 1)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  MulShape s;
  s.a_r = st[0], s.a_l = st[1], s.b_r = st[2], s.b_l = st[3], s.b_k = st[4];
  s.c_r = st[5], s.c_l = st[6], s.y_r = st[7], s.y_l = st[8];
  s.L = static_cast<uint32_t>(L);
  // four words a thread where every 16-byte word is aligned (b's only where
  // it varies along the slots)
  bool vec = K % 4 == 0;
  for (int k = 0; k < 9; ++k) vec = vec && (k == 4 || (k >= 2 && k <= 3 && !st[4]) ||
                                            st[k] % 4 == 0);
  const void* base[4] = {y, a, st[4] ? b : nullptr, c};
  for (const void* ptr : base) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const long long groups = vec ? K / 4 : K;
  if (groups >= (1LL << 32) || static_cast<unsigned __int128>(R) * L * groups >= (1ULL << 62)) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  s.groups = static_cast<uint32_t>(groups);
  s.units = static_cast<uint64_t>(R) * L * groups;
  const unsigned grid = stride_grid(s.units);
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  uint32_t* yp = static_cast<uint32_t*>(y);
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  const uint32_t* cp = static_cast<const uint32_t*>(c);
  if (vec) {
    if (c != nullptr) {
      mulmod_kernel<4, true><<<grid, kThreads, 0, stm>>>(yp, ap, bp, cp, mod, s);
    } else {
      mulmod_kernel<4, false><<<grid, kThreads, 0, stm>>>(yp, ap, bp, cp, mod, s);
    }
  } else if (c != nullptr) {
    mulmod_kernel<1, true><<<grid, kThreads, 0, stm>>>(yp, ap, bp, cp, mod, s);
  } else {
    mulmod_kernel<1, false><<<grid, kThreads, 0, stm>>>(yp, ap, bp, cp, mod, s);
  }
  return static_cast<int>(cudaGetLastError());
}
