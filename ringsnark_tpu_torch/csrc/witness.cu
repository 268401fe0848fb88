// The witness map's two kernels for Hopper (sm_90a): the constraint
// evaluations A.z, B.z, C.z as a sparse matrix-vector product over the slots
// (spmv_kernel, every matrix of a call in one launch), and the pointwise
// product y = a * b (+ c) mod p_l (mulmod_kernel).
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
// spmv_kernel: for each of up to kMaxMats matrices m, out_m[r, l, i] = sum
// over the nonzeros k of row r of coef_m[k, l, i or 0] * z[idx_m[k], l, i]
// mod p_l, for the output rows r < rows (rows past the CSR's are zero).  The
// CSR (int32 row pointers, the int64 gather indices in row order, each row's
// first index again by row, the rows longer than long_len; none of the first
// three where every row is one nonzero, `unit`) is derived once per compiled
// system by relations/r1cs.py, which checks every index there; where the
// system's COO is already in row order (as `compile` and the models emit
// it) the indices and the coefficients are the COO's own tensors, read in
// place with their strides.  The assignment z is up to kMaxBlocks row blocks
// (the constant one, the primary and the auxiliary rows of the prover, or
// one tensor), each with its own strides, so a slot window of the whole
// assignment is read in place.  The output is [rows, L, n] (slot fastest:
// eval_matrices' layout) or slot-major [n, L, rows] (row fastest: what the
// interpolating inverse NTT takes).
//
// Exactness: every modulus p_l lies in [2, 2^31) (the wrapper refuses any
// other by name), every coefficient and assignment word is canonical (< p_l:
// the coefficients are reduced when the system is compiled, the assignment
// is residues).  A term takes the coefficient word's Shoup constant made
// from mu_l = floor(2^64 / p_l)'s halves and mul_mod (modarith.cuh; exact
// for z < 2^31 and c < p_l, csrc/mac.cu's head proves it): the canonical
// residue of z * c.  Terms are summed with add_mod, which keeps the sum
// canonical (two canonical words sum below 2^32), so the result is the
// canonical residue of the exact sum in any order and under any split of a
// row's nonzeros: bit for bit plain spmv's remainder of the int64 sum of
// remainders, and the JAX package's Barrett reduction of its u64 segment sum.
//
// Work: a launch's items are, matrix by matrix, first its long rows (one
// item a (long row, limb, slot tile)), then the tiles of TR rows by TS
// slots (matrix fastest, then slot tile, then limb, then row tile: the
// matrices of a call gather a tile's rows while they are in the L2, where A
// and B share them, and the limbs of a row tile run together).  The C
// launcher reads the occupancy and starts the resident CTAs; CTA b takes
// items b, b + grid, ... in that order.  A tile's thread takes VEC adjacent
// slots (4, as 16-byte words, where the slot stride is 1 and every window
// is 16-byte aligned; else 1) of 8 rows (4 at VEC 1): G = TS / VEC threads
// a row, at most a warp, so n >= 128 gives TS = 128 and TR = 64, a
// gathered row read in runs of 512 bytes (slot-major at n > 1 takes the
// four-slot tile whatever VEC, at least 32 slots wide).  At n = 1 a tile
// is 1024 rows of all L limbs (up to kMaxTileLimbs; else one), a row's
// limbs a thread: its head index is loaded once for them and their words
// share sectors.
//
// Cause and remedy, measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// the first design of this kernel, one tile a CTA, had its bytes in flight
// for one of three round trips (row data, gathers, store) in 262,144 short
// CTAs at the north star's chunk, and its slot-major store waited on a CTA
// barrier.  Here each CTA keeps the next tile's gathers in flight while it
// computes and stores the current one: a kStages ring in shared memory,
// filled by cp.async (16 bytes a thread, or 4 where the block broadcasts
// one slot or the 16-byte path is off) from the row heads loaded for that
// tile (two tiles ahead where registers allow).  In a tile of the 16-byte
// path each thread reads back only the words it copied itself, so a stage
// needs only cp.async's wait; at n = 1 the heads' coefficients ride in the
// ring too, else in a register one tile ahead.  Every slot-major tile at n
// > 1 is a warp tile (warp_tiles, TS >= 32): a warp owns 32 rows by 32
// slots, copies them swizzled (16 bytes a chunk, or a word a slot below n
// where the 16-byte path is off), and each lane computes and stores one
// row, so each store is a slot's 32 rows and no CTA barrier stands between
// a warp's gathers and its stores (a CTA-wide transposing tile instead
// took 1.6x the time at the north star's chunk).  A short row's further
// nonzeros (rows of 2 to long_len) step together across the thread's rows.
// A row longer than long_len is an item of its own: the CTA's threads
// share its nonzeros (kLongUnroll a thread in flight, the next round's
// indices loaded ahead) and add their partial sums with add_mod in the
// ring's words (no scratch, no second launch); the tiles skip it.
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
// spmv of A and B at the north star's chunk reads z's window once for both
// (2^18 rows x 1024 slots, 1 GiB; A and B gather the same rows) and writes
// their outputs (2 GiB), the CSRs a few MiB: 0.963 ms at 3.35 TB/s, of
// which it takes 1.34 ms (72 %; 73 % at the seeded chunk, 43 % at Z_q's
// and logreg's launch-sized calls; NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
// A term is five IMAD (two for the constant) and two ALU operations and the
// sum an add and a min: ~2.7 x 10^9 IMAD for both, 0.16 ms on the
// multiplier's 16.75 T/s.  mulmod over [1024, 1, 2^19] reads two words and
// writes one (6 GiB, 1.9 ms) for 5 IMAD and 2 ALU operations.
//
// C interface: ringsnark_spmv and ringsnark_mulmod return
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for a configuration they refuse; the Python wrapper
// (ops/cuda_witness.py) raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, add_mod, shoup_of, mul_mod, refused

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
// a thread's rows in a tile: 8 at VEC 4, 4 at VEC 1
template <int kVec>
constexpr int kLogRowsPerThread = kVec == 4 ? 3 : 2;
template <int kVec>
constexpr int kRowsPerThread = 1 << kLogRowsPerThread<kVec>;
constexpr int kMaxTileLimbs = 4;  // at n = 1 a tile's limbs: its words and coefficients in the ring
constexpr int kLogMaxGroup = 5;  // a row takes at most a warp of a tile's threads
constexpr int kLogLongGroup = 3;  // a long row's slot group: at most 8 threads
constexpr int kStages = 2;       // the ring's stages: one computed, one in flight
constexpr int kLongUnroll = 8;   // a long row's nonzeros a thread has in flight (half at VEC 4)
constexpr int kMaxMats = 3;      // matrices a launch
constexpr int kMaxBlocks = 3;    // row blocks of the assignment
constexpr int kMaxLimbs = 32;
static_assert(kThreads == 1 << kLogThreads, "");

// a ring stage: 32 words a thread, its rows' VEC words (8 x 4), a warp
// tile's 32 x 32, or at n = 1 its rows' words and coefficients (4 x up to 4
// limbs x 2); a long row's partial sums (at most 4 a thread) reuse it
constexpr int kStageWords = kThreads * 32;
static_assert(kRowsPerThread<4> * 4 <= 32 && 2 * kRowsPerThread<1> * kMaxTileLimbs <= 32, "");
constexpr int kSmemBytes = kStages * kStageWords * 4;

// Rows [start, next block's start) of the assignment: word (row, l, i) at
// ptr + (row - start) * row + l * limb + i * slot (ptr at the window's first
// slot; a stride of 0 broadcasts).  The strides, and a row's offsets l *
// limb + i * slot, fit 32 bits (the launcher checks).
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

// One matrix of a launch.
struct Mat {
  const int* ptr;          // int32 [csr_rows + 1]; null where unit (row r is nonzero r)
  const long long* idx;    // int64 [nnz]: the gather indices in row order
  const int* head;         // int32 [csr_rows]: each row's first gather index (unit: unread)
  const uint32_t* coef;    // at the window's first slot
  const int* longs;        // int32 [nlong]: the rows of more than long_len nonzeros
  uint32_t* out;
  uint32_t csr_rows, nlong, unit, long_len;
  uint32_t coef_k, coef_l, coef_i;  // the coefficients' strides (coef_i 0: one for all slots)
  uint32_t long_items;              // nlong * L * long_slot_tiles
};

struct Spmv {
  Mat m[kMaxMats];
  uint32_t mats, L, n, rows;
  uint32_t log_g;              // G = 1 << log_g threads a row in a tile
  uint32_t lt, limb_tiles;     // limbs a tile (L at n = 1 up to kMaxTileLimbs, else 1); L / lt
  uint32_t slot_tiles, tiles;  // slot tiles; a matrix's tiles (row, limb and slot tiles)
  uint32_t log_gl, long_slot_tiles;  // a long row's threads a slot group (<= 8); its groups
  uint32_t long_items, items;  // every matrix's long items; long items + mats * tiles
};

// The assignment's word (c, l, i) and its block's slot stride: c in the
// last block that starts at or below it.  Each field is selected on its own
// (a select of a block's address would read the parameters with an indexed
// load).
struct ZRef {
  const uint32_t* p;
  uint32_t slot;
};

__device__ __forceinline__ ZRef z_ref(const Assignment& z, uint32_t c, uint32_t l, uint32_t i) {
  const bool in2 = z.count > 2 && c >= z.b[2].start;
  const bool in1 = !in2 && z.count > 1 && c >= z.b[1].start;
#define RINGSNARK_FIELD(f) (in2 ? z.b[2].f : (in1 ? z.b[1].f : z.b[0].f))
  const uint32_t slot = RINGSNARK_FIELD(slot);
  const uint64_t off = static_cast<uint64_t>(c - RINGSNARK_FIELD(start)) * RINGSNARK_FIELD(row) +
                       (l * RINGSNARK_FIELD(limb) + i * slot);
  return ZRef{RINGSNARK_FIELD(ptr) + off, slot};
#undef RINGSNARK_FIELD
}

// VEC words of the assignment from r: one 16-byte load where the slot
// stride is 1 (the launcher checks the alignment), else VEC loads (stride
// 0: one slot broadcast).
template <int kVec>
__device__ __forceinline__ void z_load(const ZRef& r, uint32_t (&v)[kVec]) {
  if constexpr (kVec == 4) {
    if (r.slot == 1) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(r.p));
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u) v[u] = __ldg(r.p + u * r.slot);
}

// The coefficients of nonzero k at limb l for slots i..i+VEC-1.
template <int kVec>
__device__ __forceinline__ void coef_load(const Mat& M, int k, uint32_t l, uint32_t i,
                                          uint32_t (&w)[kVec]) {
  const uint32_t* c = M.coef + static_cast<uint64_t>(static_cast<uint32_t>(k)) * M.coef_k +
                      (l * M.coef_l + i * M.coef_i);
  if constexpr (kVec == 4) {
    if (M.coef_i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(c));
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u) w[u] = __ldg(c + u * M.coef_i);
}

// Four adjacent slots from slot i of the assignment (z4) or of nonzero k's
// coefficients at limb l (coef4): 16-byte words at kVec 4 (n a multiple of
// four), else a word a slot, those at or past `left` = n - i zero.
template <int kVec>
__device__ __forceinline__ void z4(const ZRef& r, uint32_t left, uint32_t (&v)[4]) {
  if constexpr (kVec == 4) {
    z_load<4>(r, v);
  } else {
#pragma unroll
    for (uint32_t u = 0; u < 4; ++u) v[u] = u < left ? __ldg(r.p + u * r.slot) : 0u;
  }
}

template <int kVec>
__device__ __forceinline__ void coef4(const Mat& M, int k, uint32_t l, uint32_t i, uint32_t left,
                                      uint32_t (&w)[4]) {
  if constexpr (kVec == 4) {
    coef_load<4>(M, k, l, i, w);
  } else {
#pragma unroll
    for (uint32_t u = 0; u < 4; ++u) {
      uint32_t x[1] = {0u};
      if (u < left) coef_load<1>(M, k, l, i + u, x);
      w[u] = x[0];
    }
  }
}

// The term coef * zw mod p: the coefficient word's Shoup constant made from
// mu's halves (coefficients and assignment words canonical, p < 2^31).
__device__ __forceinline__ uint32_t term(uint32_t zw, uint32_t w, uint32_t p, uint32_t mu_hi,
                                         uint32_t mu_lo) {
  return mul_mod(zw, w, shoup_of(w, mu_hi, mu_lo), p);
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kNewer>
__device__ __forceinline__ void cp_async_wait() {  // all but the kNewer newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kNewer) : "memory");
}

// Output word (r, l, i) of matrix M.
template <bool kSlotMajor>
__device__ __forceinline__ uint32_t* out_at(const Spmv& s, const Mat& M, uint32_t r, uint32_t l,
                                            uint32_t i) {
  return M.out + (kSlotMajor ? static_cast<uint64_t>(i * s.L + l) * s.rows + r
                             : static_cast<uint64_t>(r * s.L + l) * s.n + i);
}

// A long row's item u (its matrix's long items counted from 0 across the
// matrices): the CTA's threads, G = 1 << log_gl (at most 8) to a slot
// group of VEC * G slots and K = 256 / G (32 or more) deep, share the row's
// nonzeros (thread (q, g): nonzeros k0 + q, q + K, ..., U at once with the
// next round's indices loaded ahead); their partial sums are added in `tile`
// (K x VEC * G words) by halves with add_mod; the threads q = 0 store them.
template <bool kSlotMajor, int kVec>
__device__ __forceinline__ void long_item(const Spmv& s, const Assignment& z, const Limbs& mod,
                                          uint32_t u, uint32_t* tile) {
  uint32_t mi = 0;
  while (mi + 1 < s.mats && u >= s.m[mi].long_items) u -= s.m[mi].long_items, ++mi;
  const Mat& M = s.m[mi];
  const uint32_t st = u % s.long_slot_tiles;
  u /= s.long_slot_tiles;
  const uint32_t l = u % s.L, j = u / s.L;
  const uint32_t g = threadIdx.x & ((1u << s.log_gl) - 1), q = threadIdx.x >> s.log_gl;
  const uint32_t r = static_cast<uint32_t>(__ldg(M.longs + j));
  const int k1 = __ldg(M.ptr + r + 1);
  const uint32_t ts = static_cast<uint32_t>(kVec) << s.log_gl;
  const uint32_t i = st * ts + g * kVec;
  const bool live = i < s.n;
  const uint32_t p = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
  const int K = kThreads >> s.log_gl;
  constexpr int U = kVec == 4 ? kLongUnroll / 2 : kLongUnroll;  // words in flight: 16 or 8
  uint32_t acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0;
  if (live) {
    int k = __ldg(M.ptr + r) + static_cast<int>(q);
    uint32_t cn[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int kk = k + e * K;
      cn[e] = kk < k1 ? static_cast<uint32_t>(__ldg(M.idx + kk)) : 0u;
    }
    for (; k < k1; k += U * K) {
      uint32_t c[U], zv[U][kVec], wv[U][kVec];
#pragma unroll
      for (int e = 0; e < U; ++e) {
        c[e] = cn[e];
        const int kk = k + (U + e) * K;
        cn[e] = kk < k1 ? static_cast<uint32_t>(__ldg(M.idx + kk)) : 0u;
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        if (k + e * K < k1) {
          z_load<kVec>(z_ref(z, c[e], l, i), zv[e]);
          coef_load<kVec>(M, k + e * K, l, i, wv[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        if (k + e * K < k1) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            acc[v] = add_mod(acc[v], term(zv[e][v], wv[e][v], p, mu_hi, mu_lo), p);
          }
        }
      }
    }
  }
  const uint32_t a = q * ts + g * kVec;
  __syncthreads();  // the tile's last readers are done
#pragma unroll
  for (int v = 0; v < kVec; ++v) tile[a + v] = acc[v];
  __syncthreads();
  for (uint32_t h = static_cast<uint32_t>(K) >> 1; h > 0; h >>= 1) {
    if (q < h) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) tile[a + v] = add_mod(tile[a + v], tile[a + h * ts + v], p);
    }
    __syncthreads();
  }
  if (q == 0 && live) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) *out_at<kSlotMajor>(s, M, r, l, i + v) = tile[a + v];
  }
}

// A tile: matrix, limb, first row and first slot.
struct TileAt {
  uint32_t m, l, r0, i0;
};

// Short tile t (its matrix fastest, then slot tile, limb, row tile).
__device__ __forceinline__ TileAt tile_at(const Spmv& s, uint32_t t, uint32_t log_ts,
                                          uint32_t log_tr) {
  TileAt a;
  a.m = t % s.mats;
  t /= s.mats;
  a.i0 = (t % s.slot_tiles) << log_ts;
  t /= s.slot_tiles;
  a.l = t % s.limb_tiles;
  a.r0 = (t / s.limb_tiles) << log_tr;
  return a;
}

// A lane's row of a warp tile: its first nonzero, length, head and the
// head's scalar coefficient.
struct LaneRow {
  int k0, len;
  uint32_t c, w;
};

// The slot-major tiles at n > 1 (8 warp tiles of 32 rows by 32 slots a
// tile, TS >= 32): warp w owns one, each lane one of its rows, so no barrier
// of the CTA stands between a warp's gathers and its stores.  Lane l copies
// chunk l % 8 (4 slots: one 16-byte copy at kVec 4 where the block's slot
// stride is 1, else a word a slot below n) of rows l / 8 + 4k into the
// warp's ring words, chunk c of row rho at rho * 32 + 4 (c ^ rho % 8), and
// computes its own row from them after the warp's copies landed (a word
// past n is stale and its sum not stored); each of its stores is a slot's
// 32 rows, 128 bytes.  Row data two tiles ahead, gathers one.
template <int kVec>
__device__ __forceinline__ void warp_tiles(const Spmv& s, const Assignment& z, const Limbs& mod,
                                           uint32_t t, uint32_t* ring) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t log_ts = s.log_g + 2, log_tr = kLogThreads - s.log_g + kLogRowsPerThread<4>;
  const uint32_t log_rb = log_tr - 5;  // 32-row blocks a tile
  const uint32_t rb = warp & ((1u << log_rb) - 1), sb = warp >> log_rb;
  uint32_t* const mine = ring + warp * 1024;
  const uint32_t step = gridDim.x, short_items = s.items - s.long_items;
  auto row_of = [&](const TileAt& a, LaneRow& x) {
    const Mat& M = s.m[a.m];
    const uint32_t r = a.r0 + (rb << 5) + lane;
    x.k0 = x.len = 0, x.c = x.w = 0;
    if (r < M.csr_rows) {
      if (M.unit) {
        x.k0 = static_cast<int>(r), x.len = 1;
        x.c = static_cast<uint32_t>(__ldg(M.idx + r));
      } else {
        x.k0 = __ldg(M.ptr + r), x.len = __ldg(M.ptr + r + 1) - x.k0;
        x.c = static_cast<uint32_t>(__ldg(M.head + r));
      }
    }
  };
  auto issue = [&](const TileAt& a, uint32_t* stage, LaneRow& x) {
    const Mat& M = s.m[a.m];
    const int long_len = static_cast<int>(M.long_len);
    if (x.len > 0 && x.len <= long_len && !M.coef_i) {
      x.w = __ldg(M.coef + static_cast<uint64_t>(static_cast<uint32_t>(x.k0)) * M.coef_k +
                  a.l * M.coef_l);
    }
    const uint32_t chunk = lane & 7, i = a.i0 + (sb << 5) + chunk * 4;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t rho = (lane >> 3) + 4 * k;
      const uint32_t c = __shfl_sync(kAll, x.c, rho);
      const int len = __shfl_sync(kAll, x.len, rho);
      if (i < s.n && len > 0 && len <= long_len) {
        const ZRef zr = z_ref(z, c, a.l, i);
        uint32_t* dst = stage + rho * 32 + ((chunk ^ (rho & 7)) << 2);
        if (kVec == 4 && zr.slot == 1) {
          cp_async16(dst, zr.p);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (kVec == 4 || i + v < s.n) cp_async4(dst + v, zr.p + v * zr.slot);
          }
        }
      }
    }
    cp_async_commit();
  };
  auto run = [&](const TileAt& a, const uint32_t* stage, const LaneRow& x) {
    __syncwarp();  // every lane's copies of the stage have landed (each waited on its own)
    const Mat& M = s.m[a.m];
    const uint32_t l = a.l, i0 = a.i0 + (sb << 5);
    const uint32_t p = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
    const bool short_row = x.len > 0 && x.len <= static_cast<int>(M.long_len);
    uint32_t val[8][4];
    const uint32_t sh = shoup_of(x.w, mu_hi, mu_lo);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const uint32_t i = i0 + c8 * 4;
#pragma unroll
      for (int v = 0; v < 4; ++v) val[c8][v] = 0;
      if (short_row && i < s.n) {
        const uint4 zs = *reinterpret_cast<const uint4*>(stage + lane * 32 +
                                                         ((c8 ^ (lane & 7)) << 2));
        const uint32_t zw[4] = {zs.x, zs.y, zs.z, zs.w};
        if (!M.coef_i) {
#pragma unroll
          for (int v = 0; v < 4; ++v) val[c8][v] = mul_mod(zw[v], x.w, sh, p);
        } else {
          uint32_t wv[4];
          coef4<kVec>(M, x.k0, l, i, s.n - i, wv);
#pragma unroll
          for (int v = 0; v < 4; ++v) val[c8][v] = term(zw[v], wv[v], p, mu_hi, mu_lo);
        }
      }
    }
    for (int k = x.k0 + 1; short_row && k < x.k0 + x.len; ++k) {  // the row's further nonzeros
      const uint32_t c = static_cast<uint32_t>(__ldg(M.idx + k));
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const uint32_t i = i0 + c8 * 4;
        if (i < s.n) {
          uint32_t zv[4], wv[4];
          z4<kVec>(z_ref(z, c, l, i), s.n - i, zv);
          coef4<kVec>(M, k, l, i, s.n - i, wv);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            val[c8][v] = add_mod(val[c8][v], term(zv[v], wv[v], p, mu_hi, mu_lo), p);
          }
        }
      }
    }
    const uint32_t r = a.r0 + (rb << 5) + lane;
    if (r < s.rows && x.len <= static_cast<int>(M.long_len)) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint32_t i = i0 + c8 * 4 + v;
          if (i < s.n) *out_at<true>(s, M, r, l, i) = val[c8][v];
        }
      }
    }
  };

  TileAt cur = tile_at(s, t, log_ts, log_tr), nxt = cur;
  LaneRow x, nx = {};
  row_of(cur, x);
  if (t + step < short_items) {
    nxt = tile_at(s, t + step, log_ts, log_tr);
    row_of(nxt, nx);
  }
  issue(cur, mine, x);
  uint32_t st = 0;
  for (;; t += step, st ^= 1) {
    if (t + step >= short_items) {
      cp_async_wait<0>();
      run(cur, mine + st * kStageWords, x);
      return;
    }
    __syncwarp();  // every lane has read the stage the next copies overwrite
    issue(nxt, mine + (st ^ 1) * kStageWords, nx);
    TileAt later = nxt;
    LaneRow lx = nx;
    if (t + 2 * step < short_items) {
      later = tile_at(s, t + 2 * step, log_ts, log_tr);
      row_of(later, lx);
    }
    cp_async_wait<1>();
    run(cur, mine + st * kStageWords, x);
    cur = nxt, x = nx, nxt = later, nx = lx;
  }
}

// kSlotMajor: the outputs are [n, L, rows], else [rows, L, n]; slot-major
// at n > 1 takes the warp tiles (kWarp), so the other slot-major kernel
// serves n = 1 alone.  kVec: a thread's adjacent slots (4: 16-byte words).
template <bool kSlotMajor, int kVec, bool kWarp>
__global__ void __launch_bounds__(kThreads, kWarp ? 3 : 2)
    spmv_kernel(const __grid_constant__ Spmv s, const __grid_constant__ Assignment z,
                const __grid_constant__ Limbs mod) {
  constexpr int R = kRowsPerThread<kVec>;
  constexpr uint32_t kLogVec = kVec == 4 ? 2 : 0;
  constexpr int kAhead = kVec == 4 ? 1 : 2;  // the 16-byte kernels have no registers for two
  extern __shared__ uint4 smem4[];
  uint32_t* const ring = reinterpret_cast<uint32_t*>(smem4);
  const uint32_t tid = threadIdx.x;
  const uint32_t log_g = s.log_g, log_rp = kLogThreads - log_g;
  const uint32_t log_ts = log_g + kLogVec, log_tr = log_rp + kLogRowsPerThread<kVec>;
  const uint32_t g = tid & ((1u << log_g) - 1), q = tid >> log_g;

  uint32_t u = blockIdx.x;
  for (; u < s.long_items; u += gridDim.x) long_item<kSlotMajor, kVec>(s, z, mod, u, ring);
  if (u >= s.items) return;
  if (blockIdx.x < s.long_items) __syncthreads();  // the long rows' sums are read from the ring
  if constexpr (kWarp) {
    warp_tiles<kVec>(s, z, mod, u - s.long_items, ring);
    return;
  }

  auto at = [&](uint32_t t) { return tile_at(s, t, log_ts, log_tr); };
  // A tile's rows for this thread (r0 + q + j * 256 / G): their first
  // nonzero, length and head (first gather index); nothing past the CSR.
  auto rows_of = [&](const TileAt& a, int (&k0)[R], int (&len)[R], uint32_t (&c)[R]) {
    const Mat& M = s.m[a.m];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t r = a.r0 + q + (static_cast<uint32_t>(j) << log_rp);
      k0[j] = len[j] = 0, c[j] = 0;
      if (r < M.csr_rows) {
        if (M.unit) {
          k0[j] = static_cast<int>(r), len[j] = 1;
          c[j] = static_cast<uint32_t>(__ldg(M.idx + r));
        } else {
          k0[j] = __ldg(M.ptr + r), len[j] = __ldg(M.ptr + r + 1) - k0[j];
          c[j] = static_cast<uint32_t>(__ldg(M.head + r));
        }
      }
    }
  };
  // The heads' assignment words into a ring stage by cp.async (each thread
  // its own words), their scalar coefficients into registers; one group.
  auto issue = [&](const TileAt& a, uint32_t* stage, const int (&k0)[R], const int (&len)[R],
                   const uint32_t (&c)[R], uint32_t (&w)[R]) {
    const Mat& M = s.m[a.m];
    const uint32_t i = a.i0 + g * kVec;
    if (kSlotMajor || log_ts == 0) {  // n = 1: the tile's limbs, word (j, e) and its coefficient
#pragma unroll
      for (int j = 0; j < R; ++j) {
        w[j] = 0;
        if (len[j] > 0 && len[j] <= static_cast<int>(M.long_len)) {
          const uint32_t* cw = M.coef +
                               static_cast<uint64_t>(static_cast<uint32_t>(k0[j])) * M.coef_k;
          for (uint32_t e = 0; e < s.lt; ++e) {
            const uint32_t at_z = ((j * s.lt + e) << kLogThreads) + tid;
            cp_async4(stage + at_z, z_ref(z, c[j], a.l + e, 0).p);
            cp_async4(stage + at_z + ((R * s.lt) << kLogThreads), cw + (a.l + e) * M.coef_l);
          }
        }
      }
      cp_async_commit();
      return;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      w[j] = 0;
      if (i < s.n && len[j] > 0 && len[j] <= static_cast<int>(M.long_len)) {
        const ZRef zr = z_ref(z, c[j], a.l, i);
        uint32_t* dst = stage + ((static_cast<uint32_t>(j) << kLogThreads) + tid) * kVec;
        if (kVec == 4 && zr.slot == 1) {
          cp_async16(dst, zr.p);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) cp_async4(dst + v, zr.p + v * zr.slot);
        }
        if (!M.coef_i) {
          w[j] = __ldg(M.coef + static_cast<uint64_t>(static_cast<uint32_t>(k0[j])) * M.coef_k +
                       a.l * M.coef_l);
        }
      }
    }
    cp_async_commit();
  };
  // A tile's sums from its stage (the heads) and the rows' further
  // nonzeros, and their store.
  auto run = [&](const TileAt& a, const uint32_t* stage, const int (&k0)[R], const int (&len)[R],
                 const uint32_t (&w)[R]) {
    const Mat& M = s.m[a.m];
    if (kSlotMajor || log_ts == 0) {  // n = 1: limb by limb, a row a thread, a warp's rows adjacent
      const int long_len = static_cast<int>(M.long_len);
      for (uint32_t e = 0; e < s.lt; ++e) {
        const uint32_t l = a.l + e;
        const uint32_t p = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
        uint32_t val[R];
        int steps = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          val[j] = 0;
          if (len[j] > 0 && len[j] <= long_len) {
            const uint32_t at_z = ((j * s.lt + e) << kLogThreads) + tid;
            val[j] = term(stage[at_z], stage[at_z + ((R * s.lt) << kLogThreads)], p, mu_hi, mu_lo);
            steps = max(steps, len[j] - 1);
          }
        }
        for (int step = 1; step <= steps; ++step) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (step < len[j] && len[j] <= long_len) {
              const int k = k0[j] + step;
              const uint32_t zw = __ldg(z_ref(z, static_cast<uint32_t>(__ldg(M.idx + k)), l, 0).p);
              const uint32_t wk = __ldg(M.coef + static_cast<uint64_t>(static_cast<uint32_t>(k)) *
                                                     M.coef_k + l * M.coef_l);
              val[j] = add_mod(val[j], term(zw, wk, p, mu_hi, mu_lo), p);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const uint32_t r = a.r0 + q + (static_cast<uint32_t>(j) << log_rp);
          if (r < s.rows && len[j] <= long_len) *out_at<kSlotMajor>(s, M, r, l, 0) = val[j];
        }
      }
      return;
    }
    const uint32_t l = a.l, i = a.i0 + g * kVec;
    const bool live = i < s.n;
    const uint32_t p = mod.p[l], mu_hi = mod.mu_hi[l], mu_lo = mod.mu_lo[l];
    const int long_len = static_cast<int>(M.long_len);
    uint32_t val[R][kVec];
    int steps = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) val[j][v] = 0;
      if (live && len[j] > 0 && len[j] <= long_len) {
        const uint32_t* src = stage + ((static_cast<uint32_t>(j) << kLogThreads) + tid) * kVec;
        uint32_t zs[kVec];
        if constexpr (kVec == 4) {
          const uint4 x = *reinterpret_cast<const uint4*>(src);
          zs[0] = x.x, zs[1] = x.y, zs[2] = x.z, zs[3] = x.w;
        } else {
          zs[0] = src[0];
        }
        if (!M.coef_i) {
          const uint32_t sh = shoup_of(w[j], mu_hi, mu_lo);
#pragma unroll
          for (int v = 0; v < kVec; ++v) val[j][v] = mul_mod(zs[v], w[j], sh, p);
        } else {
          uint32_t wv[kVec];
          coef_load<kVec>(M, k0[j], l, i, wv);
#pragma unroll
          for (int v = 0; v < kVec; ++v) val[j][v] = term(zs[v], wv[v], p, mu_hi, mu_lo);
        }
        steps = max(steps, len[j] - 1);
      }
    }
    // the rows' further nonzeros, every row's loads of a step in flight together
    for (int step = 1; step <= steps; ++step) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (step < len[j] && len[j] <= long_len) {
          const int k = k0[j] + step;
          uint32_t zv[kVec], wv[kVec];
          z_load<kVec>(z_ref(z, static_cast<uint32_t>(__ldg(M.idx + k)), l, i), zv);
          coef_load<kVec>(M, k, l, i, wv);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            val[j][v] = add_mod(val[j][v], term(zv[v], wv[v], p, mu_hi, mu_lo), p);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t r = a.r0 + q + (static_cast<uint32_t>(j) << log_rp);
      if (r < s.rows && live && len[j] <= long_len) {
        uint32_t* o = out_at<kSlotMajor>(s, M, r, l, i);
        if constexpr (kVec == 4) {
          *reinterpret_cast<uint4*>(o) = make_uint4(val[j][0], val[j][1], val[j][2], val[j][3]);
        } else {
          o[0] = val[j][0];
        }
      }
    }
  };

  // The ring: the next tile's gathers are issued into the other stage
  // before the current tile's are waited on, computed and stored; the row
  // data come kAhead tiles ahead (with two, no round trip of a tile's rows
  // waits in line before its gathers).
  const uint32_t step = gridDim.x, short_items = s.items - s.long_items;
  uint32_t t = u - s.long_items;
  TileAt cur = at(t), nxt = cur;
  int k0[R], len[R], nk0[R], nlen[R];
  uint32_t w[R], nw[R], nc[R];
  {
    uint32_t c[R];
    rows_of(cur, k0, len, c);
    if (kAhead == 2 && t + step < short_items) {
      nxt = at(t + step);
      rows_of(nxt, nk0, nlen, nc);
    }
    issue(cur, ring, k0, len, c, w);
  }
  uint32_t st = 0;
  for (;; t += step, st ^= 1) {
    if (t + step >= short_items) {
      cp_async_wait<0>();
      run(cur, ring + st * kStageWords, k0, len, w);
      return;
    }
    if (kAhead == 1) {
      nxt = at(t + step);
      rows_of(nxt, nk0, nlen, nc);
    }
    issue(nxt, ring + (st ^ 1) * kStageWords, nk0, nlen, nc, nw);
    TileAt later = nxt;
    int lk0[R], llen[R];
    uint32_t lc[R];
    if (kAhead == 2 && t + 2 * step < short_items) {
      later = at(t + 2 * step);
      rows_of(later, lk0, llen, lc);
    }
    cp_async_wait<1>();
    run(cur, ring + st * kStageWords, k0, len, w);
    cur = nxt;
#pragma unroll
    for (int j = 0; j < R; ++j) k0[j] = nk0[j], len[j] = nlen[j], w[j] = nw[j];
    if (kAhead == 2) {
      nxt = later;
#pragma unroll
      for (int j = 0; j < R; ++j) nk0[j] = lk0[j], nlen[j] = llen[j], nc[j] = lc[j];
    }
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

// The CTAs of a spmv launch over `items` items: those the kernel keeps
// resident (its SMs times the CTAs an SM holds with its shared memory, read
// from the runtime once a process and kernel), at most one an item; 0 where
// the runtime cannot say.  The sums are exact, so the grid moves no result.
template <bool kSlotMajor, int kVec, bool kWarp = false>
cudaError_t launch_spmv(const Spmv& s, const Assignment& z, const Limbs& mod,
                        cudaStream_t stream) {
  const auto kernel = spmv_kernel<kSlotMajor, kVec, kWarp>;
  constexpr int bytes = kSmemBytes;
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
           cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes) !=
           cudaSuccess)) {
    per_sm = 0;
  }
  int dev = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return refused(cudaErrorInvalidValue);
  }
  const uint64_t resident = static_cast<uint64_t>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(resident < s.items ? resident : s.items);
  kernel<<<grid, kThreads, bytes, stream>>>(s, z, mod);
  return cudaGetLastError();
}

}  // namespace

// mats: host int64 [nmats, 13], a matrix a row: its pointers ptr (int32
// [csr_rows + 1], null where unit: row r is nonzero r), idx (int64 [nnz],
// gather indices in row order), head (int32 [csr_rows], each row's first
// gather index, 0 for an empty row; unread where unit), coef (uint32
// words at slot 0), longs (int32 [nlong], the rows of more than long_len
// nonzeros, each its own item), out (uint32 [rows, L, n] or, where
// slot_major, [n, L, rows]); then csr_rows, nlong, unit, long_len and the
// coefficients' strides (nonzero, limb, slot: 0 where one coefficient
// serves every slot).  zptrs: host uint64 [nblocks] (each at its window's
// first slot lo); zmeta: host int64 [nblocks, 4] (first row, row, limb and
// slot strides); primes: host uint32 [L]; mu: host uint64 [L], floor(2^64 /
// p_l).  One launch for all the matrices.
extern "C" int ringsnark_spmv(const void* mats, int nmats, const void* zptrs, const void* zmeta,
                              int nblocks, const void* primes, const void* mu, int L,
                              long long rows, long long n, long long lo, int slot_major,
                              void* stream) {
  Limbs mod = {};
  Assignment z = {};
  Spmv s = {};
  const long long* md = static_cast<const long long*>(mats);
  const long long* meta = static_cast<const long long*>(zmeta);
  const uint64_t* zp = static_cast<const uint64_t*>(zptrs);
  constexpr long long k32 = 1LL << 32;
  if (!make_limbs(static_cast<const uint32_t*>(primes), static_cast<const uint64_t*>(mu), L,
                  mod) ||
      mu == nullptr || md == nullptr || nmats < 1 || nmats > kMaxMats || nblocks < 1 ||
      nblocks > kMaxBlocks || n < 1 || n >= (1LL << 31) || rows < 1 || rows >= (1LL << 31) ||
      lo < 0 || L * n >= k32 || rows * L >= k32) {
    return static_cast<int>(refused(cudaErrorInvalidValue));
  }
  bool vec = n % 4 == 0;  // 16-byte words: every wide window, stride and output aligned
  z.count = nblocks;
  for (int b = 0; b < nblocks; ++b) {
    const long long* m = meta + 4 * b;  // first row, row, limb and slot strides
    if (zp[b] == 0 || m[0] < 0 || m[0] >= k32 || (b == 0 && m[0]) ||
        (b > 0 && m[0] < m[-4]) || m[1] < 0 || m[1] >= k32 || m[2] < 0 || m[2] >= k32 ||
        m[3] < 0 || m[3] >= k32 || (L - 1) * m[2] + (n - 1) * m[3] >= k32) {
      return static_cast<int>(refused(cudaErrorInvalidValue));
    }
    if (m[3] != 0) {
      vec = vec && m[3] == 1 && m[1] % 4 == 0 && m[2] % 4 == 0 && zp[b] % 16 == 0;
    }
    z.b[b] = Block{reinterpret_cast<const uint32_t*>(zp[b]), static_cast<uint32_t>(m[1]),
                   static_cast<uint32_t>(m[2]), static_cast<uint32_t>(m[3]),
                   static_cast<uint32_t>(m[0])};
  }
  for (int k = 0; k < nmats; ++k) {
    const long long* d = md + 13 * k;
    const long long csr_rows = d[6], nlong = d[7], unit = d[8], long_len = d[9];
    const long long ck = d[10], cl = d[11], ci = d[12];
    if (d[5] == 0 || csr_rows < 0 || csr_rows > rows || nlong < 0 || nlong > csr_rows ||
        long_len < 1 || long_len >= (1LL << 31) ||
        (csr_rows > 0 && (d[1] == 0 || d[3] == 0 || (!unit && (d[0] == 0 || d[2] == 0)))) ||
        (nlong > 0 && (unit || d[4] == 0)) || ck < 0 || ck >= k32 || cl < 0 || cl >= k32 ||
        ci < 0 || ci > 1 || (L - 1) * cl + (lo + n - 1) * ci >= k32) {
      return static_cast<int>(refused(cudaErrorInvalidValue));
    }
    if (ci) vec = vec && ck % 4 == 0 && cl % 4 == 0 && (d[3] + 4 * lo) % 16 == 0;
    vec = vec && d[5] % 16 == 0;
  }
  // the tile: G threads a row (at most a warp), VEC slots a thread; the
  // warp tiles (slot-major at n > 1) take four slots a lane's chunk whatever
  // VEC, and at least 32 slots
  const bool warp = slot_major && n > 1;
  const long long kv = vec ? 4 : 1, tv = warp ? 4 : kv;
  uint32_t log_g = warp ? 3 : 0;
  while ((tv << log_g) < n && log_g < kLogMaxGroup) ++log_g;
  const uint32_t log_ts = log_g + (tv == 4 ? 2 : 0);
  const uint32_t log_tr =
      kLogThreads - log_g + (tv == 4 ? kLogRowsPerThread<4> : kLogRowsPerThread<1>);
  const long long lt = n == 1 && L <= kMaxTileLimbs ? L : 1;
  const long long slot_tiles = (n + (1LL << log_ts) - 1) >> log_ts;
  const long long tiles = ((rows + (1LL << log_tr) - 1) >> log_tr) * (L / lt) * slot_tiles;
  // a long row's slot tiles: at most 8 threads a row, so 32 or more share its nonzeros
  const uint32_t log_gl = log_g < kLogLongGroup ? log_g : kLogLongGroup;
  const long long long_slot_tiles = (n + (kv << log_gl) - 1) / (kv << log_gl);
  long long long_items = 0;
  s.mats = static_cast<uint32_t>(nmats);
  for (int k = 0; k < nmats; ++k) {
    const long long* d = md + 13 * k;
    Mat& M = s.m[k];
    M.ptr = reinterpret_cast<const int*>(d[0]);
    M.idx = reinterpret_cast<const long long*>(d[1]);
    M.head = reinterpret_cast<const int*>(d[2]);
    M.coef = reinterpret_cast<const uint32_t*>(d[3]) + lo * d[12];
    M.longs = reinterpret_cast<const int*>(d[4]);
    M.out = reinterpret_cast<uint32_t*>(d[5]);
    M.csr_rows = static_cast<uint32_t>(d[6]);
    M.nlong = static_cast<uint32_t>(d[7]);
    M.unit = d[8] ? 1 : 0;
    M.long_len = static_cast<uint32_t>(d[9]);
    M.coef_k = static_cast<uint32_t>(d[10]);
    M.coef_l = static_cast<uint32_t>(d[11]);
    M.coef_i = static_cast<uint32_t>(d[12]);
    M.long_items = static_cast<uint32_t>(d[7] * L * long_slot_tiles);
    long_items += d[7] * L * long_slot_tiles;
  }
  const long long items = long_items + nmats * tiles;
  if (items >= (1LL << 31)) return static_cast<int>(refused(cudaErrorInvalidValue));
  s.L = static_cast<uint32_t>(L);
  s.n = static_cast<uint32_t>(n);
  s.rows = static_cast<uint32_t>(rows);
  s.log_g = log_g;
  s.lt = static_cast<uint32_t>(lt);
  s.limb_tiles = static_cast<uint32_t>(L / lt);
  s.slot_tiles = static_cast<uint32_t>(slot_tiles);
  s.tiles = static_cast<uint32_t>(tiles);
  s.log_gl = log_gl;
  s.long_slot_tiles = static_cast<uint32_t>(long_slot_tiles);
  s.long_items = static_cast<uint32_t>(long_items);
  s.items = static_cast<uint32_t>(items);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (warp) {
    err = vec ? launch_spmv<true, 4, true>(s, z, mod, st)
              : launch_spmv<true, 1, true>(s, z, mod, st);
  } else if (slot_major) {  // n = 1
    err = launch_spmv<true, 1>(s, z, mod, st);
  } else {
    err = vec ? launch_spmv<false, 4>(s, z, mod, st) : launch_spmv<false, 1>(s, z, mod, st);
  }
  return static_cast<int>(err);
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
