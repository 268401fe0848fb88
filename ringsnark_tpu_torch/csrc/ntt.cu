// Batched cyclic / negacyclic NTT over 31-bit RNS limbs, for Hopper (sm_90a).
//
// Replaces: ringsnark_tpu/ops/pallas_ntt.py,
//   * `_ntt_kernel_gridfree` (all four modes: forward/inverse x
//     cyclic/negacyclic, reached through negacyclic_ntt_rev_pallas,
//     negacyclic_intt_nat_pallas, cyclic_ntt_rev_pallas and
//     cyclic_intt_nat_pallas), in both of its layouts (`_apply_lbm`,
//     `_apply_blm`): here one kernel, `ntt_kernel`, whose CTA order is a
//     launch argument;
//   * the split large-M path `ntt_split_pallas` / `_outer_pass` /
//     `_outer_kernel`: `outer_kernel` plus `ntt_kernel` on the
//     [B, L, R, Mi] view of M = R * Mi.
//
// Contract (identical to the TPU kernels and to the plain twins in
// ops/ntt.py, bit for bit; an NTT output reduced into [0, p) is unique, so
// every exact schedule gives the same words):
//   forward: natural order in, bit-reversed order out (DIF butterflies
//            a' = a + b, b' = (a - b) * w); negacyclic first twists by psi^i;
//   inverse: bit-reversed order in, natural order out (DIT butterflies
//            m = b * w, a' = a + m, b' = a - m); then psi^-i * M^-1
//            (negacyclic) or M^-1 (cyclic).
//   Inputs are residues in [0, p); outputs are fully reduced into [0, p).
//
// What bounds it on this card: the bound is device memory, 8 bytes per
// element (one read, one write).  But a butterfly is one Shoup multiply
// (__umulhi and two low products) and about six adds, selects and minima,
// 14 butterfly stages at M = 16384: the integer pipes need about as long
// as the memory, and what keeps a transform on the SM (shared-memory
// exchanges, barriers, twiddle and psi loads) comes on top.  On the H100
// the kernels reach 25-35 % of the memory bound (PERF.md).
//
// What the design does about it:
// * ntt_kernel, register radix: a thread holds E = 16 residues of one
//   transform (E = M below 16) at stride D and runs up to log2(E) = 4
//   stages on them in registers; a transform of log2(M) stages is a few
//   such passes (14 = 2 + 4 + 4 + 4, the short pass at the top), with one
//   shared-memory exchange and one __syncthreads between passes instead of
//   one per stage.  Each distinct twiddle of a pass is one 8-byte load of
//   a (w, w_sh) pair, coalesced across the warp, from a per-limb table
//   that every row shares (15 loads per 16 residues a pass, not 2 per
//   butterfly).  The shared layout is XOR-swizzled within 32-word rows
//   (swz) so that every exchange is free of bank conflicts, and swz is
//   linear, so a residue's address is one XOR.  The psi twist, M^-1 and
//   the choice of output are template arguments: no branch sits between a
//   group's loads.  Conditional subtractions are unsigned minima.
// * ntt_kernel, persistent: about (SMs x CTAs per SM) CTAs walk the tiles
//   of the [rows, L, S] batch (row or limb-major order), a tile being TP
//   transforms (TP > 1 below M = 4096, so a CTA runs 256 threads).  Up to
//   M = 16384 two CTAs of 256 threads share a SM and interleave their
//   loads, passes and stores (faster on the card than one CTA of 512 with
//   a second buffer); a tile of at most 32 KiB has a second buffer, filled
//   with cp.async while the current one computes.  M = 32768 runs one CTA
//   of 512 threads (128 KiB).  A thread keeps up to 128 registers, none
//   spilled.  The first pass reads shared memory; the last pass writes
//   device memory from registers, through the warp's own shared words
//   where a thread's 16 residues are contiguous, so that every store is
//   128 contiguous bytes.
// * outer_kernel: one thread per column runs the log2(R) outer stages
//   global to global, then ntt_kernel runs the R inner transforms (forward;
//   the inverse runs them first): two passes over device memory.  Past
//   R = 32 (M > 2^20 at Mi = 32768) a thread would hold more than 32
//   residues and spill, so the outer stages run in passes of at most five
//   (a stage offset i0 into the same factored tables), one more pass over
//   device memory each; there is no upper limit on R.  A
//   thread-block cluster holding the transform in distributed shared memory
//   (one pass) was tried: at R <= 8 it saved 4-8 %, at R = 16 it ran slower
//   than the two passes, which keep two inner CTAs a SM (PERF.md).
// * outer twiddles are factored: the b-row twiddle of outer stage i,
//   w^(2^i (lo Mi + c)), is w^(2^i c) (column table [L, s, Mi]) times
//   (w^Mi)^(2^i lo) (row table [L, s, R/2]), applied as two Shoup
//   multiplies (the second skipped where lo = 0): R times less table than
//   the positioned [L, s, R, Mi] table of the TPU kernel.
// Not done yet (later work): psi merged into the stage twiddles, warp
// shuffles for the passes whose partners lie in one warp, E = 32 (three
// passes at M = 16384), cp.async.bulk (TMA) copies, and one HBM pass for
// the split transform.
//
// Tables (built once per (primes, M) on the host by ops/cuda_ntt.py from
// ops/ntt.get_plan's roots), uint32 pairs (value, Shoup constant
// floor(value * 2^32 / p)):
//   tw [L, M, 2]   entry d + k (1 <= d < M, k < d) is w_{2d}^k (forward: w;
//                  inverse: w^-1); entry 0 is unused.
//   sc [L, M, 2]   psi^i (forward) or psi^-i * M^-1 (inverse); unused for
//                  cyclic transforms.
//   consts [L, 3]  p, M^-1 mod p, Shoup constant of M^-1.
//   split (s = log2 R):  col [L, s, Mi, 2] = w^(2^i c), row [L, s, R/2, 2] =
//           w^(2^i Mi lo) (inverse: w^-1), sc [L, R, Mi, 2] twists,
//           consts with the full-size M^-1.
//
// C interface: ringsnark_ntt_launch and ringsnark_ntt_outer_launch return
// cudaGetLastError() after the launch
// (0 on success) or the error of a refused configuration; the Python
// wrapper raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, add_mod, sub_mod, shoup_mul, refused

namespace {

// A thread needs up to 128 registers (E = 16 residues, their twiddles and
// addresses; 64 spill): so 512 threads a SM, as one CTA of 512 (M = 32768)
// or two of 256 (up to M = 16384, where two CTAs interleave their loads,
// passes and stores: measured faster than one CTA of 512 with a second
// buffer).
constexpr int kMaxThreads = 512;

// Shared-memory address of logical word a: the low 5 bits are XORed with
// bits of the 32-word row index, so that the exchanges at D = 1, 16 and
// >= 32 hit 32 distinct banks per warp access.  swz is linear over GF(2)
// (swz(a ^ b) = swz(a) ^ swz(b)), and a group's words are A ^ (j << log_d)
// with those bits of A clear, so a residue's address is swz(A) ^ sj[j].
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  const uint32_t row = a >> 5;
  return a ^ ((row & 15u) | ((row & 8u) << 1));
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The passes of a size-2^log_m transform in register groups of 2^log_e:
// a top pass of r0 = 1 .. log_e stages at stride D = 2^(log_m - log_e),
// then full passes at D = 2^(log_e k), k descending (forward order; the
// inverse runs them in reverse).  Pass q's stages are the j-exponents
// [e_lo, log_e) of the group (j-distance 2^e is index distance 2^e * D).
__device__ __forceinline__ int num_passes(int log_m, int log_e) {
  const int r0 = (log_m - 1) % log_e + 1;
  return 1 + (log_m - r0) / log_e;
}

__device__ __forceinline__ void pass_info(int q, int npass, bool inverse, int log_m,
                                          int log_e, int& log_d, int& e_lo) {
  const int top = inverse ? npass - 1 : 0;
  if (q == top) {
    log_d = log_m - log_e;
    e_lo = log_e - ((log_m - 1) % log_e + 1);
  } else {
    log_d = log_e * (inverse ? q : npass - 1 - q);
    e_lo = 0;
  }
}

// The stages of one pass on the E residues v[j] = x[base + j * D] of a
// group (lo = base mod D): forward DIF from the top j-exponent down,
// inverse DIT from e_lo up.  The twiddle of a pair at j-distance jd is
// tw[d + lo + (j mod jd) * D] with d = jd * D.
template <bool kInverse, int kLogE>
__device__ __forceinline__ void group_stages(uint32_t (&v)[1 << kLogE],
                                             const uint2* __restrict__ tw, int log_d,
                                             int e_lo, uint32_t lo, uint32_t p) {
  constexpr int E = 1 << kLogE;
#pragma unroll
  for (int s = 0; s < kLogE; ++s) {
    const int e = kInverse ? s : kLogE - 1 - s;
    if (e < e_lo) continue;
    const int jd = 1 << e;
    const uint32_t d = static_cast<uint32_t>(jd) << log_d;
#pragma unroll
    for (int m = 0; m < jd; ++m) {
      const uint2 w = __ldg(tw + d + lo + (static_cast<uint32_t>(m) << log_d));
#pragma unroll
      for (int q = 0; q < E; q += 2 * jd) {
        const int j = q + m;
        const uint32_t a = v[j];
        if (kInverse) {
          const uint32_t mm = shoup_mul(v[j + jd], w, p);
          v[j] = add_mod(a, mm, p);
          v[j + jd] = sub_mod(a, mm, p);
        } else {
          const uint32_t b = v[j + jd];
          v[j] = add_mod(a, b, p);
          v[j + jd] = shoup_mul(a + p - b, w, p);  // a - b + p < 2p < 2^32
        }
      }
    }
  }
}

// sj[j] = swz(j << log_d): a pass's shared-word offsets of a group.
template <int kLogE>
__device__ __forceinline__ void pass_offsets(uint32_t (&sj)[1 << kLogE], int log_d) {
#pragma unroll
  for (int j = 0; j < (1 << kLogE); ++j) sj[j] = swz(static_cast<uint32_t>(j) << log_d);
}

// What a pass does with its groups, besides the stages.
struct PassArgs {
  uint32_t* buf;          // the tile's shared words
  uint32_t toff;          // tile-logical offset of the transform
  int log_g, log_d, e_lo;
  const uint2* tw;        // the limb's stage twiddles
  const uint2* sc;        // the limb's psi twist (forward) or scale (inverse) table
  uint32_t p;
  uint2 minv;             // M^-1 and its Shoup constant
  uint32_t* y;            // the transform in device memory (last pass)
};

// Where a group goes after its stages: back to shared memory, or to device
// memory as it is, times the per-element table sc, or times M^-1.
enum : int { kToShared = 0, kToGlobal = 1, kScaleTable = 2, kScaleMinv = 3 };

// One pass of group g: read it from shared memory (twisted by sc first when
// kTwist), run the stages, write it out as kOut says.  The choices are
// template arguments, so no branch sits between a group's loads.
template <bool kInverse, int kLogE, bool kTwist, int kOut>
__device__ __forceinline__ void group_pass(const PassArgs& pa, const uint32_t (&sj)[1 << kLogE],
                                           uint32_t g) {
  constexpr int E = 1 << kLogE;
  const int log_d = pa.log_d;
  const uint32_t lo = g & ((1u << log_d) - 1u);
  const uint32_t base = ((g >> log_d) << (log_d + kLogE)) | lo;
  const uint32_t a = swz(pa.toff + base);
  uint32_t v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = pa.buf[a ^ sj[j]];
  if (kTwist) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[j] = shoup_mul(v[j], __ldg(pa.sc + base + (static_cast<uint32_t>(j) << log_d)), pa.p);
    }
  }
  group_stages<kInverse, kLogE>(v, pa.tw, log_d, pa.e_lo, lo, pa.p);
  if (kOut == kToShared) {
#pragma unroll
    for (int j = 0; j < E; ++j) pa.buf[a ^ sj[j]] = v[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (kOut == kScaleTable) {
      v[j] = shoup_mul(v[j], __ldg(pa.sc + base + (static_cast<uint32_t>(j) << log_d)), pa.p);
    } else if (kOut == kScaleMinv) {
      v[j] = shoup_mul(v[j], pa.minv, pa.p);
    }
  }
  if (kLogE == 4 && log_d == 0 && pa.log_g >= 5) {
    // the warp's 32 groups are 512 contiguous residues of one transform:
    // through its own shared words, so that each store is 128 contiguous bytes
#pragma unroll
    for (int j = 0; j < E; ++j) pa.buf[a ^ sj[j]] = v[j];
    __syncwarp();
    const uint32_t lane = threadIdx.x & 31u;
    const uint32_t wbase = base - (lane << kLogE);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const uint32_t i = wbase + (static_cast<uint32_t>(k) << 5) + lane;
      pa.y[i] = pa.buf[swz(pa.toff + i)];
    }
  } else if (kLogE == 4 && log_d == 0) {  // 16 contiguous residues, 64-byte aligned
    uint4* dst = reinterpret_cast<uint4*>(pa.y + base);
#pragma unroll
    for (int j = 0; j < E; j += 4) dst[j / 4] = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) pa.y[base + (static_cast<uint32_t>(j) << log_d)] = v[j];
  }
}

// group_pass of a transform's pass q: the first pass of a forward
// negacyclic transform twists; the last pass writes to device memory
// (scaled when inverse: psi^-i M^-1, or M^-1 unless `scale` is off).
template <bool kInverse, bool kNegacyclic, int kLogE>
__device__ __forceinline__ void run_group(const PassArgs& pa, const uint32_t (&sj)[1 << kLogE],
                                          uint32_t g, bool first, bool last, bool scale) {
  constexpr bool kTw = !kInverse && kNegacyclic;
  if (!last) {
    if (kTw && first) {
      group_pass<kInverse, kLogE, kTw, kToShared>(pa, sj, g);
    } else {
      group_pass<kInverse, kLogE, false, kToShared>(pa, sj, g);
    }
  } else if (kTw && first) {  // a one-pass transform (M <= 16)
    group_pass<kInverse, kLogE, kTw, kToGlobal>(pa, sj, g);
  } else if (kInverse && kNegacyclic) {
    group_pass<kInverse, kLogE, false, kScaleTable>(pa, sj, g);
  } else if (kInverse && scale) {
    group_pass<kInverse, kLogE, false, kScaleMinv>(pa, sj, g);
  } else {
    group_pass<kInverse, kLogE, false, kToGlobal>(pa, sj, g);
  }
}

// transform s of the [rows, L, S] batch in CTA order: row order is memory
// order; limb-major order walks limb 0's rows * S transforms first
__device__ __forceinline__ void locate(uint32_t s, uint32_t rows, uint32_t L, uint32_t S,
                                       bool limb_major, uint32_t& t, uint32_t& limb) {
  if (limb_major) {
    const uint32_t per_limb = rows * S;
    limb = s / per_limb;
    const uint32_t j = s - limb * per_limb;
    t = ((j / S) * L + limb) * S + j % S;
  } else {
    limb = (s / S) % L;
    t = s;
  }
}

// Copy tile `tile` (tile_tf transforms) into buf with cp.async, swizzled.
__device__ __forceinline__ void load_tile(uint32_t* buf, const uint32_t* __restrict__ x,
                                          uint32_t tile, uint32_t tile_tf, uint32_t nt,
                                          int log_m, uint32_t rows, uint32_t L, uint32_t S,
                                          bool limb_major) {
  const uint32_t M = 1u << log_m;
  if (M >= blockDim.x) {  // a transform at a time, located once
    for (uint32_t tr = 0; tr < tile_tf; ++tr) {
      const uint32_t s = tile * tile_tf + tr;
      if (s >= nt) break;
      uint32_t t, limb;
      locate(s, rows, L, S, limb_major, t, limb);
      const uint32_t* src = x + (static_cast<size_t>(t) << log_m);
      for (uint32_t i = threadIdx.x; i < M; i += blockDim.x) {
        cp_async4(buf + swz((tr << log_m) + i), src + i);
      }
    }
    return;
  }
  for (uint32_t idx = threadIdx.x; idx < (tile_tf << log_m); idx += blockDim.x) {
    const uint32_t s = tile * tile_tf + (idx >> log_m);
    if (s >= nt) break;
    uint32_t t, limb;
    locate(s, rows, L, S, limb_major, t, limb);
    cp_async4(buf + swz(idx), x + (static_cast<size_t>(t) << log_m) + (idx & (M - 1u)));
  }
}

// The shared-memory NTT: persistent CTAs of `blockDim.x` threads walk tiles
// of tile_tf transforms; thread tid works on transform tid >> log_g of the
// tile (log_g = log2 of the groups per transform) and on the groups
// gi = tid, tid + blockDim.x, ... of the tile.
template <bool kInverse, bool kNegacyclic, int kLogE, int kThreads>
__global__ void __launch_bounds__(kThreads, kMaxThreads / kThreads)
    ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               const uint2* __restrict__ tw, const uint2* __restrict__ sc,
               const uint32_t* __restrict__ consts, uint32_t rows, uint32_t L, uint32_t S,
               int log_m, int limb_major, int scale, uint32_t tile_tf, int nbuf) {
  extern __shared__ uint32_t smem[];
  const uint32_t nt = rows * L * S;
  const uint32_t tiles = (nt + tile_tf - 1) / tile_tf;
  const uint32_t tile_words = tile_tf << log_m;
  const int log_g = log_m - kLogE;
  const uint32_t groups = tile_tf << log_g;
  const int npass = num_passes(log_m, kLogE);
  const uint32_t tr = threadIdx.x >> log_g;  // the same in every pass
  const bool lm = limb_major != 0;

  uint32_t tile = blockIdx.x;
  if (tile < tiles) load_tile(smem, x, tile, tile_tf, nt, log_m, rows, L, S, lm);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    uint32_t* buf = smem + (nbuf == 2 ? (it & 1) * tile_words : 0);
    const uint32_t next = tile + gridDim.x;
    if (nbuf == 2) {
      if (next < tiles) {
        load_tile(smem + ((it + 1) & 1) * tile_words, x, next, tile_tf, nt, log_m, rows, L,
                  S, lm);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const uint32_t s = tile * tile_tf + tr;
    const bool valid = s < nt;
    uint32_t t = 0, limb = 0;
    if (valid) locate(s, rows, L, S, lm, t, limb);
    const size_t tbase = static_cast<size_t>(limb) << log_m;
    PassArgs pa;
    pa.buf = buf;
    pa.toff = tr << log_m;
    pa.log_g = log_g;
    pa.tw = tw + tbase;
    pa.sc = sc + tbase;
    pa.p = consts[3 * limb];
    pa.minv = make_uint2(consts[3 * limb + 1], consts[3 * limb + 2]);
    pa.y = y + (static_cast<size_t>(t) << log_m);
    for (int q = 0; q < npass; ++q) {
      pass_info(q, npass, kInverse, log_m, kLogE, pa.log_d, pa.e_lo);
      uint32_t sj[1 << kLogE];
      pass_offsets<kLogE>(sj, pa.log_d);
      if (valid) {
        for (uint32_t gi = threadIdx.x; gi < groups; gi += blockDim.x) {
          run_group<kInverse, kNegacyclic, kLogE>(pa, sj, gi & ((1u << log_g) - 1u), q == 0,
                                                  q == npass - 1, scale != 0);
        }
      }
      if (q != npass - 1) __syncthreads();
    }
    __syncthreads();  // the buffer is refilled next iteration
    if (nbuf == 1 && next < tiles) {
      load_tile(smem, x, next, tile_tf, nt, log_m, rows, L, S, lm);
      cp_async_commit();
    }
  }
}

template <bool kInverse, bool kNegacyclic, int kLogE, int kThreads>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint2* tw, const uint2* sc,
                   const uint32_t* consts, int rows, int L, int S, int log_m, int limb_major,
                   int scale, int threads, int tile_tf, int nbuf, cudaStream_t stream) {
  auto kernel = ntt_kernel<kInverse, kNegacyclic, kLogE, kThreads>;
  const size_t smem = static_cast<size_t>(nbuf) * tile_tf * (sizeof(uint32_t) << log_m);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  int per_sm = 0, sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return refused(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return refused(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return refused(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long nt = static_cast<long long>(rows) * L * S;
  const long long tiles = (nt + tile_tf - 1) / tile_tf;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const unsigned int blocks = static_cast<unsigned int>(tiles < slots ? tiles : slots);
  kernel<<<blocks, threads, smem, stream>>>(x, y, tw, sc, consts, rows, L, S, log_m,
                                             limb_major, scale, tile_tf, nbuf);
  return cudaGetLastError();
}

template <bool kInverse, bool kNegacyclic>
cudaError_t launch_e(const uint32_t* x, uint32_t* y, const uint2* tw, const uint2* sc,
                     const uint32_t* consts, int rows, int L, int S, int log_m, int limb_major,
                     int scale, int threads, int tile_tf, int nbuf, cudaStream_t stream) {
#define RINGSNARK_LAUNCH(E, T)                                                              \
  launch<kInverse, kNegacyclic, E, T>(x, y, tw, sc, consts, rows, L, S, log_m, limb_major, \
                                      scale, threads, tile_tf, nbuf, stream)
  if (threads > kMaxThreads / 2) {
    if (log_m < 4) return cudaErrorInvalidValue;
    return RINGSNARK_LAUNCH(4, kMaxThreads);
  }
  switch (log_m < 4 ? log_m : 4) {
    case 1: return RINGSNARK_LAUNCH(1, kMaxThreads / 2);
    case 2: return RINGSNARK_LAUNCH(2, kMaxThreads / 2);
    case 3: return RINGSNARK_LAUNCH(3, kMaxThreads / 2);
    default: return RINGSNARK_LAUNCH(4, kMaxThreads / 2);
  }
#undef RINGSNARK_LAUNCH
}

// ---------------------------------------------------------------------------
// the split transform's outer stages (factored twiddles)
// ---------------------------------------------------------------------------

// One pass of outer stages i0 .. i0 + K - 1 (K = 2^kLogK) on the K residues
// v[m] of a thread: rows r(m) = (hi << (log_r - i0)) | (m << log_lo) | lo
// of column c, log_lo = log_r - i0 - K.  Stage i pairs rows at distance
// d = R >> (i + 1), which is m-distance dl = K >> (i - i0 + 1); the b-row
// twiddle of stage i is w^(2^i (lo_i Mi + c)) with lo_i = r mod d =
// ((m mod dl) << log_lo) | lo, as col[i, c] times row[i, lo_i].
// col: [log_r, Mi] pairs of the limb; row: [log_r, R/2] pairs of the limb.
template <int kLogK, bool kInverse>
__device__ __forceinline__ void outer_stages(uint32_t (&v)[1 << kLogK],
                                             const uint2* __restrict__ col,
                                             const uint2* __restrict__ row, uint32_t c,
                                             int log_mi, int log_r, int i0, uint32_t lo,
                                             int log_lo, uint32_t p) {
  constexpr int K = 1 << kLogK;
#pragma unroll
  for (int k = 0; k < kLogK; ++k) {
    const int e = kInverse ? kLogK - 1 - k : k;  // DIT runs the stages in reverse
    const int i = i0 + e;
    const int dl = K >> (e + 1);
    const uint2 wc = __ldg(col + (static_cast<size_t>(i) << log_mi) + c);
    const uint2* rw = row + (static_cast<size_t>(i) << (log_r - 1));
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if ((m & (2 * dl - 1)) < dl) {
        const uint32_t lo_i = (static_cast<uint32_t>(m & (dl - 1)) << log_lo) | lo;
        const uint32_t a = v[m];
        if (kInverse) {
          uint32_t mm = shoup_mul(v[m + dl], wc, p);
          if (lo_i) mm = shoup_mul(mm, __ldg(rw + lo_i), p);
          v[m] = add_mod(a, mm, p);
          v[m + dl] = sub_mod(a, mm, p);
        } else {
          const uint32_t b = v[m + dl];
          v[m] = add_mod(a, b, p);
          uint32_t t = shoup_mul(sub_mod(a, b, p), wc, p);
          if (lo_i) t = shoup_mul(t, __ldg(rw + lo_i), p);
          v[m + dl] = t;
        }
      }
    }
  }
}

// One pass of the split's outer stages, i0 .. i0 + K - 1 of log_r: one
// thread per (row, limb, hi, lo, column c) of the [B, L, R, Mi] view, global
// to global.  The first forward pass (i0 = 0) twists by psi; the last
// inverse pass (i0 = 0, the stages run in reverse) scales by psi^-k M^-1 or
// M^-1 (the cyclic inverse leaves M^-1 out when `scale` is 0).  With K = R it
// is the whole outer transform in one pass.
template <int kLogK, bool kInverse, bool kNegacyclic>
__global__ void outer_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                             const uint2* __restrict__ col, const uint2* __restrict__ row,
                             const uint2* __restrict__ sc,
                             const uint32_t* __restrict__ consts, size_t columns, int L,
                             int log_mi, int log_r, int i0, int scale) {
  constexpr int K = 1 << kLogK;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= columns) return;
  const size_t Mi = static_cast<size_t>(1) << log_mi;
  const uint32_t c = static_cast<uint32_t>(t & (Mi - 1));
  const size_t u = t >> log_mi;
  const int log_j = log_r - kLogK;  // (hi, lo) pairs of a column: R / K
  const uint32_t j = static_cast<uint32_t>(u & ((static_cast<size_t>(1) << log_j) - 1));
  const size_t bl = u >> log_j;  // row * L + limb
  const int limb = static_cast<int>(bl % L);
  const int log_lo = log_j - i0;
  const uint32_t lo = j & ((1u << log_lo) - 1u);
  const uint32_t r0 = ((j >> log_lo) << (log_r - i0)) | lo;  // r(0); r(m) = r0 + (m << log_lo)
  const size_t base = ((bl << log_r) << log_mi) + c;
  const uint2* scl = sc + ((static_cast<size_t>(limb) << log_r) << log_mi) + c;
  const uint32_t p = consts[3 * limb];
  const bool edge = i0 == 0;  // the twist (forward) or the scale (inverse) belongs here

  uint32_t v[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const size_t r = r0 + (static_cast<uint32_t>(m) << log_lo);
    v[m] = x[base + (r << log_mi)];
    if (!kInverse && kNegacyclic && edge) v[m] = shoup_mul(v[m], __ldg(scl + (r << log_mi)), p);
  }
  outer_stages<kLogK, kInverse>(v, col + ((static_cast<size_t>(limb) * log_r) << log_mi),
                                row + ((static_cast<size_t>(limb) * log_r) << (log_r - 1)), c,
                                log_mi, log_r, i0, lo, log_lo, p);
  if (kInverse && edge && (kNegacyclic || scale)) {
    const uint2 minv = make_uint2(consts[3 * limb + 1], consts[3 * limb + 2]);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const size_t r = r0 + (static_cast<uint32_t>(m) << log_lo);
      v[m] = kNegacyclic ? shoup_mul(v[m], __ldg(scl + (r << log_mi)), p)
                         : shoup_mul(v[m], minv, p);
    }
  }
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const size_t r = r0 + (static_cast<uint32_t>(m) << log_lo);
    y[base + (r << log_mi)] = v[m];
  }
}

template <int kLogK, bool kInverse, bool kNegacyclic>
cudaError_t launch_outer(const uint32_t* x, uint32_t* y, const uint2* col, const uint2* row,
                         const uint2* sc, const uint32_t* consts, int rows, int L, int log_mi,
                         int log_r, int i0, int scale, cudaStream_t stream) {
  const size_t columns = (static_cast<size_t>(rows) * static_cast<size_t>(L)
                          << (log_r - kLogK)) << log_mi;
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((columns + threads - 1) / threads);
  outer_kernel<kLogK, kInverse, kNegacyclic><<<blocks, threads, 0, stream>>>(
      x, y, col, row, sc, consts, columns, L, log_mi, log_r, i0, scale);
  return cudaGetLastError();
}

template <int kLogK>
cudaError_t launch_outer_mode(const uint32_t* x, uint32_t* y, const uint2* col,
                              const uint2* row, const uint2* sc, const uint32_t* consts,
                              int rows, int L, int log_mi, int log_r, int i0, int scale,
                              bool inv, bool nega, cudaStream_t st) {
#define RINGSNARK_OUTER(I, N)                                                                 \
  launch_outer<kLogK, I, N>(x, y, col, row, sc, consts, rows, L, log_mi, log_r, i0, scale, st)
  if (inv) return nega ? RINGSNARK_OUTER(true, true) : RINGSNARK_OUTER(true, false);
  return nega ? RINGSNARK_OUTER(false, true) : RINGSNARK_OUTER(false, false);
#undef RINGSNARK_OUTER
}

}  // namespace

extern "C" int ringsnark_ntt_launch(const void* x, void* y, const void* tw, const void* sc,
                                    const void* consts, int rows, int L, int S, int log_m,
                                    int inverse, int negacyclic, int limb_major, int scale,
                                    int threads, int tile_tf, int nbuf, void* stream) {
  const long long nt = static_cast<long long>(rows) * L * S;
  if (log_m < 1 || log_m > 15 || rows < 1 || L < 1 || S < 1 || nt > 0x7fffffffLL ||
      threads < 1 || threads > kMaxThreads || tile_tf < 1 || (nbuf != 1 && nbuf != 2) ||
      (static_cast<long long>(tile_tf) << log_m) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  const uint2* t = static_cast<const uint2*>(tw);
  const uint2* s = static_cast<const uint2*>(sc);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (inverse) {
    err = negacyclic ? launch_e<true, true>(xi, yo, t, s, c, rows, L, S, log_m, limb_major,
                                            scale, threads, tile_tf, nbuf, st)
                     : launch_e<true, false>(xi, yo, t, s, c, rows, L, S, log_m, limb_major,
                                             scale, threads, tile_tf, nbuf, st);
  } else {
    err = negacyclic ? launch_e<false, true>(xi, yo, t, s, c, rows, L, S, log_m, limb_major,
                                             scale, threads, tile_tf, nbuf, st)
                     : launch_e<false, false>(xi, yo, t, s, c, rows, L, S, log_m, limb_major,
                                              scale, threads, tile_tf, nbuf, st);
  }
  return static_cast<int>(err);
}

// One pass of the outer stages i0 .. i0 + 2^log_k - 1 of the log_r outer
// stages (log_k <= 5: at most 32 residues a thread, no spill); ops/cuda_ntt
// runs a split of R > 32 as several passes.
extern "C" int ringsnark_ntt_outer_launch(const void* x, void* y, const void* col,
                                          const void* row, const void* sc, const void* consts,
                                          int rows, int L, int log_r, int log_mi, int inverse,
                                          int negacyclic, int i0, int log_k, int scale,
                                          void* stream) {
  if (log_r < 1 || log_r > 16 || log_k < 1 || log_k > 5 || i0 < 0 || i0 + log_k > log_r ||
      log_mi < 1 || log_mi > 20 || rows < 1 || L < 1 ||
      (((static_cast<long long>(rows) * L) << (log_r - log_k)) << log_mi) / 256 >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  const uint2* co = static_cast<const uint2*>(col);
  const uint2* ro = static_cast<const uint2*>(row);
  const uint2* s = static_cast<const uint2*>(sc);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0, nega = negacyclic != 0;
  cudaError_t err;
#define RINGSNARK_OUTER_K(K) \
  launch_outer_mode<K>(xi, yo, co, ro, s, c, rows, L, log_mi, log_r, i0, scale, inv, nega, st)
  switch (log_k) {
    case 1: err = RINGSNARK_OUTER_K(1); break;
    case 2: err = RINGSNARK_OUTER_K(2); break;
    case 3: err = RINGSNARK_OUTER_K(3); break;
    case 4: err = RINGSNARK_OUTER_K(4); break;
    default: err = RINGSNARK_OUTER_K(5); break;
  }
#undef RINGSNARK_OUTER_K
  return static_cast<int>(err);
}
