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
//   forward: natural order in, bit-reversed order out; the negacyclic
//            transform evaluates at psi^(2 brv(j) + 1), psi^2 = w;
//   inverse: bit-reversed order in, natural order out, times M^-1 (the
//            cyclic inverse without it where `scale` is off).
//   Inputs are residues in [0, p); outputs are fully reduced into [0, p).
//
// What bounds it on this card: device memory, 8 bytes a residue (one read,
// one write), but barely: a butterfly is one Shoup multiply (__umulhi and
// two low products) and about eight adds and minima, 7 butterflies a
// residue at M = 16384, which the H100 issues in about 80 % of the bytes'
// time (chip_smoke.ntt_ops).  So what keeps a transform on the SM beside
// the butterflies (shared-memory exchanges, twiddle loads, addresses,
// barriers, waiting on device memory) decides how far it stays from the
// bound.  The previous design (E = 16 residues a thread, four passes at M =
// 16384, the tile copied word by word into shared memory with cp.async,
// psi applied as a table, a CTA barrier after every pass) reached 25-33 %
// of it, and no one of those parts alone held it there (PERF.md).
//
// What the design does about it:
// * psi merged into the twiddles: the forward runs Cooley-Tukey butterflies
//   (m = b w, a' = a + m, b' = a - m) over the tree of x^M - psi^M, whose
//   node k (stage m = 2^floor(log2 k), block k - m) has twiddle psi^brv(k)
//   (cyclic: w^brv'(k - m)); the inverse runs Gentleman-Sande butterflies
//   (a' = a + b, b' = (a - b) w^-1) with the inverse twiddles, the root's
//   two outputs times M^-1 (its b-twiddle entry already holds it).  No
//   twist or scale table, no multiply a residue for them.
// * register radix E = 32: a thread holds 32 residues of a group at
//   distance 2^d and runs up to five stages on them; M = 16384 takes three
//   passes (5 + 4 + 5 stages), 32768 three of five, 1024 two.  A stage's
//   twiddles are consecutive in the table (2^(4 - e) pairs at stage e of a
//   pass), read 16 bytes at a time.
// * the top pass (the highest stages) loads its group straight from device
//   memory: register j of the warp's 32 lanes is 32 consecutive words, no
//   staging copy, no locate a word.  The other passes keep a warp in its
//   own region of the tile (the warp on the top bits of the tile), so the
//   exchanges between them need __syncwarp only; one __syncthreads a tile
//   follows the top pass where M > 1024 (and one guards the tile's reuse),
//   none below.  The last pass (d = 0, a lane's 32 words in a row) writes
//   16-byte vectors to the warp's words and the warp copies its region to
//   device memory in order, 512 contiguous bytes an access (from M =
//   1024); the inverse mirrors it, loading through the warp's words and
//   storing the top pass straight to device memory.  Shared memory is
//   XOR-swizzled in 16-byte granules (swz), so that every access from M =
//   1024 up meets no bank conflict.  No word is exchanged by shuffle: a
//   warp's exchange through shared memory costs one store and one load a
//   residue, a register-lane swap by shuffle of four bits at least two
//   shuffles and six selects.
// * loads ahead: the forward loads the next tile's first top-pass group
//   into registers while the warp copies this tile out, and copies a
//   tile's further top-pass groups (M >= 16384) into their own words with
//   cp.async while its first group computes.  (The same for the inverse,
//   its next region by cp.async during the top pass, measured no faster
//   and spilled at M >= 16384: not kept.)
// * persistent CTAs of 256 threads (512 at M = 32768, one a SM) walk the
//   tiles of the [rows, L, S] batch (row or limb-major order), a tile
//   8192 words (M = 16384: one transform, two groups a thread), with
//   registers capped for two CTAs a SM (128 a thread: faster than three
//   CTAs at 80, which spilled once the loads ran ahead).  Everything that
//   depends on M is a template argument: one kernel per (direction, log2
//   M), no runtime pass loop.
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
// Not done yet (later work): the split transform in one pass over device
// memory (its outer kernel still twists by a psi table); the inverse's
// loads ahead of it; M = 32768 over a two-CTA cluster sharing the tile in
// distributed shared memory (tried: 8 % faster forward, no faster inverse;
// not kept); cp.async.bulk (TMA) copies; warp shuffles.  The butterflies'
// adds need no steering to the FMA pipe: as compiled the ALU and the FMA
// pipe issue about as much (scripts/sass_mix).
//
// Tables (built once per (primes, M) on the host by ops/cuda_ntt.py from
// ops/ntt.get_plan's roots), uint32 pairs (value, Shoup constant
// floor(value * 2^32 / p)):
//   tw [L, M, 2]   forward: entry k >= 1 the twiddle of tree node k, entry 0
//                  unused; inverse: their inverses, entry 1 (the root) times
//                  M^-1 and entry 0 the root's without it.
//   consts [L, 5]  p, M^-1 and its Shoup constant, 1 and its Shoup constant
//                  (the root's a-factor with and without M^-1).
//   split (s = log2 R):  col [L, s, Mi, 2] = w^(2^i c), row [L, s, R/2, 2] =
//           w^(2^i Mi lo) (inverse: w^-1), sc [L, R, Mi, 2] twists,
//           consts [L, 3] with the full-size M^-1.
//
// C interface: ringsnark_ntt_launch and ringsnark_ntt_outer_launch return
// cudaGetLastError() after the launch
// (0 on success) or the error of a refused configuration (a CTA shape
// other than the kernel's, for one); the Python wrapper raises on anything
// else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, add_mod, sub_mod, shoup_mul, refused

namespace {

constexpr int kMaxThreads = 512;  // a CTA at M = 32768; 256 below

// Shared-memory word of tile word a: bits 2..4 XOR bits 5..7.  A 16-byte
// vector (4 aligned words) stays whole and aligned, and every warp access
// of the passes at d >= 5, of the pass at d = 0 (16-byte vectors, a lane's
// 32 words in a row, lanes 128 bytes apart) and of the transposing copy
// hits every bank once (tests/test_torch_ntt.py).  swz is linear over
// GF(2): swz(a ^ b) = swz(a) ^ swz(b).
__host__ __device__ constexpr uint32_t swz(uint32_t a) { return a ^ (((a >> 5) & 7u) << 2); }

// The CTA shape for transforms of size 2^kLogM (ops/cuda_ntt.geometry): a
// thread holds E = 32 residues of a group (E = M below 32); 256 threads,
// registers capped for two CTAs a SM; a tile of 8192 words (several
// transforms up to M = 4096), one transform of two groups a thread at M =
// 16384, and 512 threads, one CTA a SM, at M = 32768.
template <int kLogM>
struct Geo {
  static constexpr int kLogE = kLogM < 5 ? kLogM : 5;
  static constexpr int E = 1 << kLogE;
  static constexpr int kLogT = kLogM == 15 ? 9 : 8;
  static constexpr int kThreads = 1 << kLogT;
  static constexpr int kLogI = kLogM >= 14 ? 1 : 0;  // groups a thread takes in turn a pass
  static constexpr int kIters = 1 << kLogI;
  static constexpr int kLogTile = kLogT + kLogE + kLogI;
  static constexpr int kTileTf = 1 << (kLogTile - kLogM);
  static constexpr int kMinCtas = kThreads == kMaxThreads ? 1 : 2;
  // a warp's words in every pass but the top one, 2^kLogRegion in a row
  static constexpr int kLogRegion = 5 + kLogE + kLogI;
  // the top pass's exchange crosses warps (index bits above the region)
  static constexpr bool kCtaWide = kLogM > 10;
  // the device-memory side of the pass at d = 0 goes through the warp's
  // own words, so that every access is 512 contiguous bytes
  static constexpr bool kTranspose = kLogM >= 10;
  static constexpr int kTopD = kLogM - kLogE;  // the top pass's distance
  static constexpr size_t kSmem = kLogM > 5 ? sizeof(uint32_t) << kLogTile : 0;
};

// Group of this thread in its iteration `it` of a pass: the top pass puts
// the lanes on the low index bits (a load or store of register j is 32
// words in a row); every other pass puts the warp on the top bits of the
// tile, so that a warp keeps its region of the tile between them.
template <int kLogM, bool kTop>
__device__ __forceinline__ uint32_t group_of(uint32_t it) {
  using G = Geo<kLogM>;
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  return kTop ? lane | (warp << 5) | (it << G::kLogT) : lane | (it << 5) | (warp << (5 + G::kLogI));
}

// Tile word of register 0 of group g at distance 2^kD: the kLogE register
// bits kD.. inserted (clear) into g.
template <int kD, int kLogE>
__device__ __forceinline__ uint32_t tile_word(uint32_t g) {
  return ((g >> kD) << (kD + kLogE)) | (g & ((1u << kD) - 1u));
}

// Shared word of register j of a group whose register-0 word is a0 (a0s =
// swz(a0)): swz(a0) ^ swz(j << kD), the bits above 4 added as an offset.
template <int kD>
__device__ __forceinline__ uint32_t shared_word(uint32_t a0s, int j) {
  const uint32_t c = swz(static_cast<uint32_t>(j) << kD);
  return (a0s ^ (c & 0x1cu)) + (c & ~0x1cu);
}

// A group's residues from or to device memory (src = the transform + its
// register-0 index): 16-byte vectors where its words are contiguous,
// evict-first (each word is used once).
template <int kLogE, int kD>
__device__ __forceinline__ void load_global(uint32_t (&v)[1 << kLogE], const uint32_t* src) {
  if constexpr (kD == 0 && kLogE == 5) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(src) + q);
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kLogE); ++j) v[j] = __ldcs(src + (j << kD));
  }
}

template <int kLogE, int kD>
__device__ __forceinline__ void store_global(const uint32_t (&v)[1 << kLogE], uint32_t* dst) {
  if constexpr (kD == 0 && kLogE == 5) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      __stcs(reinterpret_cast<uint4*>(dst) + q,
             make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kLogE); ++j) __stcs(dst + (j << kD), v[j]);
  }
}

// A group's residues from or to shared memory: 16-byte vectors at d = 0
// (a lane's 32 words in a row), a word at a time above.
template <int kLogE, int kD>
__device__ __forceinline__ void load_shared(uint32_t (&v)[1 << kLogE], const uint32_t* buf,
                                            uint32_t a0s) {
  if constexpr (kD == 0 && kLogE == 5) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 w = *reinterpret_cast<const uint4*>(buf + (a0s ^ (4u * q)));
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kLogE); ++j) v[j] = buf[shared_word<kD>(a0s, j)];
  }
}

template <int kLogE, int kD>
__device__ __forceinline__ void store_shared(const uint32_t (&v)[1 << kLogE], uint32_t* buf,
                                             uint32_t a0s) {
  if constexpr (kD == 0 && kLogE == 5) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<uint4*>(buf + (a0s ^ (4u * q))) =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kLogE); ++j) buf[shared_word<kD>(a0s, j)] = v[j];
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// What a thread needs of its transform in a tile.
struct Transform {
  const uint32_t* x;  // the transform's residues in device memory
  uint32_t* y;
  const uint2* tw;    // its limb's stage twiddles
  uint32_t p;
  uint2 af;           // the inverse root's a-factor: M^-1 (scale) or 1, with Shoup constants
  int root;           // the inverse root's twiddle entry: 1 (times M^-1) or 0
  bool valid;
};

// The stages kS .. kK - 1 of a pass on a group (register positions e: the
// forward from kK - 1 down, the inverse from 0 up).  The twiddle of a pair
// (j, j + 2^e) is entry (M | index of register 0) >> (d + e + 1) of the
// tree, i.e. tw[(hi << (kLogE - 1 - e)) + (j >> (e + 1))] with hi = (M |
// index of register 0) >> (d + kLogE): 2^(kLogE - 1 - e) consecutive pairs,
// read two at a time.  kRoot: the inverse's top pass, whose last stage is
// the tree's root: a' = (a + b) af, b' = (a - b) tw[root] (M^-1 in both
// where the transform scales).
template <bool kInverse, int kLogE, int kK, bool kRoot, int kS = 0>
__device__ __forceinline__ void stages(uint32_t (&v)[1 << kLogE], const Transform& tf,
                                       uint32_t hi) {
  if constexpr (kS < kK) {
    constexpr int e = kInverse ? kS : kK - 1 - kS;
    constexpr int jd = 1 << e;
    constexpr int cnt = 1 << (kLogE - 1 - e);  // the stage's distinct twiddles
    constexpr bool root = kRoot && e == kLogE - 1;
    const uint32_t p = tf.p;
    const uint2* src = tf.tw + (hi << (kLogE - 1 - e));
#pragma unroll
    for (int c = 0; c < cnt; c += 2) {
      uint2 w[2];
      if constexpr (root) {
        w[0] = __ldg(tf.tw + tf.root);
      } else if constexpr (cnt == 1) {
        w[0] = __ldg(src);
      } else {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + c));
        w[0] = make_uint2(q.x, q.y), w[1] = make_uint2(q.z, q.w);
      }
#pragma unroll
      for (int t = 0; t < 2 && c + t < cnt; ++t) {
#pragma unroll
        for (int m = 0; m < jd; ++m) {
          const int j = ((c + t) << (e + 1)) + m;
          const uint32_t a = v[j], b = v[j + jd];
          if constexpr (kInverse) {  // Gentleman-Sande
            v[j] = root ? shoup_mul(a + b, tf.af, p) : add_mod(a, b, p);
            v[j + jd] = shoup_mul(a + p - b, w[t], p);  // a - b + p < 2p < 2^32
          } else {  // Cooley-Tukey
            const uint32_t mb = shoup_mul(b, w[t], p);
            v[j] = add_mod(a, mb, p);
            v[j + jd] = sub_mod(a, mb, p);
          }
        }
      }
    }
    stages<kInverse, kLogE, kK, kRoot, kS + 1>(v, tf, hi);
  }
}

// The launch's arguments.
struct Batch {
  const uint32_t* x;
  uint32_t* y;
  const uint2* tw;
  const uint32_t* consts;
  uint32_t rows, L, S, nt, tiles;
  bool limb_major;
  int scale;
};

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

// This thread's transform in tile `tile` (not valid past the batch).
template <int kLogM>
__device__ __forceinline__ Transform transform_of(const Batch& b, uint32_t tile) {
  using G = Geo<kLogM>;
  const uint32_t s = tile * G::kTileTf + (threadIdx.x >> (kLogM - G::kLogE));
  Transform tf;
  tf.valid = tile < b.tiles && s < b.nt;
  uint32_t t = 0, limb = 0;
  if (tf.valid) locate(s, b.rows, b.L, b.S, b.limb_major, t, limb);
  tf.x = b.x + (static_cast<size_t>(t) << kLogM);
  tf.y = b.y + (static_cast<size_t>(t) << kLogM);
  tf.tw = b.tw + (static_cast<size_t>(limb) << kLogM);
  tf.p = b.consts[5 * limb];
  tf.af = b.scale ? make_uint2(b.consts[5 * limb + 1], b.consts[5 * limb + 2])
                  : make_uint2(b.consts[5 * limb + 3], b.consts[5 * limb + 4]);
  tf.root = b.scale ? 1 : 0;
  return tf;
}

// Where a pass's group comes from or goes: device memory (its words as
// they lie), or the tile in shared memory.
enum : int { kDevice = 0, kShared = 1 };

// One pass (distance 2^kD, stages on register bits 0 .. kK - 1) over the
// thread's groups.
template <bool kInverse, int kLogM, int kD, int kK, int kSrc, int kDst>
__device__ __forceinline__ void pass(uint32_t* buf, const Transform& tf) {
  using G = Geo<kLogM>;
  constexpr bool kTop = kD == G::kTopD;
#pragma unroll
  for (int it = 0; it < G::kIters; ++it) {
    const uint32_t a0 = tile_word<kD, G::kLogE>(group_of<kLogM, kTop>(it));
    const uint32_t idx0 = a0 & ((1u << kLogM) - 1u);  // index of register 0 in its transform
    uint32_t v[G::E];
    if constexpr (kSrc == kDevice) {
      if (tf.valid) {
        load_global<G::kLogE, kD>(v, tf.x + idx0);
      } else {
#pragma unroll
        for (int j = 0; j < G::E; ++j) v[j] = 0;
      }
    } else {
      load_shared<G::kLogE, kD>(v, buf, swz(a0));
    }
    const uint32_t hi = ((1u << kLogM) | idx0) >> (kD + G::kLogE);
    stages<kInverse, G::kLogE, kK, kInverse && kTop>(v, tf, hi);
    if constexpr (kDst == kDevice) {
      if (tf.valid) store_global<G::kLogE, kD>(v, tf.y + idx0);
    } else {
      store_shared<G::kLogE, kD>(v, buf, swz(a0));
    }
  }
}

// A warp's region of the tile between shared and device memory in order:
// lane l moves the 16-byte chunks l, l + 32, ... (512 contiguous bytes a
// warp access).  The region lies in the thread's own transform.
template <int kLogM, bool kToDevice>
__device__ __forceinline__ void transpose(uint32_t* buf, const Transform& tf) {
  using G = Geo<kLogM>;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t r0 = (threadIdx.x >> 5) << G::kLogRegion;  // the warp's region
#pragma unroll
  for (int k = 0; k < (1 << (G::kLogRegion - 7)); ++k) {
    const uint32_t a = r0 + 4u * (lane + 32u * k);
    uint4* s = reinterpret_cast<uint4*>(buf + swz(a));
    const uint32_t i = a & ((1u << kLogM) - 1u);
    if constexpr (kToDevice) {
      if (tf.valid) __stcs(reinterpret_cast<uint4*>(tf.y + i), *s);
    } else if (tf.valid) {
      *s = __ldcs(reinterpret_cast<const uint4*>(tf.x + i));
    }
  }
}

template <bool kWide>
__device__ __forceinline__ void barrier() {
  if constexpr (kWide) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// The forward's top-pass group `it` of tf from device memory (zeros where
// tf is past the batch).
template <int kLogM>
__device__ __forceinline__ void load_top(uint32_t (&v)[Geo<kLogM>::E], const Transform& tf,
                                         uint32_t it) {
  using G = Geo<kLogM>;
  const uint32_t a0 = tile_word<G::kTopD, G::kLogE>(group_of<kLogM, true>(it));
  if (tf.valid) {
    load_global<G::kLogE, G::kTopD>(v, tf.x + (a0 & ((1u << kLogM) - 1u)));
  } else {
#pragma unroll
    for (int j = 0; j < G::E; ++j) v[j] = 0;
  }
}

// One tile of the forward transform.  The top pass's first group arrives
// in `pre` (loaded during the last tile's copy-out); its further groups
// (M >= 16384) are copied into their own words with cp.async while the
// first computes.  The other passes stay in the warp's region of the tile;
// the last one goes to device memory, through the warp's own words from M
// = 1024.  Before the copy-out, `pre` is loaded with the first group of
// tile `next`, whose transform is returned.
template <int kLogM>
__device__ __forceinline__ Transform forward_tile(uint32_t* buf, const Transform& tf,
                                                  uint32_t (&pre)[Geo<kLogM>::E],
                                                  const Batch& b, uint32_t next) {
  using G = Geo<kLogM>;
  constexpr uint32_t kMask = (1u << kLogM) - 1u;
  Transform nx;
  if constexpr (kLogM <= 5) {
    stages<false, G::kLogE, kLogM, false>(pre, tf, 1u);
    if (tf.valid) store_global<G::kLogE, 0>(pre, tf.y);  // the group is the transform
    nx = transform_of<kLogM>(b, next);
    load_top<kLogM>(pre, nx, 0);
  } else {
    barrier<G::kCtaWide>();  // the last tile's words are read
#pragma unroll
    for (int it = 1; it < G::kIters; ++it) {
      const uint32_t a0 = tile_word<G::kTopD, G::kLogE>(group_of<kLogM, true>(it));
      if (tf.valid) {
#pragma unroll
        for (int j = 0; j < G::E; ++j) {
          cp_async4(buf + shared_word<G::kTopD>(swz(a0), j),
                    tf.x + (a0 & kMask) + (j << G::kTopD));
        }
      }
    }
#pragma unroll
    for (int it = 0; it < G::kIters; ++it) {
      const uint32_t a0 = tile_word<G::kTopD, G::kLogE>(group_of<kLogM, true>(it));
      if (it > 0) {
        cp_async_wait_all();
        load_shared<G::kLogE, G::kTopD>(pre, buf, swz(a0));
      }
      stages<false, G::kLogE, 5, false>(pre, tf, 1u);  // (M | index) >> log2 M = 1
      store_shared<G::kLogE, G::kTopD>(pre, buf, swz(a0));
    }
    barrier<G::kCtaWide>();
    if constexpr (kLogM > 10) {
      pass<false, kLogM, 5, kLogM - 10, kShared, kShared>(buf, tf);
      __syncwarp();
    }
    constexpr int k = kLogM < 10 ? kLogM - 5 : 5;
    if constexpr (G::kTranspose) {
      pass<false, kLogM, 0, k, kShared, kShared>(buf, tf);
      __syncwarp();
      nx = transform_of<kLogM>(b, next);
      load_top<kLogM>(pre, nx, 0);
      transpose<kLogM, true>(buf, tf);
    } else {
      pass<false, kLogM, 0, k, kShared, kDevice>(buf, tf);
      nx = transform_of<kLogM>(b, next);
      load_top<kLogM>(pre, nx, 0);
    }
  }
  return nx;
}

// One tile of the inverse: the forward's passes in reverse, each stage
// reversed; the top pass stores to device memory.
template <int kLogM>
__device__ __forceinline__ void inverse_tile(uint32_t* buf, const Transform& tf) {
  using G = Geo<kLogM>;
  if constexpr (kLogM <= 5) {
    pass<true, kLogM, 0, kLogM, kDevice, kDevice>(buf, tf);
  } else {
    barrier<G::kCtaWide>();  // the last tile's words are read
    constexpr int k = kLogM < 10 ? kLogM - 5 : 5;
    if constexpr (G::kTranspose) {
      transpose<kLogM, false>(buf, tf);
      __syncwarp();
      pass<true, kLogM, 0, k, kShared, kShared>(buf, tf);
    } else {
      pass<true, kLogM, 0, k, kDevice, kShared>(buf, tf);
    }
    __syncwarp();
    if constexpr (kLogM > 10) {
      pass<true, kLogM, 5, kLogM - 10, kShared, kShared>(buf, tf);
    }
    barrier<G::kCtaWide>();
    pass<true, kLogM, G::kTopD, 5, kShared, kDevice>(buf, tf);
  }
}

// The shared-memory NTT: persistent CTAs walk tiles of kTileTf transforms
// of the [rows, L, S] batch; a thread's groups lie in transform tid >>
// (log2 M - log2 E) of the tile in every pass.
template <bool kInverse, int kLogM>
__global__ void __launch_bounds__(Geo<kLogM>::kThreads, Geo<kLogM>::kMinCtas)
    ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               const uint2* __restrict__ tw, const uint32_t* __restrict__ consts, uint32_t rows,
               uint32_t L, uint32_t S, int limb_major, int scale) {
  using G = Geo<kLogM>;
  extern __shared__ uint4 smem4[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem4);
  Batch b;
  b.x = x, b.y = y, b.tw = tw, b.consts = consts, b.rows = rows, b.L = L, b.S = S;
  b.nt = rows * L * S;
  b.tiles = (b.nt + G::kTileTf - 1) / G::kTileTf;
  b.limb_major = limb_major != 0;
  b.scale = scale;
  if constexpr (kInverse) {
    for (uint32_t tile = blockIdx.x; tile < b.tiles; tile += gridDim.x) {
      inverse_tile<kLogM>(buf, transform_of<kLogM>(b, tile));
    }
  } else {
    uint32_t pre[G::E];  // the top pass's first group, loaded a tile ahead
    Transform tf = transform_of<kLogM>(b, blockIdx.x);
    load_top<kLogM>(pre, tf, 0);
    for (uint32_t tile = blockIdx.x; tile < b.tiles; tile += gridDim.x) {
      tf = forward_tile<kLogM>(buf, tf, pre, b, tile + gridDim.x);
    }
  }
}

template <bool kInverse, int kLogM>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint2* tw, const uint32_t* consts,
                   int rows, int L, int S, int limb_major, int scale, int threads, int tile_tf,
                   cudaStream_t stream) {
  using G = Geo<kLogM>;
  if (threads != G::kThreads || tile_tf != G::kTileTf) return cudaErrorInvalidValue;
  auto kernel = ntt_kernel<kInverse, kLogM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return refused(err);
  int per_sm = 0, sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return refused(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return refused(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::kThreads,
                                                           G::kSmem)) != cudaSuccess)
    return refused(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long nt = static_cast<long long>(rows) * L * S;
  const long long tiles = (nt + G::kTileTf - 1) / G::kTileTf;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const unsigned int blocks = static_cast<unsigned int>(tiles < slots ? tiles : slots);
  kernel<<<blocks, G::kThreads, G::kSmem, stream>>>(x, y, tw, consts, rows, L, S, limb_major,
                                                     scale);
  return cudaGetLastError();
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

extern "C" int ringsnark_ntt_launch(const void* x, void* y, const void* tw, const void* consts,
                                    int rows, int L, int S, int log_m, int inverse,
                                    int limb_major, int scale, int threads, int tile_tf,
                                    void* stream) {
  const long long nt = static_cast<long long>(rows) * L * S;
  if (log_m < 1 || log_m > 15 || rows < 1 || L < 1 || S < 1 || nt > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  const uint2* t = static_cast<const uint2*>(tw);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RINGSNARK_NTT(N)                                                                    \
  case N:                                                                                   \
    return static_cast<int>(                                                                \
        inverse ? launch<true, N>(xi, yo, t, c, rows, L, S, limb_major, scale, threads,     \
                                  tile_tf, st)                                              \
                : launch<false, N>(xi, yo, t, c, rows, L, S, limb_major, scale, threads,    \
                                   tile_tf, st))
  switch (log_m) {
    RINGSNARK_NTT(1); RINGSNARK_NTT(2); RINGSNARK_NTT(3); RINGSNARK_NTT(4); RINGSNARK_NTT(5);
    RINGSNARK_NTT(6); RINGSNARK_NTT(7); RINGSNARK_NTT(8); RINGSNARK_NTT(9); RINGSNARK_NTT(10);
    RINGSNARK_NTT(11); RINGSNARK_NTT(12); RINGSNARK_NTT(13); RINGSNARK_NTT(14);
    RINGSNARK_NTT(15);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RINGSNARK_NTT
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
