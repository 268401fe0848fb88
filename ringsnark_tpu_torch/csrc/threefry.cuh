// Threefry-2x32 draws shared by the kernels that draw (prng.cu: draw_kernel,
// cbd_kernel, lift_kernel, encrypt_kernel; mac.cu: mac_drawn_kernel), so
// every draw on the card is one copy of the hash, of JAX's uint32 randint
// reduction and of the centred-binomial error.  The contract (a draw's
// words, counters and key columns) is set out in prng.cu.  The hash's adds
// go where the compiler puts them (threefry_hl: draw_kernel, cbd_kernel,
// encrypt_kernel) or onto the FMA pipe (threefry<true>, threefry_n<true>:
// lift_kernel, mac_drawn_kernel), as each kernel measured faster.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once, imad

namespace {

constexpr int kMaxCols = 32;  // key columns (inner primes) a launch

// One key column (ops/cuda_prng.column): the key of the low word (the key
// itself for bits), of the high word, the span (0: raw bits), JAX's
// multiplier, mu = min(floor(2^32 / span), 2^32 - 1) and minval as uint32.
struct Column {
  uint32_t lo0, lo1, hi0, hi1, span, mult, mu, minval;
};

struct Columns {
  Column c[kMaxCols];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// A key with the words its injections add, hoisted out of every hash: after
// each group of four rounds x0 gets k1, k2, k0, k1, k2 and x1 gets s1 ... s5
// = k2 + 1, k0 + 2, k1 + 3, k2 + 4, k0 + 5 (k2 = k0 ^ k1 ^ 0x1BD11BDA), so
// every injection is a two-input add.  Made once a key: on the host for a
// launch's one key, once a tile in the kernels that walk key columns.
struct HashKey {
  uint32_t k0, k1, k2, s1, s2, s3, s4, s5;
};

__host__ __device__ __forceinline__ HashKey hash_key(uint32_t k0, uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return HashKey{k0, k1, k2, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u};
}

// a + b.  With kFma it issues on the FMA pipe, as IMAD a * one + b with
// `one` a launch parameter that is 1 at run time: ptxas cannot fold a
// multiply by a value it does not know, so it keeps the IMAD, where it
// would put a plain add on the ALU beside the hash's rotations and xors.
template <bool kFma>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t one) {
  if constexpr (kFma) {
    return imad(a, one, b);
  } else {
    return a + b;
  }
}

template <bool kFma, int N, int R>
__device__ __forceinline__ void round_n(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t one) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] = add<kFma>(x0[n], x1[n], one);
    x1[n] = rotl(x1[n], R) ^ x0[n];
  }
}

template <bool kFma, int N>
__device__ __forceinline__ void inject_n(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t a,
                                         uint32_t b, uint32_t one) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] = add<kFma>(x0[n], a, one);
    x1[n] = add<kFma>(x1[n], b, one);
  }
}

template <bool kFma, int N>
__device__ __forceinline__ void even_n(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t one) {
  round_n<kFma, N, 13>(x0, x1, one);
  round_n<kFma, N, 15>(x0, x1, one);
  round_n<kFma, N, 26>(x0, x1, one);
  round_n<kFma, N, 6>(x0, x1, one);
}

template <bool kFma, int N>
__device__ __forceinline__ void odd_n(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t one) {
  round_n<kFma, N, 17>(x0, x1, one);
  round_n<kFma, N, 29>(x0, x1, one);
  round_n<kFma, N, 16>(x0, x1, one);
  round_n<kFma, N, 24>(x0, x1, one);
}

// threefry2x32 with 20 rounds (jax's _threefry2x32_lowering; utils/prng.py)
// of N counters (hi[n], lo[n]) under one key, in lockstep (N independent
// chains interleaved round by round), as y[n] = y0 ^ y1.  The caller passes
// each counter's x0 = hi[n] + k0, so that counters sharing a high word add
// it once.  A word is then 20 funnel-shift rotations and 21 xors, which only
// the ALU issues, and 31 two-input adds (the low word's key, 20 rounds, 10
// injections), on the FMA pipe with kFma.
template <bool kFma, int N>
__device__ __forceinline__ void threefry_n(const HashKey& k, const uint32_t (&x0_in)[N],
                                           const uint32_t (&lo)[N], uint32_t one,
                                           uint32_t (&y)[N]) {
  uint32_t x0[N], x1[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] = x0_in[n];
    x1[n] = add<kFma>(lo[n], k.k1, one);
  }
  even_n<kFma, N>(x0, x1, one);
  inject_n<kFma, N>(x0, x1, k.k1, k.s1, one);
  odd_n<kFma, N>(x0, x1, one);
  inject_n<kFma, N>(x0, x1, k.k2, k.s2, one);
  even_n<kFma, N>(x0, x1, one);
  inject_n<kFma, N>(x0, x1, k.k0, k.s3, one);
  odd_n<kFma, N>(x0, x1, one);
  inject_n<kFma, N>(x0, x1, k.k1, k.s4, one);
  even_n<kFma, N>(x0, x1, one);
  inject_n<kFma, N>(x0, x1, k.k2, k.s5, one);
#pragma unroll
  for (int n = 0; n < N; ++n) y[n] = x0[n] ^ x1[n];
}

template <bool kFma>
__device__ __forceinline__ uint32_t threefry(const HashKey& k, uint32_t hi, uint32_t lo,
                                             uint32_t one) {
  const uint32_t h[1] = {add<kFma>(hi, k.k0, one)}, l[1] = {lo};
  uint32_t y[1];
  threefry_n<kFma, 1>(k, h, l, one, y);
  return y[0];
}

// One word as the compiler places its adds.
__device__ __forceinline__ uint32_t threefry_hl(uint32_t k0, uint32_t k1, uint32_t hi,
                                                uint32_t lo) {
  return threefry<false>(hash_key(k0, k1), hi, lo, 1u);
}

// w mod span for any w < 2^32, span in [1, 2^31]: q = umulhi(w, mu) is
// floor(w / span) or one less, so w - q * span lies in [0, 2 span).
__device__ __forceinline__ uint32_t mod_span(uint32_t w, uint32_t span, uint32_t mu) {
  return reduce_once(w - __umulhi(w, mu) * span, span);
}

// The word or value of column col at the counter (hi, lo) (see prng.cu's
// contract).
__device__ __forceinline__ uint32_t draw_value_hl(const Column& col, uint32_t hi, uint32_t lo) {
  const uint32_t w = threefry_hl(col.lo0, col.lo1, hi, lo);
  if (col.span == 0) return w;
  uint32_t off = mod_span(w, col.span, col.mu);
  if (col.mult != 0) {
    const uint32_t h = mod_span(threefry_hl(col.hi0, col.hi1, hi, lo), col.span, col.mu);
    off = mod_span(h * col.mult + off, col.span, col.mu);
  }
  return off + col.minval;
}

__device__ __forceinline__ uint32_t draw_value(const Column& col, uint64_t ctr) {
  return draw_value_hl(col, static_cast<uint32_t>(ctr >> 32), static_cast<uint32_t>(ctr));
}

// The centred-binomial error of one coefficient (bgv._sample_error_coeffs):
// the key's words (side, w) at the counters (side * n_words + w) * step +
// ctr, the last word of a side masked to last_mask, popcounts of side 0
// minus side 1, the two sides' hashes of a word in lockstep.  |e| <= 32 *
// n_words.  One word a side (k <= 32: every context the port runs, k = 21
// at sigma = 3.2) draws with no loop; more (a larger sigma) loop over the
// words.
template <bool kFma>
__device__ __forceinline__ int cbd_pair(const HashKey& k, uint64_t c0, uint64_t c1,
                                        uint32_t mask, uint32_t one) {
  const uint32_t h[2] = {add<kFma>(static_cast<uint32_t>(c0 >> 32), k.k0, one),
                         add<kFma>(static_cast<uint32_t>(c1 >> 32), k.k0, one)};
  const uint32_t lo[2] = {static_cast<uint32_t>(c0), static_cast<uint32_t>(c1)};
  uint32_t y[2];
  threefry_n<kFma, 2>(k, h, lo, one, y);
  return __popc(y[0] & mask) - __popc(y[1] & mask);
}

template <bool kFma>
__device__ __forceinline__ int cbd_value(const HashKey& k, uint64_t ctr, uint64_t step,
                                         uint32_t n_words, uint32_t last_mask, uint32_t one) {
  if (n_words == 1) return cbd_pair<kFma>(k, ctr, step + ctr, last_mask, one);
  int e = 0;
  for (uint32_t w = 0; w < n_words; ++w) {
    e += cbd_pair<kFma>(k, w * step + ctr, (n_words + w) * step + ctr,
                        w + 1 == n_words ? last_mask : 0xFFFFFFFFu, one);
  }
  return e;
}

// The host's table of C columns (uint32 [C, 8], ops/cuda_prng._table) as
// the launch parameter.
inline Columns columns_of(const uint32_t* table, int C) {
  Columns cols = {};
  for (int c = 0; c < C; ++c) {
    const uint32_t* w = table + 8 * c;
    cols.c[c] = Column{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]};
  }
  return cols;
}

}  // namespace
