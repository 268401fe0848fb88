// Threefry-2x32 draws shared by the kernels that draw (prng.cu: draw_kernel,
// cbd_kernel, lift_kernel, encrypt_kernel; mac.cu: mac_drawn_kernel), so
// every draw on the card is one copy of the hash, of JAX's uint32 randint
// reduction and of the centred-binomial error.  The contract (a draw's
// words, counters and key columns) is set out in prng.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"  // reduce_once

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

// threefry2x32 with 20 rounds (jax's _threefry2x32_lowering; utils/prng.py)
// of the counter (hi, lo), as y0 ^ y1.
__device__ __forceinline__ uint32_t threefry_hl(uint32_t k0, uint32_t k1, uint32_t hi,
                                                uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define RINGSNARK_ROUND(r) \
  x0 += x1;                \
  x1 = rotl(x1, r);        \
  x1 ^= x0;
#define RINGSNARK_EVEN RINGSNARK_ROUND(13) RINGSNARK_ROUND(15) RINGSNARK_ROUND(26) RINGSNARK_ROUND(6)
#define RINGSNARK_ODD RINGSNARK_ROUND(17) RINGSNARK_ROUND(29) RINGSNARK_ROUND(16) RINGSNARK_ROUND(24)
  RINGSNARK_EVEN
  x0 += k1;
  x1 += k2 + 1u;
  RINGSNARK_ODD
  x0 += k2;
  x1 += k0 + 2u;
  RINGSNARK_EVEN
  x0 += k0;
  x1 += k1 + 3u;
  RINGSNARK_ODD
  x0 += k1;
  x1 += k2 + 4u;
  RINGSNARK_EVEN
  x0 += k2;
  x1 += k0 + 5u;
#undef RINGSNARK_EVEN
#undef RINGSNARK_ODD
#undef RINGSNARK_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1, uint64_t ctr) {
  return threefry_hl(k0, k1, static_cast<uint32_t>(ctr >> 32), static_cast<uint32_t>(ctr));
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
// minus side 1.  |e| <= 32 * n_words.
__device__ __forceinline__ int cbd_value(uint32_t k0, uint32_t k1, uint64_t ctr, uint64_t step,
                                         uint32_t n_words, uint32_t last_mask) {
  int e = 0;
  for (uint32_t w = 0; w < n_words; ++w) {
    const uint32_t mask = w + 1 == n_words ? last_mask : 0xFFFFFFFFu;
    e += __popc(threefry_word(k0, k1, w * step + ctr) & mask);
    e -= __popc(threefry_word(k0, k1, (n_words + w) * step + ctr) & mask);
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
