// Modular arithmetic on 31-bit residues, shared by the kernels of this
// package (ntt.cu, prng.cu, mac.cu, witness.cu): p < 2^31, residues in [0,
// p), unsigned 32-bit words throughout (Hopper has a native 32-bit
// multiply-high, __umulhi).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// An error returned before or by a launch also stays as the runtime's last
// error, which the next launch's cudaGetLastError() would report as its
// own: clear it, and return it to this caller.
inline cudaError_t refused(cudaError_t err) {
  (void)cudaGetLastError();
  return err;
}

// x in [0, 2p) -> x mod p: where x < p, x - p wraps above x (unsigned min).
__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t p) {
  return min(x, x - p);
}

// a * b + c as one IMAD on the FMA pipe, whatever ptxas knows of b (a
// multiply by 0 or 1 it would fold into a select or an add on the ALU).
__device__ __forceinline__ uint32_t imad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  return reduce_once(a + b, p);  // a, b < p < 2^31: no wrap
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return reduce_once(a + p - b, p);  // in [1, 2p)
}

// a * w mod p with w_sh = floor(w * 2^32 / p), for any a < 2^32:
// r = a*w - q*p lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint2 w, uint32_t p) {
  const uint32_t q = __umulhi(a, w.y);
  return reduce_once(a * w.x - q * p, p);
}

// w's Shoup constant floor(w 2^32 / q), or one less, for w < q < 2^31,
// from the halves of mu = floor(2^64 / q) (csrc/mac.cu's head proves it):
// for an operand word that is not a constant of the launch.
__device__ __forceinline__ uint32_t shoup_of(uint32_t w, uint32_t mu_hi, uint32_t mu_lo) {
  return w * mu_hi + __umulhi(w, mu_lo);
}

// a * w mod q, canonical, for a < 2^31, w < q < 2^31 and w_sh = shoup_of(w).
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t w, uint32_t w_sh, uint32_t q) {
  return reduce_once(a * w - __umulhi(a, w_sh) * q, q);  // r in [0, 2q): exact in 32 bits
}

}  // namespace
