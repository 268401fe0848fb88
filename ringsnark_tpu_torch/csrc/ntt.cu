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
//     `_outer_kernel`: `outer_kernel` below plus `ntt_kernel` on the
//     [B, L, R, Mi] view as the inner pass.
//
// Contract (identical to the TPU kernels and to the plain twins in
// ops/ntt.py, bit for bit):
//   forward: natural order in, bit-reversed order out (DIF butterflies
//            a' = a + b, b' = (a - b) * w); negacyclic first twists by psi^i;
//   inverse: bit-reversed order in, natural order out (DIT butterflies
//            m = b * w, a' = a + m, b' = a - m); then psi^-i * M^-1
//            (negacyclic) or M^-1 (cyclic).
//   Inputs are residues in [0, p); outputs are fully reduced into [0, p).
//
// What bounds it on this card: it is memory-bound.  Each transform reads and
// writes its M residues once (8 bytes per element), plus the per-stage
// twiddles and their Shoup companions (8 bytes per butterfly), which are
// shared by every row of a limb and stay in L2.  The modular arithmetic is
// a handful of 32-bit integer ops per butterfly (one __umulhi Shoup
// multiply, no 64-bit products).
//
// What the design does about it:
// * ntt_kernel: one CTA per (row, limb) transform holds the whole
//   polynomial in dynamic shared memory (32 KiB at M = 8192, 128 KiB at
//   M = 32768) and runs all log2(M) stages there with __syncthreads between
//   stages, so device memory sees one read and one write per element.  The
//   psi twist and M^-1 fold into the load / store passes.  Data are
//   [B, L, S, M] (S = 1 for a plain batch, S = R for the split inner pass);
//   CTA g takes transform g in row order, or in limb-major order (all rows
//   of limb 0 first), which only changes which transforms run together.
// * outer_kernel (split M = R * Mi, Mi = 16384 on the main path): one
//   thread per (row, limb, column c) loads the R residues of column c of
//   the [R, Mi] view (stride Mi; coalesced across threads along c), keeps
//   them in registers, runs all log2(R) outer stages and writes them back:
//   one more read and write per element than a single-pass transform.
//   The psi twist (forward) and psi^-k M^-1 or M^-1 (inverse) fold into it,
//   so the inner pass runs unscaled.
// Not done yet (later work): a register-resident radix, several rows per
// CTA, fusing the outer pass into the inner kernel's load or store.
//
// Tables (built once per (primes, M) on the host from ops/ntt.get_plan and
// ops/ntt.get_split_tables):
//   tw, tw_sh   [L, M] uint32: entry d + k (1 <= d < M, k < d) is w_{2d}^k
//               (forward: w; inverse: w^-1) and its Shoup constant
//               floor(w * 2^32 / p); entry 0 is unused.
//   sc, sc_sh   [L, M] uint32: psi^i (forward) or psi^-i * M^-1 (inverse)
//               and Shoup constants; unused for cyclic transforms.
//   consts      [L, 3] uint32: p, M^-1 mod p, Shoup constant of M^-1.
//   outer:      tw [L, s, R, Mi] positioned stage twiddles (read at the
//               b-row of each pair), sc [L, R, Mi] twists, consts with the
//               full-size M^-1.
//
// C interface: ringsnark_ntt_launch and ringsnark_ntt_outer_launch return
// cudaGetLastError() after the launch (0 on success); the Python wrapper
// raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t s = a + b;  // a, b < p < 2^31: no wrap
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t d = a + p - b;  // in [1, 2p)
  return d >= p ? d - p : d;
}

// a * w mod p with w_sh = floor(w * 2^32 / p): r = a*w - q*p lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t w_sh,
                                              uint32_t p) {
  uint32_t q = __umulhi(a, w_sh);
  uint32_t r = a * w - q * p;
  return r >= p ? r - p : r;
}

template <bool kInverse, bool kNegacyclic>
__global__ void ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                           const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ tw_sh,
                           const uint32_t* __restrict__ sc,
                           const uint32_t* __restrict__ sc_sh,
                           const uint32_t* __restrict__ consts, int rows, int L,
                           int S, int log_m, int limb_major, int scale) {
  extern __shared__ uint32_t buf[];
  const int M = 1 << log_m;
  const int half = M >> 1;
  // transform t of the [rows, L, S] batch; limb-major order walks limb 0's
  // rows * S transforms first
  const size_t g = blockIdx.x;
  int limb;
  size_t t;
  if (limb_major) {
    const size_t per_limb = (size_t)rows * (size_t)S;
    limb = (int)(g / per_limb);
    const size_t j = g % per_limb;
    t = ((j / S) * L + limb) * S + j % S;
  } else {
    limb = (int)((g / S) % L);
    t = g;
  }
  const size_t base = t * (size_t)M;
  const size_t tbase = (size_t)limb * (size_t)M;
  const uint32_t p = consts[3 * limb];
  const uint32_t* w = tw + tbase;
  const uint32_t* w_sh = tw_sh + tbase;

  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    uint32_t v = x[base + i];
    if (!kInverse && kNegacyclic) v = shoup_mul(v, sc[tbase + i], sc_sh[tbase + i], p);
    buf[i] = v;
  }
  __syncthreads();

  if (!kInverse) {
    // DIF: d = M/2 .. 1
    for (int logd = log_m - 1; logd >= 0; --logd) {
      const int d = 1 << logd;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int k = j & (d - 1);
        const int i0 = ((j >> logd) << (logd + 1)) + k;
        const uint32_t a = buf[i0];
        const uint32_t b = buf[i0 + d];
        buf[i0] = add_mod(a, b, p);
        buf[i0 + d] = shoup_mul(sub_mod(a, b, p), w[d + k], w_sh[d + k], p);
      }
      __syncthreads();
    }
  } else {
    // DIT: d = 1 .. M/2
    for (int logd = 0; logd < log_m; ++logd) {
      const int d = 1 << logd;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int k = j & (d - 1);
        const int i0 = ((j >> logd) << (logd + 1)) + k;
        const uint32_t a = buf[i0];
        const uint32_t m = shoup_mul(buf[i0 + d], w[d + k], w_sh[d + k], p);
        buf[i0] = add_mod(a, m, p);
        buf[i0 + d] = sub_mod(a, m, p);
      }
      __syncthreads();
    }
  }

  const uint32_t minv = consts[3 * limb + 1];
  const uint32_t minv_sh = consts[3 * limb + 2];
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    uint32_t v = buf[i];
    if (kInverse) {
      if (kNegacyclic) {
        v = shoup_mul(v, sc[tbase + i], sc_sh[tbase + i], p);
      } else if (scale) {
        v = shoup_mul(v, minv, minv_sh, p);
      }
    }
    y[base + i] = v;
  }
}

template <bool kInverse, bool kNegacyclic>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint32_t* tw,
                   const uint32_t* tw_sh, const uint32_t* sc, const uint32_t* sc_sh,
                   const uint32_t* consts, int rows, int L, int S, int log_m,
                   int limb_major, int scale, cudaStream_t stream) {
  const int M = 1 << log_m;
  const size_t smem = (size_t)M * sizeof(uint32_t);
  int threads = M / 2;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_kernel<kInverse, kNegacyclic>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = (unsigned int)rows * (unsigned int)L * (unsigned int)S;
  ntt_kernel<kInverse, kNegacyclic><<<blocks, threads, smem, stream>>>(
      x, y, tw, tw_sh, sc, sc_sh, consts, rows, L, S, log_m, limb_major, scale);
  return cudaGetLastError();
}

// All log2(R) outer stages of the split transform on the [B, L, R, Mi] view:
// thread t = (row b, limb l, column c) owns x[b, l, 0..R-1, c].
template <int kLogR, bool kInverse, bool kNegacyclic>
__global__ void outer_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                             const uint32_t* __restrict__ tw,
                             const uint32_t* __restrict__ tw_sh,
                             const uint32_t* __restrict__ sc,
                             const uint32_t* __restrict__ sc_sh,
                             const uint32_t* __restrict__ consts, size_t columns, int L,
                             int log_mi) {
  constexpr int R = 1 << kLogR;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= columns) return;
  const size_t Mi = (size_t)1 << log_mi;
  const size_t c = t & (Mi - 1);
  const size_t bl = t >> log_mi;  // row * L + limb
  const int limb = (int)(bl % L);
  const size_t base = bl * R * Mi + c;
  const size_t sbase = (size_t)limb * R * Mi + c;          // sc: [L, R, Mi]
  const size_t tbase = (size_t)limb * kLogR * R * Mi + c;  // tw: [L, s, R, Mi]
  const uint32_t p = consts[3 * limb];

  uint32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = x[base + r * Mi];
    if (!kInverse && kNegacyclic) {
      v[r] = shoup_mul(v[r], sc[sbase + r * Mi], sc_sh[sbase + r * Mi], p);
    }
  }

  if (!kInverse) {
    // DIF: stage i pairs rows r, r + d with d = R >> (i + 1)
#pragma unroll
    for (int i = 0; i < kLogR; ++i) {
      const int d = R >> (i + 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & (2 * d - 1)) < d) {
          const size_t ti = tbase + ((size_t)i * R + r + d) * Mi;
          const uint32_t a = v[r];
          const uint32_t b = v[r + d];
          v[r] = add_mod(a, b, p);
          v[r + d] = shoup_mul(sub_mod(a, b, p), tw[ti], tw_sh[ti], p);
        }
      }
    }
  } else {
    // DIT: stages in reverse order, the twiddle read at the b-row
#pragma unroll
    for (int i = kLogR - 1; i >= 0; --i) {
      const int d = R >> (i + 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & (2 * d - 1)) < d) {
          const size_t ti = tbase + ((size_t)i * R + r + d) * Mi;
          const uint32_t a = v[r];
          const uint32_t m = shoup_mul(v[r + d], tw[ti], tw_sh[ti], p);
          v[r] = add_mod(a, m, p);
          v[r + d] = sub_mod(a, m, p);
        }
      }
    }
    const uint32_t minv = consts[3 * limb + 1];
    const uint32_t minv_sh = consts[3 * limb + 2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = kNegacyclic ? shoup_mul(v[r], sc[sbase + r * Mi], sc_sh[sbase + r * Mi], p)
                         : shoup_mul(v[r], minv, minv_sh, p);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) y[base + r * Mi] = v[r];
}

template <int kLogR>
cudaError_t launch_outer(const uint32_t* x, uint32_t* y, const uint32_t* tw,
                         const uint32_t* tw_sh, const uint32_t* sc, const uint32_t* sc_sh,
                         const uint32_t* consts, int rows, int L, int log_mi, bool inverse,
                         bool negacyclic, cudaStream_t stream) {
  const size_t columns = (size_t)rows * (size_t)L << log_mi;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((columns + threads - 1) / threads);
  if (inverse) {
    if (negacyclic) {
      outer_kernel<kLogR, true, true><<<blocks, threads, 0, stream>>>(
          x, y, tw, tw_sh, sc, sc_sh, consts, columns, L, log_mi);
    } else {
      outer_kernel<kLogR, true, false><<<blocks, threads, 0, stream>>>(
          x, y, tw, tw_sh, sc, sc_sh, consts, columns, L, log_mi);
    }
  } else {
    if (negacyclic) {
      outer_kernel<kLogR, false, true><<<blocks, threads, 0, stream>>>(
          x, y, tw, tw_sh, sc, sc_sh, consts, columns, L, log_mi);
    } else {
      outer_kernel<kLogR, false, false><<<blocks, threads, 0, stream>>>(
          x, y, tw, tw_sh, sc, sc_sh, consts, columns, L, log_mi);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ringsnark_ntt_launch(const void* x, void* y, const void* tw,
                                    const void* tw_sh, const void* sc,
                                    const void* sc_sh, const void* consts, int rows,
                                    int L, int S, int log_m, int inverse, int negacyclic,
                                    int limb_major, int scale, void* stream) {
  if (log_m < 1 || log_m > 15 || rows < 1 || L < 1 || S < 1 ||
      (long long)rows * (long long)L * (long long)S > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  const uint32_t* t = static_cast<const uint32_t*>(tw);
  const uint32_t* ts = static_cast<const uint32_t*>(tw_sh);
  const uint32_t* s = static_cast<const uint32_t*>(sc);
  const uint32_t* ss = static_cast<const uint32_t*>(sc_sh);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (inverse) {
    err = negacyclic
              ? launch<true, true>(xi, yo, t, ts, s, ss, c, rows, L, S, log_m, limb_major,
                                   scale, st)
              : launch<true, false>(xi, yo, t, ts, s, ss, c, rows, L, S, log_m, limb_major,
                                    scale, st);
  } else {
    err = negacyclic
              ? launch<false, true>(xi, yo, t, ts, s, ss, c, rows, L, S, log_m, limb_major,
                                    scale, st)
              : launch<false, false>(xi, yo, t, ts, s, ss, c, rows, L, S, log_m,
                                     limb_major, scale, st);
  }
  return (int)err;
}

extern "C" int ringsnark_ntt_outer_launch(const void* x, void* y, const void* tw,
                                          const void* tw_sh, const void* sc,
                                          const void* sc_sh, const void* consts, int rows,
                                          int L, int log_r, int log_mi, int inverse,
                                          int negacyclic, void* stream) {
  if (log_r < 1 || log_r > 5 || log_mi < 1 || log_mi > 20 || rows < 1 || L < 1 ||
      (((long long)rows * (long long)L) << log_mi) / 256 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  const uint32_t* t = static_cast<const uint32_t*>(tw);
  const uint32_t* ts = static_cast<const uint32_t*>(tw_sh);
  const uint32_t* s = static_cast<const uint32_t*>(sc);
  const uint32_t* ss = static_cast<const uint32_t*>(sc_sh);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0, nega = negacyclic != 0;
  cudaError_t err;
  switch (log_r) {
    case 1: err = launch_outer<1>(xi, yo, t, ts, s, ss, c, rows, L, log_mi, inv, nega, st); break;
    case 2: err = launch_outer<2>(xi, yo, t, ts, s, ss, c, rows, L, log_mi, inv, nega, st); break;
    case 3: err = launch_outer<3>(xi, yo, t, ts, s, ss, c, rows, L, log_mi, inv, nega, st); break;
    case 4: err = launch_outer<4>(xi, yo, t, ts, s, ss, c, rows, L, log_mi, inv, nega, st); break;
    default: err = launch_outer<5>(xi, yo, t, ts, s, ss, c, rows, L, log_mi, inv, nega, st); break;
  }
  return (int)err;
}
