// k-of-n threshold sensing on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/threshold/threshold.py:threshold_pallas
// (body _kernel -> bitslice_threshold).
//
// Computes, for every batch row b and bit j of every word w:
//     out[b, w] bit j = (number of rows r < n with x[b, r, w] bit j set) >= k
// complemented when `invert` is set (inverse read after the comparison).
// x is (B, n, W) with n <= 8: the per-block AND results of one threshold
// sensing per batch row.
//
// Bound: memory.  It reads B * n * W * 4 bytes once and writes B * W * 4
// bytes, over 3.35 TB/s of HBM on an H100 SXM; the counter costs about
// a dozen logic ops per word read, far below the card's integer rate.
//
// Design: the same bit-sliced ripple-carry counter as the Pallas kernel.
// The per-bit counts are never materialised: they are held across four
// 32-bit planes in registers (counts <= 8 fit in 4 bits), each row costs
// two logic ops per plane, and `count >= k` is an OR over v = k..n of
// the unrolled equality test count == v.  One thread per 16-byte group of
// 4 words (4-byte words when W or a base is not 16-byte aligned); grid.y
// walks the batch.  Each input word is read once, each output written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCountBits = 4;

template <int VEC>
__global__ void threshold_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, int n,
                                 long long W, int k, int invert) {
  const long long w0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (w0 >= W) return;
  const long long b = blockIdx.y;
  uint32_t c[VEC][kCountBits];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
#pragma unroll
    for (int j = 0; j < kCountBits; ++j) c[i][j] = 0u;

  for (int r = 0; r < n; ++r) {
    const uint32_t* p = x + (b * n + r) * W + w0;
    uint32_t v[VEC];
    if (VEC == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      uint32_t carry = v[i];
#pragma unroll
      for (int j = 0; j < kCountBits; ++j) {
        const uint32_t t = c[i][j] & carry;
        c[i][j] ^= carry;
        carry = t;
      }
    }
  }

  uint32_t res[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    uint32_t acc = 0u;
    for (int val = k; val <= n; ++val) {
      uint32_t term = 0xFFFFFFFFu;
#pragma unroll
      for (int j = 0; j < kCountBits; ++j)
        term &= ((val >> j) & 1) ? c[i][j] : ~c[i][j];
      acc |= term;
    }
    res[i] = invert ? ~acc : acc;
  }
  uint32_t* o = out + b * W + w0;
  if (VEC == 4) {
    *reinterpret_cast<uint4*>(o) = make_uint4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = res[i];
  }
}

}  // namespace

// vec: 4 (W % 4 == 0, 16-byte aligned bases) or 1.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int threshold_launch(const void* x, void* out, int B, int n,
                                long long W, int k, int invert, int vec,
                                void* stream) {
  if (B <= 0 || n <= 0 || n > 8 || W <= 0 || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long groups = (W + vec - 1) / vec;
  dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)B);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  if (vec == 4)
    threshold_kernel<4><<<grid, threads, 0, st>>>(xp, op, n, W, k, invert);
  else if (vec == 1)
    threshold_kernel<1><<<grid, threads, 0, st>>>(xp, op, n, W, k, invert);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
