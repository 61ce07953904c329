// Per-row population count of packed words on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/popcount/popcount.py:popcount_pallas
// (SWAR popcount, summed across word blocks).
//
// Computes out[r] = sum_w popc(x[r, w]) for an (R, W) word array, as
// int32 (exact: the count of one row is at most 32 * W < 2^31).
//
// Bound: memory.  It reads R * W * 4 bytes once and writes 4 * R bytes,
// over 3.35 TB/s of HBM on an H100 SXM; __popc is one instruction per
// word, far below the card's integer rate.
//
// Design: a 2-D grid, one CTA per (slice of WORDS_PER_CTA words, row).
// Each thread reads 16-byte groups (4-byte words where W or the base is
// not 16-byte aligned) in a strided loop, so a warp's loads are
// contiguous; counts are summed in a register, then reduced with warp
// shuffles and one shared-memory pass.  Nothing carries between CTAs on
// this card, so each CTA adds its row partial into out[r] with one
// atomicAdd after the launcher zeroes out[] on the same stream.  Integer
// addition is associative, so the result is exact whatever the order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 8;  // loop trips per thread

template <int VEC>
__global__ void popcount_kernel(const uint32_t* __restrict__ x,
                                int32_t* __restrict__ out, long long W) {
  const long long per_cta = (long long)kThreads * VEC * kIters;
  const uint32_t* row = x + (long long)blockIdx.y * W;
  const long long begin = (long long)blockIdx.x * per_cta;
  const long long end = begin + per_cta < W ? begin + per_cta : W;
  unsigned int cnt = 0;
  for (long long w = begin + (long long)threadIdx.x * VEC; w < end;
       w += (long long)kThreads * VEC) {
    if (VEC == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + w));
      cnt += __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
    } else {
      cnt += __popc(__ldg(row + w));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  __shared__ unsigned int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    if (lane == 0 && cnt) atomicAdd(out + blockIdx.y, (int)cnt);
  }
}

}  // namespace

// vec: 4 (W % 4 == 0, 16-byte aligned base) or 1.  Zeroes out[0:R] on the
// stream, then launches.  Returns the cudaError_t (0 on success).
extern "C" int popcount_launch(const void* x, void* out, int R, long long W,
                               int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || W <= 0 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)R, st);
  if (err != cudaSuccess) return (int)err;
  const long long per_cta = (long long)kThreads * vec * kIters;
  dim3 grid((unsigned)((W + per_cta - 1) / per_cta), (unsigned)R);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec == 4)
    popcount_kernel<4><<<grid, kThreads, 0, st>>>(xp, op, W);
  else
    popcount_kernel<1><<<grid, kThreads, 0, st>>>(xp, op, W);
  return (int)cudaGetLastError();
}
