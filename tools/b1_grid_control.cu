// A measurement control for B1 (src/repro_torch/csrc/mws.cu), not part of
// the kernel library: the streaming gather-reduce with the grid order
// swapped, so the output row runs fastest and the plans that read one
// column block run together.  What it gains over the streaming kernel is
// what the L2 alone recovers of the repeated row reads; the staged kernel
// is measured against both.  Outer-OR form, no spill or shared rows,
// W a multiple of 4 with 16-byte aligned bases.
//
// Built and timed by tools/b1_grid_control.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int OP>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  if (OP == 0) return a & b;
  if (OP == 1) return a | b;
  return a ^ b;
}

template <int OP>
__global__ void row_fastest_kernel(const uint32_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out, int K, int N,
                                   long long W) {
  const long long w0 = ((long long)blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (w0 >= W) return;
  const int b = blockIdx.x;
  uint4 acc_out = make_uint4(0u, 0u, 0u, 0u);
  for (int k = 0; k < K; ++k) {
    const int32_t* ix = idx + ((long long)b * K + k) * N;
    const uint32_t ident = OP == 0 ? 0xFFFFFFFFu : 0u;
    uint4 acc = make_uint4(ident, ident, ident, ident);
    for (int n = 0; n < N; ++n) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + (long long)__ldg(ix + n) * W + w0));
      acc.x = fold<OP>(acc.x, x.x);
      acc.y = fold<OP>(acc.y, x.y);
      acc.z = fold<OP>(acc.z, x.z);
      acc.w = fold<OP>(acc.w, x.w);
    }
    acc_out.x |= acc.x;
    acc_out.y |= acc.y;
    acc_out.z |= acc.z;
    acc_out.w |= acc.w;
  }
  *reinterpret_cast<uint4*>(out + (long long)b * W + w0) = acc_out;
}

}  // namespace

// op: 0 = AND, 1 = OR, 2 = XOR.  Returns the launch's cudaError_t.
extern "C" int b1_row_fastest_launch(const void* src, const void* idx, void* out,
                                     int B, int K, int N, long long W, int op,
                                     void* stream) {
  const int threads = 256;
  const long long col_blocks = (W / 4 + threads - 1) / threads;
  if (B <= 0 || K <= 0 || N <= 0 || W <= 0 || W % 4 || B > 65535 || col_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)col_blocks);
  const uint32_t* s = static_cast<const uint32_t*>(src);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == 0) row_fastest_kernel<0><<<grid, threads, 0, st>>>(s, ix, o, K, N, W);
  else if (op == 1) row_fastest_kernel<1><<<grid, threads, 0, st>>>(s, ix, o, K, N, W);
  else if (op == 2) row_fastest_kernel<2><<<grid, threads, 0, st>>>(s, ix, o, K, N, W);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
