// One-pass bitwise reduce + population count (the BMI count) on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/mws_count/mws_count.py:mws_count_pallas
// (the AND/OR/XOR reduce over the operand axis held in VMEM, then a SWAR
// popcount, so only a scalar leaves the chip).
//
// Computes, for an (N, W) word stack x and op in {AND, OR, XOR}:
//     count = sum_w popc(post(OP_n x[n, w]))
// where post() complements for the inverse-read ops (NAND/NOR/XNOR).
// The reduced row is never written: each thread folds its column in
// registers and adds its popcount.  No padding is read or corrected for:
// the kernel reads exactly N * W words.
//
// Bound: memory.  It reads N * W * 4 bytes once and writes 8; one logic
// op per word read and one popc per column are far below the card's
// integer rate.  At the paper's size (800M users, W = 25,000,000, N = 365)
// that is 36.5 GB, about 10.9 ms at 3.35 TB/s on an H100 SXM.
//
// Design: each thread owns one column group (four words with 16-byte
// loads when W % 4 == 0 and the base is 16-byte aligned, else one word)
// and walks the N rows W words apart, so each warp's load per row is one
// contiguous run of 512 (or 128) bytes.  The row loop is unrolled by
// kUnroll with all loads issued before the folds, so that many independent
// loads are in flight per thread.  The grid strides over column groups
// with 64-bit offsets (N * W is 9.1e9 words at d = 365).  Counts are
// summed in 64 bits, reduced with warp shuffles and one shared-memory
// pass, and each CTA adds its partial with one 64-bit atomicAdd into a
// counter the caller zeroed on the same stream.  Integer addition is
// associative, so the count is exact whatever order the CTAs run in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_AND = 0, OP_OR = 1, OP_XOR = 2 };

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kCtasPerSm = 8;

template <int OP>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  return a ^ b;
}

template <int VEC>
struct Group {
  uint32_t v[VEC];
  __device__ __forceinline__ void load(const uint32_t* p) {
    if (VEC == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
    }
  }
};

template <int OP, int VEC>
__global__ void mws_count_kernel(const uint32_t* __restrict__ x,
                                 unsigned long long* __restrict__ out,
                                 long long N, long long W, int invert) {
  const long long groups = W / VEC;  // VEC divides W (the launcher checks)
  unsigned long long cnt = 0;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const uint32_t* col = x + g * VEC;
    Group<VEC> acc;
    acc.load(col);
    long long n = 1;
    for (; n + kUnroll <= N; n += kUnroll) {
      Group<VEC> r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u].load(col + (n + u) * W);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc.v[i] = fold<OP>(acc.v[i], r[u].v[i]);
      }
    }
    for (; n < N; ++n) {
      Group<VEC> r;
      r.load(col + n * W);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc.v[i] = fold<OP>(acc.v[i], r.v[i]);
    }
    unsigned int c = 0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) c += __popc(invert ? ~acc.v[i] : acc.v[i]);
    cnt += c;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    if (lane == 0 && cnt) atomicAdd(out, cnt);
  }
}

template <int OP, int VEC>
cudaError_t launch(const uint32_t* x, unsigned long long* out, long long N,
                   long long W, int invert, int sms, cudaStream_t stream) {
  const long long groups = W / VEC;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kCtasPerSm;
  if (blocks > cap) blocks = cap;
  mws_count_kernel<OP, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, N, W, invert);
  return cudaGetLastError();
}

}  // namespace

// op: 0 = AND, 1 = OR, 2 = XOR; invert complements the reduced word before
// the count.  vec: 4 (W % 4 == 0, 16-byte aligned base) or 1.  out is one
// 64-bit counter, zeroed by the caller on the same stream.  Returns the
// cudaError_t (0 on success).
extern "C" int mws_count_launch(const void* x, void* out, long long N,
                                long long W, int op, int invert, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || W <= 0 || (vec != 1 && vec != 4) || W % vec)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  if (vec == 4) {
    switch (op) {
      case OP_AND: return launch<OP_AND, 4>(xp, o, N, W, invert, sms, st);
      case OP_OR: return launch<OP_OR, 4>(xp, o, N, W, invert, sms, st);
      case OP_XOR: return launch<OP_XOR, 4>(xp, o, N, W, invert, sms, st);
    }
  } else {
    switch (op) {
      case OP_AND: return launch<OP_AND, 1>(xp, o, N, W, invert, sms, st);
      case OP_OR: return launch<OP_OR, 1>(xp, o, N, W, invert, sms, st);
      case OP_XOR: return launch<OP_XOR, 1>(xp, o, N, W, invert, sms, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
