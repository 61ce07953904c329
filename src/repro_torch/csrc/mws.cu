// Gather-reduce for Multi-Wordline Sensing (MWS) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mws/mws.py:mws_reduce_pallas (the fused
// operand-axis reduce), together with the slot gather that feeds it in
// src/repro/query/device.py:plan_step_fn (`data[idx]`) and
// src/repro/core/engine.py:FlashArray._gather_cube.
//
// Computes, for every batch row b:
//     per[b, k] = INNER_n row(idx[b, k, n])        INNER in {AND, OR, XOR}
//     out[b]    = post(OR_k per[b, k])             (outer_or = 1), or
//     out[b, k] = post(per[b, k])                  (outer_or = 0)
// where post() is an optional complement (inverse read).  row(r) is
// src[r] for r >= 0; a negative r names a substituted row j = -1 - r:
// ext[b * m_ext + j] for j < m_ext (per-plan spill scratch), else
// shr[j - m_ext] (flush-wide shared CSE values, the same for every b).
// So spilled and shared rows enter the reduce without the snapshot ever
// being copied into a gathered (B, K, N, W) cube.
//
// Bound: memory.  Each output word reads K * N words and writes one:
// (B*K*N + B) * 4 * W bytes for the outer-OR form, over 3.35 TB/s of HBM
// on an H100 SXM.  There is no arithmetic to speak of (one logic op per
// word read).
//
// Design: one thread per 16-byte group of 4 words along W (plain 4-byte
// words when W or a base pointer is not 16-byte aligned), so a warp reads
// 512 contiguous bytes of one row per load; grid.y walks the batch (and
// the blocks, for the per-block form).  The K x N fold lives in
// registers; every source row is read once per output word and the
// output is written once.  The K*N row indices of a batch row are the
// same for every thread of a CTA and are served from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_AND = 0, OP_OR = 1, OP_XOR = 2 };

template <int OP>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  return a ^ b;
}

template <int VEC>
struct Words {
  uint32_t v[VEC];
  __device__ __forceinline__ void fill(uint32_t x) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = x;
  }
  __device__ __forceinline__ void load(const uint32_t* p) {
    if (VEC == 4) {
      uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
    }
  }
  __device__ __forceinline__ void store(uint32_t* p) const {
    if (VEC == 4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) p[i] = v[i];
    }
  }
};

template <int OP, int VEC>
__global__ void mws_gather_kernel(const uint32_t* __restrict__ src,
                                  const uint32_t* __restrict__ ext,
                                  const uint32_t* __restrict__ shr,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int K, int N,
                                  long long W, int m_ext, int outer_or,
                                  int invert) {
  const long long w0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (w0 >= W) return;
  const int row_out = blockIdx.y;  // b (outer OR) or b * K + k
  const int b = outer_or ? row_out : row_out / K;
  const int k_begin = outer_or ? 0 : row_out % K;
  const int k_end = outer_or ? K : k_begin + 1;
  const uint32_t ident = OP == OP_AND ? 0xFFFFFFFFu : 0u;

  Words<VEC> acc_out;
  acc_out.fill(0u);
  for (int k = k_begin; k < k_end; ++k) {
    const int32_t* ix = idx + ((long long)b * K + k) * N;
    Words<VEC> acc;
    acc.fill(ident);
    for (int n = 0; n < N; ++n) {
      const int r = __ldg(ix + n);
      const uint32_t* row;
      if (r >= 0) {
        row = src + (long long)r * W;
      } else {
        const int j = -1 - r;
        row = j < m_ext ? ext + ((long long)b * m_ext + j) * W
                        : shr + (long long)(j - m_ext) * W;
      }
      Words<VEC> x;
      x.load(row + w0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc.v[i] = fold<OP>(acc.v[i], x.v[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_out.v[i] |= acc.v[i];
  }
  if (invert) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_out.v[i] = ~acc_out.v[i];
  }
  acc_out.store(out + (long long)row_out * W + w0);
}

template <int OP, int VEC>
cudaError_t launch(const uint32_t* src, const uint32_t* ext,
                   const uint32_t* shr, const int32_t* idx, uint32_t* out,
                   int B, int K, int N, long long W, int m_ext, int outer_or,
                   int invert, cudaStream_t stream) {
  const int threads = 256;
  const long long groups = (W + VEC - 1) / VEC;
  dim3 grid((unsigned)((groups + threads - 1) / threads),
            (unsigned)(outer_or ? B : B * K));
  mws_gather_kernel<OP, VEC><<<grid, threads, 0, stream>>>(
      src, ext, shr, idx, out, K, N, W, m_ext, outer_or, invert);
  return cudaGetLastError();
}

}  // namespace

// op: 0 = AND, 1 = OR, 2 = XOR.  vec: 4 (W % 4 == 0, 16-byte aligned
// bases) or 1.  Returns the launch's cudaError_t (0 on success).
extern "C" int mws_gather_launch(const void* src, const void* ext,
                                 const void* shr, const void* idx, void* out,
                                 int B, int K, int N, long long W, int m_ext,
                                 int op, int outer_or, int invert, int vec,
                                 void* stream) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  const uint32_t* e = static_cast<const uint32_t*>(ext);
  const uint32_t* h = static_cast<const uint32_t*>(shr);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    switch (op) {
      case OP_AND: return launch<OP_AND, 4>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
      case OP_OR: return launch<OP_OR, 4>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
      case OP_XOR: return launch<OP_XOR, 4>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
    }
  } else if (vec == 1) {
    switch (op) {
      case OP_AND: return launch<OP_AND, 1>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
      case OP_OR: return launch<OP_OR, 1>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
      case OP_XOR: return launch<OP_XOR, 1>(s, e, h, ix, o, B, K, N, W, m_ext, outer_or, invert, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
