// 1-bit sign compression of gradients on Hopper (sm_90a): pack, unpack,
// and the per-bit majority vote of packed sign planes.
//
// Replaces: src/repro/kernels/signcomp/signcomp.py:pack_signs_pallas,
// unpack_signs_pallas and majority_pallas.
//
// Layout (the reference's): a flat vector of n floats is read as a
// (32*R, W) matrix, zero-padded to R = ceil(n / (32*W)) packed rows, and
// bit b of word (r, c) is x[(32*r + b)*W + c] >= 0.0f, read as the
// reference reads it: XLA (on the CPU and on the TPU) flushes subnormal
// inputs to zero, so a negative subnormal counts as -0.0 and gives 1.
// The test is therefore x > -FLT_MIN: -0.0 and -1e-45 give 1, -FLT_MIN
// and NaN give 0.
// Padded elements (index >= n) count as 0.0, so they pack to 1; the
// kernels take n and never read or write past it, so a caller needs no
// padded copy of a multi-GB gradient.
//
// Bound: memory, for all three.  pack reads 4n bytes and writes n/8;
// unpack reads n/8 and writes 4n; majority reads 4*K*R*W and writes
// 4*R*W.  Their arithmetic (one compare/shift/or per element, or two
// logic ops per counter plane per input word) is far below the card's
// integer rate.
//
// Design: one thread per output word (per VEC = 4 words where W and the
// pointers allow 16-byte accesses).  The 32 elements of a word lie W
// apart, so the threads of a warp, on consecutive words of one row,
// read or write 32 contiguous runs: every access is coalesced.  The
// largest gradient leaf (starcoder2-3b's stacked MLP up-projection) has
// 1.13e9 elements, 69,120 packed rows and 4.5 GB of floats, past both a
// 65,535 grid-y limit and 32-bit offsets, so the grid is 1-D,
// grid-stride, and every index is 64-bit.  The majority counts votes in
// a vertical bit-sliced counter: P = ceil(log2(K+1)) 32-bit planes in
// registers, plane j holding bit j of all 32 bit positions' counts, so
// one input word is added by a ripple carry of two logic ops per plane
// (as threshold.cu counts).  The vote count >= ceil(K/2) is a borrow
// chain against that constant, one op per plane.  P is a template
// parameter: 3 (K <= 7), 4 (K <= 15), 8 (K <= 255) and 16 (K <= 65535).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr float kNegMinNormal = -1.17549435e-38f;  // -FLT_MIN

__device__ __forceinline__ uint32_t sign_bit(float v) {
  return (uint32_t)(v > kNegMinNormal);  // false for NaN
}

inline unsigned blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// VEC consecutive words of one packed row per thread (W % VEC == 0).
template <int VEC>
__global__ void pack_signs_kernel(const float* __restrict__ x,
                                  uint32_t* __restrict__ out, long long n,
                                  long long groups, long long W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * VEC;  // first word of the group
    const long long r = i / W;
    const long long base = r * 32 * W + (i - r * W);  // element of bit 0
    uint32_t word[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) word[v] = 0u;
    if (base + 31 * W + (VEC - 1) < n) {  // every element is real
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (VEC == 4) {
          const float4 q =
              __ldg(reinterpret_cast<const float4*>(x + base + b * W));
          word[0] |= sign_bit(q.x) << b;
          word[1 % VEC] |= sign_bit(q.y) << b;
          word[2 % VEC] |= sign_bit(q.z) << b;
          word[3 % VEC] |= sign_bit(q.w) << b;
        } else {
          word[0] |= sign_bit(__ldg(x + base + b * W)) << b;
        }
      }
    } else {  // the ragged tail: elements past n are 0.0
      for (int b = 0; b < 32; ++b) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const long long e = base + b * W + v;
          const float val = e < n ? __ldg(x + e) : 0.0f;
          word[v] |= sign_bit(val) << b;
        }
      }
    }
    if (VEC == 4) {
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(word[0], word[1 % VEC], word[2 % VEC], word[3 % VEC]);
    } else {
      out[i] = word[0];
    }
  }
}

template <int VEC>
__global__ void unpack_signs_kernel(const uint32_t* __restrict__ words,
                                    float* __restrict__ out, long long n,
                                    long long groups, long long W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * VEC;
    const long long r = i / W;
    const long long base = r * 32 * W + (i - r * W);
    if (base >= n) continue;  // a word made only of padding
    uint32_t word[VEC];
    if (VEC == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(words + i));
      word[0] = q.x;
      word[1 % VEC] = q.y;
      word[2 % VEC] = q.z;
      word[3 % VEC] = q.w;
    } else {
      word[0] = __ldg(words + i);
    }
    if (base + 31 * W + (VEC - 1) < n) {
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (VEC == 4) {
          float4 s;
          s.x = (word[0] >> b) & 1u ? 1.0f : -1.0f;
          s.y = (word[1 % VEC] >> b) & 1u ? 1.0f : -1.0f;
          s.z = (word[2 % VEC] >> b) & 1u ? 1.0f : -1.0f;
          s.w = (word[3 % VEC] >> b) & 1u ? 1.0f : -1.0f;
          *reinterpret_cast<float4*>(out + base + b * W) = s;
        } else {
          out[base + b * W] = (word[0] >> b) & 1u ? 1.0f : -1.0f;
        }
      }
    } else {  // only the first n elements exist in the output
      for (int b = 0; b < 32; ++b) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const long long e = base + b * W + v;
          if (e < n) out[e] = (word[v] >> b) & 1u ? 1.0f : -1.0f;
        }
      }
    }
  }
}

// Adds one word to a P-plane bit-sliced counter.
template <int P>
__device__ __forceinline__ void count_word(uint32_t (&c)[P], uint32_t carry) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const uint32_t t = c[j] & carry;
    c[j] ^= carry;
    carry = t;
  }
}

// Bit i of the result is 1 where count_i >= thr (thr < 2^P): the
// complement of the borrow out of count - thr.
template <int P>
__device__ __forceinline__ uint32_t at_least(const uint32_t (&c)[P], uint32_t thr) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j)
    borrow = (thr >> j) & 1u ? ~c[j] | borrow : ~c[j] & borrow;
  return ~borrow;
}

// stacks: K planes of `words` words; VEC words per thread (words % VEC
// == 0).  Ties (even K) vote 1: the threshold is ceil(K/2).
template <int P, int VEC>
__global__ void majority_kernel(const uint32_t* __restrict__ stacks,
                                uint32_t* __restrict__ out, int K,
                                long long groups, long long words) {
  const uint32_t thr = ((uint32_t)K + 1u) >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * VEC;
    uint32_t c[VEC][P];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int j = 0; j < P; ++j) c[v][j] = 0u;
    const uint32_t* p = stacks + i;
#pragma unroll 4
    for (int k = 0; k < K; ++k, p += words) {
      if (VEC == 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        count_word<P>(c[0], q.x);
        count_word<P>(c[1 % VEC], q.y);
        count_word<P>(c[2 % VEC], q.z);
        count_word<P>(c[3 % VEC], q.w);
      } else {
        count_word<P>(c[0], __ldg(p));
      }
    }
    if (VEC == 4) {
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(at_least<P>(c[0], thr), at_least<P>(c[1 % VEC], thr),
                     at_least<P>(c[2 % VEC], thr), at_least<P>(c[3 % VEC], thr));
    } else {
      out[i] = at_least<P>(c[0], thr);
    }
  }
}

template <int P>
cudaError_t launch_majority(const uint32_t* stacks, uint32_t* out, int K,
                            long long words, int vec, cudaStream_t st) {
  const long long groups = words / vec;
  if (vec == 4)
    majority_kernel<P, 4><<<blocks_for(groups), kThreads, 0, st>>>(stacks, out, K,
                                                                   groups, words);
  else
    majority_kernel<P, 1><<<blocks_for(groups), kThreads, 0, st>>>(stacks, out, K,
                                                                   groups, words);
  return cudaGetLastError();
}

}  // namespace

// x: n floats; out: R * W words.  vec: 4 (W % 4 == 0, both pointers
// 16-byte aligned) or 1.  Returns the cudaError_t (0 on success).
extern "C" int pack_signs_launch(const void* x, void* out, long long n,
                                 long long R, long long W, int vec,
                                 void* stream) {
  if (n < 0 || R <= 0 || W <= 0 || n > R * 32 * W || (vec != 1 && vec != 4) ||
      W % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long groups = R * W / vec;
  const float* xp = static_cast<const float*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  if (vec == 4)
    pack_signs_kernel<4><<<blocks_for(groups), kThreads, 0, st>>>(xp, op, n,
                                                                   groups, W);
  else
    pack_signs_kernel<1><<<blocks_for(groups), kThreads, 0, st>>>(xp, op, n,
                                                                   groups, W);
  return (int)cudaGetLastError();
}

// words: R * W words; out: the first n floats of the (32R, W) matrix.
extern "C" int unpack_signs_launch(const void* words, void* out, long long n,
                                   long long R, long long W, int vec,
                                   void* stream) {
  if (n < 0 || R <= 0 || W <= 0 || n > R * 32 * W || (vec != 1 && vec != 4) ||
      W % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long groups = R * W / vec;
  const uint32_t* wp = static_cast<const uint32_t*>(words);
  float* op = static_cast<float*>(out);
  if (vec == 4)
    unpack_signs_kernel<4><<<blocks_for(groups), kThreads, 0, st>>>(
        wp, op, n, groups, W);
  else
    unpack_signs_kernel<1><<<blocks_for(groups), kThreads, 0, st>>>(
        wp, op, n, groups, W);
  return (int)cudaGetLastError();
}

// stacks: K planes of `words` words each; out: `words` words.  vec: 4
// (words % 4 == 0, both pointers 16-byte aligned) or 1.
extern "C" int majority_launch(const void* stacks, void* out, int K,
                               long long words, int vec, void* stream) {
  if (K < 1 || K > 65535 || words <= 0 || (vec != 1 && vec != 4) || words % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* s = static_cast<const uint32_t*>(stacks);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (K <= 7) return (int)launch_majority<3>(s, o, K, words, vec, st);
  if (K <= 15) return (int)launch_majority<4>(s, o, K, words, vec, st);
  if (K <= 255) return (int)launch_majority<8>(s, o, K, words, vec, st);
  return (int)launch_majority<16>(s, o, K, words, vec, st);
}
