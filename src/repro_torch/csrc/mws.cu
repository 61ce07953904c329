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
// Bound: memory.  The least a launch must move is each distinct row it
// names read once and each output row written once:
// (distinct + B*m_ext + m_shr + outputs) * 4 * W bytes over 3.35 TB/s of
// HBM on an H100 SXM.  There is no arithmetic to speak of (one logic op
// per word read).
//
// Two variants, chosen by the wrapper from shapes alone
// (kernels/mws/ops.py:choose_variant):
//
// * streaming (mws_gather_kernel): one thread per 16-byte group of 4
//   words along W (plain 4-byte words when W or a base pointer is not
//   16-byte aligned); grid.x walks the column groups, grid.y the output
//   rows.  The K x N fold lives in registers; every named row is read
//   once per output word, so a row named by many plans is read many
//   times.  It runs where no row can repeat: one output row (a single
//   plan, mws_reduce's identity indices) or outputs that each fold one
//   spill row of their own.
//
// * staged (mws_staged_kernel): one persistent CTA of 1,024 threads per
//   SM owns a column tile of T words and computes every output row of the
//   launch for it.  Each CTA first finds the launch's distinct stageable
//   rows (the slots and shared rows that idx names) from idx itself, so
//   the flush adds no host sync, and turns every (output, block,
//   wordline) entry into the row's offset in a stage.  Then it walks its
//   tiles with two shared-memory stages: one warp issues a TMA 1-D bulk
//   copy (cp.async.bulk, completion on an mbarrier) per distinct row for
//   tile t+1 while all threads fold tile t from shared memory, one output
//   word group per thread, and write it with 16-byte evict-first stores.
//   A row shared by many plans is read from HBM once per tile.  Per-plan
//   spill rows (ext) are read once anyway, straight from global memory.
//   T adapts on the device to the distinct count, so a stage stays about
//   48 KiB whatever the launch names.  It needs W a multiple of 4 and
//   16-byte aligned bases (the serving path's pages always are); the
//   wrapper sends any other launch to the streaming kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

enum { OP_AND = 0, OP_OR = 1, OP_XOR = 2 };
enum { VARIANT_STREAMING = 0, VARIANT_STAGED = 1 };

// The staged variant's shared memory: a 128-byte header (two mbarriers
// and the distinct count), two stages, the entry table, then the name ->
// stage position map and the stage position -> name list.  Mirrored in
// kernels/mws/ops.py (staged_fits).
constexpr int kStagedThreads = 1024;     // one CTA per SM: 32 warps fold
constexpr int kHeaderBytes = 128;
constexpr int kTileQuantum = 128;        // words; a tile is a multiple
constexpr int kMaxTile = 4096;           // words per row per tile
constexpr int kStageWords = 12288;       // at least 48 KiB a stage
constexpr int kTableEntries = 2048;      // (output, block, wordline) entries
constexpr int kMaxSmemBytes = 232448;    // what one block may use (227 KB)
constexpr int kMaxDevices = 64;

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
  __device__ __forceinline__ void load_shared(const uint32_t* p) {
    if (VEC == 4) {
      uint4 q = *reinterpret_cast<const uint4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = p[i];
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
  // evict-first: a stream of output rows that no later read of this
  // kernel needs in the L2
  __device__ __forceinline__ void store_streaming(uint32_t* p) const {
    if (VEC == 4) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) __stcs(p + i, v[i]);
    }
  }
};

// -- streaming -------------------------------------------------------------

template <int OP, int VEC>
__global__ void mws_gather_kernel(const uint32_t* __restrict__ src,
                                  const uint32_t* __restrict__ ext,
                                  const uint32_t* __restrict__ shr,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int K, int N,
                                  long long W, int m_ext, int outer_or,
                                  int invert) {
  const long long w0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (w0 >= W) return;
  const int row_out = blockIdx.y;  // b, or b * K + k
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
cudaError_t launch_streaming(const uint32_t* src, const uint32_t* ext,
                             const uint32_t* shr, const int32_t* idx,
                             uint32_t* out, int B, int K, int N, long long W,
                             int m_ext, int outer_or, int invert,
                             cudaStream_t stream) {
  const int threads = 256;
  const long long groups = (W + VEC - 1) / VEC;
  const long long col_blocks = (groups + threads - 1) / threads;
  const dim3 grid((unsigned)col_blocks, (unsigned)(outer_or ? B : B * K));
  mws_gather_kernel<OP, VEC><<<grid, threads, 0, stream>>>(
      src, ext, shr, idx, out, K, N, W, m_ext, outer_or, invert);
  return cudaGetLastError();
}

// -- staged ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA 1-D bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int OP>
__global__ void __launch_bounds__(kStagedThreads)
    mws_staged_kernel(const uint32_t* __restrict__ src,
                      const uint32_t* __restrict__ ext,
                      const uint32_t* __restrict__ shr,
                      const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int S, int B, int K, int N,
                      long long W, int m_ext, int m_shr, int outer_or,
                      int invert, int stage_words, int table_entries) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* distinct = reinterpret_cast<int*>(smem + 16);
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem + kHeaderBytes);
  int* table = reinterpret_cast<int*>(stages + 2 * stage_words);
  const int names_n = S + m_shr;  // slots 0..S-1, then the shared rows
  int* pos_of = table + table_entries;
  int* name_at = pos_of + names_n;
  const int tid = threadIdx.x;

  // 1. The distinct rows idx names, from idx itself (every CTA builds the
  //    same map; B*K*N words of idx are a few hundred bytes on the path).
  for (int i = tid; i < names_n; i += kStagedThreads) pos_of[i] = 0;
  __syncthreads();
  const long long entries = (long long)B * K * N;
  for (long long e = tid; e < entries; e += kStagedThreads) {
    const int r = __ldg(idx + e);
    const int name = r >= 0 ? r : (-1 - r >= m_ext ? S + (-1 - r - m_ext) : -1);
    if (name >= 0 && name < names_n) pos_of[name] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int d = 0;
    for (int i = 0; i < names_n; ++i) {
      if (pos_of[i]) {
        name_at[d] = i;
        pos_of[i] = d++;
      }
    }
    *distinct = d;
    mbar_init(smem_addr(&bars[0]));
    mbar_init(smem_addr(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int D = *distinct;

  // 2. The tile: as wide as a stage holds for D rows (the launcher sizes
  //    the stage for kTileQuantum words of every row idx could name), at
  //    most kMaxTile.
  int T = D ? stage_words / D / kTileQuantum * kTileQuantum : kMaxTile;
  if (T > kMaxTile) T = kMaxTile;
  const long long ntiles = (W + T - 1) / T;

  // 3. The entry table: for each (output, block, wordline) the word offset
  //    of its row in a stage, or -1 - j for spill row j of the output's
  //    plan.  It replaces the idx -> map -> stage chain of loads in the
  //    fold by one shared-memory load.  Outputs come in chunks of at most
  //    table_entries entries (one chunk on the serving path).  The size
  //    arrives as an argument: as a compile-time constant the kernel ran
  //    far slower on the H100 at the same instruction mix (cause unknown).
  const int per_block = outer_or ? K : 1;  // blocks folded into one output
  const int per_out = per_block * N;      // entries per output row
  const int n_out = outer_or ? B : B * K;
  const int chunk = table_entries / per_out;
  const int n_chunks = (n_out + chunk - 1) / chunk;
  auto fill = [&](int o0, int o1) {
    for (int e = o0 * per_out + tid; e < o1 * per_out; e += kStagedThreads) {
      const int r = __ldg(idx + e);
      const int j = -1 - r;
      table[e - o0 * per_out] =
          r >= 0 ? pos_of[r] * T : (j < m_ext ? r : pos_of[S + j - m_ext] * T);
    }
  };
  if (n_chunks == 1) fill(0, n_out);

  auto row_of = [&](int name) -> const uint32_t* {
    return name < S ? src + (long long)name * W : shr + (long long)(name - S) * W;
  };

  // Fill stage `s` with tile t of every distinct row (W % 4 == 0, so a
  // tile's bytes are a multiple of 16).
  auto issue = [&](long long t, int s) {
    if (tid >= 32) return;
    const long long t0 = t * T;
    const int len = (int)(W - t0 < T ? W - t0 : T);
    uint32_t* dst = stages + (long long)s * stage_words;
    const uint32_t bar = smem_addr(&bars[s]);
    if (tid == 0) mbar_expect(bar, (uint32_t)D * len * 4u);
    __syncwarp();
    // the stage was last read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int p = tid; p < D; p += 32)
      bulk_copy(smem_addr(dst + p * T), row_of(name_at[p]) + t0, len * 4u, bar);
  };

  const uint32_t ident = OP == OP_AND ? 0xFFFFFFFFu : 0u;

  // 4. Two stages: tile j + 1 loads while tile j folds.
  long long t = blockIdx.x;
  if (t < ntiles) issue(t, 0);
  for (int j = 0; t < ntiles; ++j, t += gridDim.x) {
    const int s = j & 1;
    const long long t_next = t + gridDim.x;
    if (t_next < ntiles) issue(t_next, s ^ 1);
    mbar_wait(smem_addr(&bars[s]), (uint32_t)(j >> 1) & 1u);

    const long long t0 = t * T;
    const int len = (int)(W - t0 < T ? W - t0 : T);
    const int groups = len / 4;
    const uint32_t* stage = stages + (long long)s * stage_words;
    for (int c = 0; c < n_chunks; ++c) {
      const int o0 = c * chunk;
      const int o1 = o0 + chunk < n_out ? o0 + chunk : n_out;
      if (n_chunks > 1) {
        __syncthreads();  // the previous chunk's table is read
        fill(o0, o1);
      }
      __syncthreads();  // the table is visible
      for (int item = tid; item < (o1 - o0) * groups; item += kStagedThreads) {
        const int ol = item / groups;
        const int g = (item - ol * groups) * 4;
        const int o = o0 + ol;
        const int* entry = table + ol * per_out;
        Words<4> acc_out;
        acc_out.fill(0u);
        for (int k = 0; k < per_block; ++k) {
          Words<4> acc;
          acc.fill(ident);
          for (int n = 0; n < N; ++n) {
            const int v = entry[k * N + n];
            Words<4> x;
            if (v >= 0) {
              x.load_shared(stage + v + g);
            } else {
              const int b = outer_or ? o : o / K;
              x.load(ext + ((long long)b * m_ext + (-1 - v)) * W + t0 + g);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc.v[i] = fold<OP>(acc.v[i], x.v[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_out.v[i] |= acc.v[i];
        }
        if (invert) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_out.v[i] = ~acc_out.v[i];
        }
        acc_out.store_streaming(out + (long long)o * W + t0 + g);
      }
    }
    __syncthreads();  // every thread is done with stage s before its refill
  }
}

// Shared memory of the staged variant, or 0 when it does not fit one
// block: room for kTileQuantum words of every row the launch could stage
// (the snapshot slots and shared rows, or its entries if fewer).
long long staged_smem_bytes(int S, int m_shr, long long entries, int* stage_words) {
  const long long rows = (S < entries ? S : entries) + m_shr;
  const long long need = rows * kTileQuantum;
  const long long words = need > kStageWords ? need : kStageWords;
  const long long bytes =
      kHeaderBytes + 2 * words * 4 + 4LL * kTableEntries + 2LL * (S + m_shr) * 4;
  if (bytes > kMaxSmemBytes) return 0;
  *stage_words = (int)words;
  return bytes;
}

// The CTAs of one wave of mws_staged_kernel<OP> at `smem` bytes on the
// current device.  The function attribute, the SM count and the occupancy
// are asked of the runtime once per device and size: on a flush whose
// time the host sets, four runtime calls a launch would cost more than
// the staging saves.
template <int OP>
cudaError_t staged_wave(long long smem, long long* ctas) {
  static std::mutex mu;
  static int smem_raised[kMaxDevices];  // the max dynamic smem set so far
  static std::map<std::pair<int, long long>, long long> wave;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  auto kernel = mws_staged_kernel<OP>;
  if (smem > smem_raised[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)))
      return err;
    smem_raised[dev] = (int)smem;
  }
  auto it = wave.find({dev, smem});
  if (it == wave.end()) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kStagedThreads, (size_t)smem)))
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = wave.emplace(std::make_pair(dev, smem), (long long)per_sm * sms).first;
  }
  *ctas = it->second;
  return cudaSuccess;
}

template <int OP>
cudaError_t launch_staged(const uint32_t* src, const uint32_t* ext,
                          const uint32_t* shr, const int32_t* idx,
                          uint32_t* out, int S, int B, int K, int N,
                          long long W, int m_ext, int m_shr, int outer_or,
                          int invert, cudaStream_t stream) {
  int stage_words = 0;
  const long long smem = staged_smem_bytes(S, m_shr, (long long)B * K * N, &stage_words);
  if (!smem || (outer_or ? K : 1) * N > kTableEntries) return cudaErrorInvalidValue;
  long long ctas = 0;
  cudaError_t err = staged_wave<OP>(smem, &ctas);
  if (err) return err;
  // persistent: at most one wave, and no more CTAs than the narrowest
  // tiling has tiles
  const long long max_tiles = (W + kTileQuantum - 1) / kTileQuantum;
  const unsigned grid = (unsigned)(ctas < max_tiles ? ctas : max_tiles);
  mws_staged_kernel<OP><<<grid, kStagedThreads, (size_t)smem, stream>>>(
      src, ext, shr, idx, out, S, B, K, N, W, m_ext, m_shr, outer_or, invert,
      stage_words, kTableEntries);
  return cudaGetLastError();
}

template <int OP, int VEC>
cudaError_t launch(int variant, const uint32_t* src, const uint32_t* ext,
                   const uint32_t* shr, const int32_t* idx, uint32_t* out,
                   int S, int B, int K, int N, long long W, int m_ext,
                   int m_shr, int outer_or, int invert, cudaStream_t stream) {
  if (variant == VARIANT_STREAMING)
    return launch_streaming<OP, VEC>(src, ext, shr, idx, out, B, K, N, W, m_ext,
                                     outer_or, invert, stream);
  if constexpr (VEC == 4) {
    if (variant == VARIANT_STAGED)
      return launch_staged<OP>(src, ext, shr, idx, out, S, B, K, N, W, m_ext, m_shr,
                               outer_or, invert, stream);
  }
  return cudaErrorInvalidValue;
}

template <int VEC>
cudaError_t launch_op(int op, int variant, const uint32_t* src,
                      const uint32_t* ext, const uint32_t* shr,
                      const int32_t* idx, uint32_t* out, int S, int B, int K,
                      int N, long long W, int m_ext, int m_shr, int outer_or,
                      int invert, cudaStream_t stream) {
  switch (op) {
    case OP_AND:
      return launch<OP_AND, VEC>(variant, src, ext, shr, idx, out, S, B, K, N, W,
                                 m_ext, m_shr, outer_or, invert, stream);
    case OP_OR:
      return launch<OP_OR, VEC>(variant, src, ext, shr, idx, out, S, B, K, N, W,
                                m_ext, m_shr, outer_or, invert, stream);
    case OP_XOR:
      return launch<OP_XOR, VEC>(variant, src, ext, shr, idx, out, S, B, K, N, W,
                                 m_ext, m_shr, outer_or, invert, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// S: rows of src; m_ext: ext rows per batch row; m_shr: shared rows.
// op: 0 = AND, 1 = OR, 2 = XOR.  vec: 4 (W % 4 == 0, 16-byte aligned
// bases) or 1.  variant: 0 = streaming, 1 = staged (vec 4 only).
// Returns the launch's cudaError_t (0 on success).
extern "C" int mws_gather_launch(const void* src, const void* ext,
                                 const void* shr, const void* idx, void* out,
                                 int S, int B, int K, int N, long long W,
                                 int m_ext, int m_shr, int op, int outer_or,
                                 int invert, int vec, int variant,
                                 void* stream) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  const uint32_t* e = static_cast<const uint32_t*>(ext);
  const uint32_t* h = static_cast<const uint32_t*>(shr);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N <= 0 || W <= 0 || S < 0 || m_ext < 0 || m_shr < 0)
    return (int)cudaErrorInvalidValue;
  if (vec == 4)
    return (int)launch_op<4>(op, variant, s, e, h, ix, o, S, B, K, N, W, m_ext,
                             m_shr, outer_or, invert, st);
  if (vec == 1)
    return (int)launch_op<1>(op, variant, s, e, h, ix, o, S, B, K, N, W, m_ext,
                             m_shr, outer_or, invert, st);
  return (int)cudaErrorInvalidValue;
}
