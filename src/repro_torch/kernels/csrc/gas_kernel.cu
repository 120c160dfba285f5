// GAS tile kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the reference package's Pallas body
// repro/kernels/gas_kernel.py::make_gas_kernel (launched through
// gas_pallas_call / gas_pallas_call_segmented). The design note and the
// bound are in repro_torch/kernels/gas_kernel.py.
//
// Pass 1 (gas_chunk_kernel): one CTA per chunk of at most kChunkBlocks
// blocks of one output tile; chunks are counted from the tile's first
// block (tile_chunk_start), so every boundary depends on the tile alone.
// The CTA streams its chunk's edge slots in rounds of kEdgesPerRound per
// thread: valid first, then src/dst/weight and the gather for live slots
// only.
// Each warp combines its 32 slots of a round at once (fold_warp): a slot
// no other lane shares is folded by its lane; lanes that share a slot
// reduce over a fixed lane-order tree of shuffles, and the group's lowest
// lane folds the total into the warp's own accumulator in shared memory.
// A warp whose slots are all pads skips the step after its ballot. One
// barrier per chunk, then the warps' accumulators merge in warp order
// into the tile (one chunk) or into the chunk's scratch row (several).
// Pass 2 (gas_combine_kernel): for tiles of several chunks, each slot
// combines its scratch rows in chunk order.
// No atomics anywhere: the order of every fp32 combine depends only on
// the tile's blocks and their tile-relative positions, so results are
// bit-stable and the fused and per-entry launch forms agree bit for bit.
//
// Scatter ops: the named ops copy and add_weight, and kCustom, a user's
// scatter UDF that kernels/udf_codegen.py traced into the expression
// GAS_SCATTER_EXPR(p, w). A build that defines it (with GAS_SCATTER_MODE,
// the app's gather mode, and GAS_SCATTER_USES_W) holds that one variant
// only; the named ops are the library built without it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gas_udf.cuh"

#ifndef GAS_CHUNK_BLOCKS
#define GAS_CHUNK_BLOCKS 16
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerRound = 4;         // edge slots of a thread per round
// 8 CTAs of 256 threads fill an SM's 2048 threads: pass 1 is held to 32
// registers so that they fit (more warps hide more load latency; faster
// on the card than 40 registers and 6 CTAs)
constexpr int kChunkCtasPerSm = 8;
constexpr int kChunkBlocks = GAS_CHUNK_BLOCKS;
constexpr int kMaxEBlk = 1024;
constexpr size_t kMaxSmem = 232448;       // a CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kSum = 0, kMin = 1, kMax = 2, kOr = 3 };
enum ScatterOp { kCopy = 0, kAddWeight = 1, kCustom = 2 };

#ifndef GAS_SCATTER_USES_W
#define GAS_SCATTER_USES_W 1
#endif

// whether a scatter op reads the edge weight
template <int OP>
constexpr bool kReadsWeight =
    OP == kAddWeight || (OP == kCustom && GAS_SCATTER_USES_W);

template <int MODE, typename V>
struct Combine;

template <>
struct Combine<kSum, float> {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return a + b;
  }
};

template <>
struct Combine<kMin, float> {
  static __device__ __forceinline__ float identity() { return 3.0e38f; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return fminf(a, b);
  }
};

template <>
struct Combine<kMax, float> {
  static __device__ __forceinline__ float identity() { return -3.0e38f; }
  static __device__ __forceinline__ float apply(float a, float b) {
    return fmaxf(a, b);
  }
};

template <>
struct Combine<kOr, int> {
  static __device__ __forceinline__ int identity() { return 0; }
  static __device__ __forceinline__ int apply(int a, int b) { return a | b; }
};

template <int OP, typename V>
__device__ __forceinline__ V scatter_op(V p, float w) {
  if constexpr (OP == kAddWeight) {
    return p + w;
#ifdef GAS_SCATTER_EXPR
  } else if constexpr (OP == kCustom) {
    return static_cast<V>(GAS_SCATTER_EXPR(p, w));
#endif
  } else {
    return p;
  }
}

// Combines the values of the live lanes of each group `grp` (the lanes
// with this lane's destination) over a fixed tree: at half-width s, the
// lowest member of each aligned 2s-lane window takes the partial of the
// lowest member of the window's upper half. The group's lowest lane ends
// with the total. Every lane of the warp must call it.
template <int MODE, typename V>
__device__ __forceinline__ V group_reduce(unsigned grp, bool live, V v,
                                          int lane) {
  bool holder = live;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int from = lane;
    if (holder) {
      const unsigned half = (1u << s) - 1u;
      const int base = lane & ~(2 * s - 1);
      if ((lane & s) == 0) {
        const unsigned upper = grp & (half << (base + s));
        if (upper) from = __ffs(upper) - 1;
      } else if (grp & (half << base)) {
        holder = false;
      }
    }
    const V other = __shfl_sync(kFull, v, from);
    if (from != lane) v = Combine<MODE, V>::apply(v, other);
  }
  return v;
}

// Folds this warp's 32 edge slots into its accumulator. Each live lane
// writes its lane id to tag[d]; one write per slot lands, so a lane that
// reads back another id shares its slot. With no shared slot (most Big
// blocks), every live lane folds its own value. Otherwise lanes are
// grouped by slot (__match_any_sync), each group combines over the fixed
// tree of group_reduce, and the group's lowest lane folds the total.
// Every lane of the warp must call it.
template <int MODE, typename V>
__device__ __forceinline__ void fold_warp(V* acc, unsigned char* tag,
                                          bool live, int d, V v, int lane) {
  if (live) tag[d] = static_cast<unsigned char>(lane);
  __syncwarp();
  if (__any_sync(kFull, live && tag[d] != lane)) {
    // pads get keys no slot has, so they form groups of their own
    const unsigned grp = __match_any_sync(kFull, live ? d : -1 - lane);
    v = group_reduce<MODE, V>(grp, live, v, lane);
    live = live && (grp & ((1u << lane) - 1u)) == 0;
  }
  if (live) acc[d] = Combine<MODE, V>::apply(acc[d], v);
  __syncwarp();
}

template <int MODE, int OP, typename V>
__global__ void __launch_bounds__(kThreads, kChunkCtasPerSm)
gas_chunk_kernel(const V* __restrict__ vwin,
                 const int* __restrict__ src_local,
                 const int* __restrict__ dst_local,
                 const float* __restrict__ weights,
                 const int* __restrict__ valid,
                 const int* __restrict__ window_id,
                 const int* __restrict__ tile_block_start,
                 const int* __restrict__ tile_chunk_start,
                 V* __restrict__ out, V* __restrict__ scratch,
                 int n_out_tiles, int e_blk, int w, int t) {
  using C = Combine<MODE, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* accs = reinterpret_cast<V*>(smem);                         // [kWarps][t]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  V* acc = accs + warp * t;                    // this warp's accumulator
  unsigned char* tag = reinterpret_cast<unsigned char*>(accs + kWarps * t) +
                       warp * t;               // this warp's slot tags

  // the grid is an upper bound on the chunk count
  const int chunk = blockIdx.x;
  if (chunk >= tile_chunk_start[n_out_tiles]) return;
  int lo = 0, hi = n_out_tiles - 1;           // last tile starting <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_chunk_start[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int tile = lo;
  const int c0 = tile_chunk_start[tile];
  const int b0 = tile_block_start[tile] + (chunk - c0) * kChunkBlocks;
  const int b1 = min(b0 + kChunkBlocks, tile_block_start[tile + 1]);

  for (int s = lane; s < t; s += 32) acc[s] = C::identity();
  __syncwarp();

  const int64_t e0 = static_cast<int64_t>(b0) * e_blk;
  const int n_slots = (b1 - b0) * e_blk;
  for (int r = 0; r < n_slots; r += kThreads * kEdgesPerRound) {
    // a round: kEdgesPerRound slots per thread, kThreads apart, so a
    // warp holds 32 neighbouring slots for each k
    bool live[kEdgesPerRound];
#pragma unroll
    for (int k = 0; k < kEdgesPerRound; ++k) {
      const int slot = r + k * kThreads + threadIdx.x;
      live[k] = slot < n_slots && valid[e0 + slot] != 0;
    }
    int dst[kEdgesPerRound];
    V val[kEdgesPerRound];
#pragma unroll
    for (int k = 0; k < kEdgesPerRound; ++k) {
      dst[k] = 0;
      val[k] = C::identity();
      if (live[k]) {                          // pads load nothing more
        const int slot = r + k * kThreads + threadIdx.x;
        const V* win = vwin + static_cast<int64_t>(
            window_id[b0 + slot / e_blk]) * w;
        dst[k] = dst_local[e0 + slot];
        val[k] = scatter_op<OP, V>(
            win[src_local[e0 + slot]],
            kReadsWeight<OP> ? weights[e0 + slot] : 0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerRound; ++k) {
      if (__ballot_sync(kFull, live[k]) == 0) continue;   // all pads
      fold_warp<MODE, V>(acc, tag, live[k], dst[k], val[k], lane);
    }
  }

  __syncthreads();
  const bool one_chunk = tile_chunk_start[tile + 1] - c0 == 1;
  V* dest = one_chunk ? out + static_cast<int64_t>(tile) * t
                      : scratch + static_cast<int64_t>(chunk) * t;
  for (int s = threadIdx.x; s < t; s += kThreads) {
    V v = accs[s];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) v = C::apply(v, accs[wp * t + s]);
    dest[s] = v;
  }
}

// Tiles of several chunks: slot s of tile k combines scratch rows
// tile_chunk_start[k] .. tile_chunk_start[k + 1] in chunk order.
template <int MODE, typename V>
__global__ void __launch_bounds__(kThreads)
gas_combine_kernel(const V* __restrict__ scratch,
                   const int* __restrict__ tile_chunk_start,
                   V* __restrict__ out, int t) {
  const int tile = blockIdx.x;
  const int s = blockIdx.y * kThreads + threadIdx.x;
  const int c0 = tile_chunk_start[tile];
  const int n = tile_chunk_start[tile + 1] - c0;
  if (n < 2 || s >= t) return;
  const V* p = scratch + static_cast<int64_t>(c0) * t + s;
  V v = p[0];
#pragma unroll 16
  for (int c = 1; c < n; ++c) {
    v = Combine<MODE, V>::apply(v, p[static_cast<int64_t>(c) * t]);
  }
  out[static_cast<int64_t>(tile) * t + s] = v;
}

template <int MODE, int OP, typename V>
int launch(const void* vwin, const void* src_local, const void* dst_local,
           const void* weights, const void* valid, const void* window_id,
           const void* tile_block_start, const void* tile_chunk_start,
           void* out, void* scratch, int n_out_tiles, int n_chunks,
           int e_blk, int w, int t, cudaStream_t stream) {
  // per warp: an accumulator and a one-byte tag for each of the t slots
  const size_t smem = static_cast<size_t>(kWarps) * t * (sizeof(V) + 1);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gas_chunk_kernel<MODE, OP, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gas_chunk_kernel<MODE, OP, V><<<n_chunks, kThreads, smem, stream>>>(
      static_cast<const V*>(vwin), static_cast<const int*>(src_local),
      static_cast<const int*>(dst_local),
      static_cast<const float*>(weights), static_cast<const int*>(valid),
      static_cast<const int*>(window_id),
      static_cast<const int*>(tile_block_start),
      static_cast<const int*>(tile_chunk_start), static_cast<V*>(out),
      static_cast<V*>(scratch), n_out_tiles, e_blk, w, t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_out_tiles, (t + kThreads - 1) / kThreads);
  gas_combine_kernel<MODE, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(scratch),
      static_cast<const int*>(tile_chunk_start), static_cast<V*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chunk size this library was built with; tile_chunk_start must be
// counted with it.
int gas_chunk_blocks() { return kChunkBlocks; }

// Returns 0 on success, else a cudaError_t code (the first
// cudaGetLastError() of the two launches that is not 0), or
// cudaErrorInvalidValue for a combination the kernel does not take.
// n_chunks is the grid of pass 1: at least tile_chunk_start[n_out_tiles]
// (CTAs past it exit); scratch holds n_chunks rows of t values. The
// caller checks shapes, dtypes, devices and contiguity before calling.
int gas_launch(int mode, int scatter, const void* vwin,
               const void* src_local, const void* dst_local,
               const void* weights, const void* valid,
               const void* window_id, const void* tile_block_start,
               const void* tile_chunk_start, void* out, void* scratch,
               int n_out_tiles, int n_chunks, int e_blk, int w, int t,
               void* stream) {
  if (n_out_tiles <= 0) return 0;
  if (n_chunks < n_out_tiles || e_blk <= 0 || e_blk > kMaxEBlk || w <= 0 ||
      t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* a[] = {vwin, src_local, dst_local, weights, valid, window_id,
                     tile_block_start, tile_chunk_start};
#define GAS_ARGS a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], out, \
                 scratch, n_out_tiles, n_chunks, e_blk, w, t, s
#ifdef GAS_SCATTER_EXPR
  if (scatter != kCustom || mode != GAS_SCATTER_MODE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if GAS_SCATTER_MODE == 3
  return launch<kOr, kCustom, int>(GAS_ARGS);
#else
  return launch<GAS_SCATTER_MODE, kCustom, float>(GAS_ARGS);
#endif
#else
  switch (mode * 2 + scatter) {
    case kSum * 2 + kCopy: return launch<kSum, kCopy, float>(GAS_ARGS);
    case kSum * 2 + kAddWeight:
      return launch<kSum, kAddWeight, float>(GAS_ARGS);
    case kMin * 2 + kCopy: return launch<kMin, kCopy, float>(GAS_ARGS);
    case kMin * 2 + kAddWeight:
      return launch<kMin, kAddWeight, float>(GAS_ARGS);
    case kMax * 2 + kCopy: return launch<kMax, kCopy, float>(GAS_ARGS);
    case kMax * 2 + kAddWeight:
      return launch<kMax, kAddWeight, float>(GAS_ARGS);
    case kOr * 2 + kCopy: return launch<kOr, kCopy, int>(GAS_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
#undef GAS_ARGS
}

}  // extern "C"
