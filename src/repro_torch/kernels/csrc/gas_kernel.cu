// GAS tile kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the reference package's Pallas body
// repro/kernels/gas_kernel.py::make_gas_kernel (launched through
// gas_pallas_call / gas_pallas_call_segmented). The design note and the
// bound are in repro_torch/kernels/gas_kernel.py.
//
// The kernel reads a payload's live-edge stream (kernels/ops.py derives
// it from the padded blocks' `valid` when the payload is uploaded): per
// live edge its source, an index into vwin, its slot in the output tile
// and its weight, in slot order; tile k owns edges
// tile_edge_start[k] .. tile_edge_start[k + 1]. No pad is read.
//
// Pass 1 (gas_chunk_kernel): one CTA per chunk of at most chunk_edges
// live edges of one output tile; chunks are counted from the tile's first
// live edge (tile_chunk_start; a tile with no live edge has one empty
// chunk), so every boundary depends on the tile alone. The CTA streams
// its chunk in rounds of kEdgesPerRound consecutive edges per thread
// (16-byte loads where the chunk's start allows them), gathers vwin at
// each source and applies the scatter op. The fold depends on the gather
// mode:
// - sum (ordered): each warp combines its 32 edges of a step at once
//   (fold_warp): an edge whose slot no other lane shares is folded by its
//   lane; lanes that share a slot reduce over a fixed lane-order tree of
//   shuffles, and the group's lowest lane folds the total into the warp's
//   own accumulator in shared memory. One barrier per chunk, then the
//   warps' accumulators merge in warp order into the tile (one chunk) or
//   into the chunk's scratch row (several). Pass 2 (gas_combine_kernel):
//   for tiles of several chunks, each slot combines its scratch rows in
//   chunk order.
// - min, max, or (exact): their result does not depend on the order, so
//   the CTA keeps one accumulator of t int32 in shared memory and each
//   live lane folds its edge with one shared-memory atomic (fold_exact),
//   a float as its order-preserving int image (Image). A step whose live
//   lanes all share one slot (a hub) reduces in the warp first and
//   issues one atomic.
//   A tile of one chunk is written straight from the accumulator; for a
//   tile of several, the launch first sets its row to the identity
//   (gas_identity_kernel) and each chunk folds its touched slots into it
//   with one atomic each in device memory: no scratch and no pass 2.
//
// Sum uses no float atomics: the order of every fp32 combine depends only
// on the tile's live edges and their tile-relative positions, so results
// are bit-stable and the fused, per-entry and sharded launch forms agree
// bit for bit. min, max and or fold with integer atomics on an
// order-preserving image, whose result is the same bits in any order.
//
// Scatter ops: the named ops copy and add_weight, and kCustom, a user's
// scatter UDF that kernels/udf_codegen.py traced into the expression
// GAS_SCATTER_EXPR(p, w). A build that defines it (with GAS_SCATTER_MODE,
// the app's gather mode, and GAS_SCATTER_USES_W) holds that one variant
// only; the named ops are the library built without it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gas_udf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerRound = 4;         // consecutive edges of a thread
// 8 CTAs of 256 threads fill an SM's 2048 threads: pass 1 is held to 32
// registers so that they fit (more warps hide more load latency; faster
// on the card than 40 registers and 6 CTAs)
constexpr int kChunkCtasPerSm = 8;
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

// Folds this warp's 32 edges of one step into its accumulator. Each live lane
// writes its lane id to tag[d]; one write per slot lands, so a lane that
// reads back another id shares its slot. With no shared slot (most Big
// steps), every live lane folds its own value. Otherwise lanes are
// grouped by slot (__match_any_sync), each group combines over the fixed
// tree of group_reduce, and the group's lowest lane folds the total.
// Every lane of the warp must call it.
template <int MODE, typename V>
__device__ __forceinline__ void fold_warp(V* acc, unsigned char* tag,
                                          bool live, int d, V v, int lane) {
  if (live) tag[d] = static_cast<unsigned char>(lane);
  __syncwarp();
  if (__any_sync(kFull, live && tag[d] != lane)) {
    // lanes without an edge get keys no slot has: groups of their own
    const unsigned grp = __match_any_sync(kFull, live ? d : -1 - lane);
    v = group_reduce<MODE, V>(grp, live, v, lane);
    live = live && (grp & ((1u << lane) - 1u)) == 0;
  }
  if (live) acc[d] = Combine<MODE, V>::apply(acc[d], v);
  __syncwarp();
}

// The exact modes' values as int32 whose signed order is the values'
// order: a float's bits with the low 31 flipped where the sign is set
// (monotone over every finite and infinite value; -0 sorts below +0, and
// NaNs beyond the infinities of their sign); an int as it is. The map is
// its own inverse.
template <typename V>
struct Image;

template <>
struct Image<float> {
  static __device__ __forceinline__ int to(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  static __device__ __forceinline__ float from(int i) {
    return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
  }
};

template <>
struct Image<int> {
  static __device__ __forceinline__ int to(int v) { return v; }
  static __device__ __forceinline__ int from(int i) { return i; }
};

template <int MODE>
__device__ __forceinline__ void atomic_fold(int* a, int v) {
  if constexpr (MODE == kMin) {
    atomicMin(a, v);
  } else if constexpr (MODE == kMax) {
    atomicMax(a, v);
  } else {
    atomicOr(a, v);
  }
}

template <int MODE>
__device__ __forceinline__ int warp_fold(int v) {
  if constexpr (MODE == kMin) {
    return __reduce_min_sync(kFull, v);
  } else if constexpr (MODE == kMax) {
    return __reduce_max_sync(kFull, v);
  } else {
    return static_cast<int>(__reduce_or_sync(kFull, static_cast<unsigned>(v)));
  }
}

// Folds this warp's 32 edges of one step (images; a lane without an edge
// holds the identity's) into the CTA's accumulator, in any order: each
// live lane issues one shared-memory atomic, and the hardware serialises
// lanes that share a slot. A step whose live lanes (`lanes`, not 0) all
// share one slot reduces in the warp and issues one atomic. Every lane of
// the warp must call it.
template <int MODE>
__device__ __forceinline__ void fold_exact(int* acc, unsigned lanes,
                                           bool live, int d, int v,
                                           int lane) {
  const int first = __ffs(lanes) - 1;
  const int d0 = __shfl_sync(kFull, d, first);
  if (__all_sync(kFull, !live || d == d0)) {
    v = warp_fold<MODE>(v);
    if (lane == first) atomic_fold<MODE>(acc + d0, v);
  } else if (live) {
    atomic_fold<MODE>(acc + d, v);
  }
}

// Folds v into *p in device memory in the exact modes' order, on the
// value's own bits: a float with the sign clear compares as a signed
// int, one with the sign set as an unsigned int in reverse, which is
// Image's order on the bits that p holds.
template <int MODE, typename V>
__device__ __forceinline__ void atomic_fold_out(V* p, V v) {
  if constexpr (MODE == kOr) {
    atomicOr(p, v);
  } else {
    const int b = __float_as_int(v);
    if (b >= 0) {
      atomic_fold<MODE>(reinterpret_cast<int*>(p), b);
    } else if constexpr (MODE == kMin) {
      atomicMax(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(b));
    } else {
      atomicMin(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(b));
    }
  }
}

// Whether 16-byte loads of p[i .. i + 4) are aligned.
template <typename T>
__device__ __forceinline__ bool aligned16(const T* p, int64_t i) {
  return (reinterpret_cast<uintptr_t>(p + i) & 15u) == 0;
}

template <int MODE, int OP, typename V>
__global__ void __launch_bounds__(kThreads, kChunkCtasPerSm)
gas_chunk_kernel(const V* __restrict__ vwin,
                 const int* __restrict__ edge_src,
                 const int* __restrict__ edge_dst,
                 const float* __restrict__ edge_w,
                 const int* __restrict__ tile_edge_start,
                 const int* __restrict__ tile_chunk_start,
                 V* __restrict__ out, V* __restrict__ scratch,
                 int n_out_tiles, int chunk_edges, int t) {
  using C = Combine<MODE, V>;
  constexpr bool kOrdered = MODE == kSum;
  extern __shared__ __align__(16) unsigned char smem[];
  // ordered: per warp an accumulator and a tag per slot; exact: one
  // accumulator of images for the CTA
  V* accs = reinterpret_cast<V*>(smem);                         // [kWarps][t]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  V* acc = accs + warp * t;                    // this warp's accumulator
  unsigned char* tag = reinterpret_cast<unsigned char*>(accs + kWarps * t) +
                       warp * t;               // this warp's slot tags
  int* img = reinterpret_cast<int*>(smem);                      // [t]

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
  const int64_t e0 = tile_edge_start[tile] +
                     static_cast<int64_t>(chunk - c0) * chunk_edges;
  const int64_t left = tile_edge_start[tile + 1] - e0;   // >= 0
  const int n = left < chunk_edges ? static_cast<int>(left) : chunk_edges;

  if constexpr (kOrdered) {
    for (int s = lane; s < t; s += 32) acc[s] = C::identity();
    __syncwarp();
  } else {
    for (int s = threadIdx.x; s < t; s += kThreads) {
      img[s] = Image<V>::to(C::identity());
    }
    __syncthreads();
  }

  // the same edges go to the same thread either way; only the width of
  // the loads depends on where the chunk lies in memory
  const bool wide = aligned16(edge_src, e0) && aligned16(edge_dst, e0) &&
                    (!kReadsWeight<OP> || aligned16(edge_w, e0));
  for (int r = 0; r < n; r += kThreads * kEdgesPerRound) {
    // a round: kEdgesPerRound consecutive edges per thread, threads in
    // order, so a warp's step k holds every kEdgesPerRound-th edge of
    // its 128
    const int base = r + threadIdx.x * kEdgesPerRound;
    const int64_t e = e0 + base;
    int src[kEdgesPerRound], dst[kEdgesPerRound];
    float wt[kEdgesPerRound];
    bool live[kEdgesPerRound];
    if (wide && base + kEdgesPerRound <= n) {
      const int4 s4 = __ldcs(reinterpret_cast<const int4*>(edge_src + e));
      const int4 d4 = __ldcs(reinterpret_cast<const int4*>(edge_dst + e));
      src[0] = s4.x; src[1] = s4.y; src[2] = s4.z; src[3] = s4.w;
      dst[0] = d4.x; dst[1] = d4.y; dst[2] = d4.z; dst[3] = d4.w;
      if constexpr (kReadsWeight<OP>) {
        const float4 w4 =
            __ldcs(reinterpret_cast<const float4*>(edge_w + e));
        wt[0] = w4.x; wt[1] = w4.y; wt[2] = w4.z; wt[3] = w4.w;
      }
#pragma unroll
      for (int k = 0; k < kEdgesPerRound; ++k) live[k] = true;
    } else {
#pragma unroll
      for (int k = 0; k < kEdgesPerRound; ++k) {
        live[k] = base + k < n;
        src[k] = live[k] ? __ldcs(edge_src + e + k) : 0;
        dst[k] = live[k] ? __ldcs(edge_dst + e + k) : 0;
        if constexpr (kReadsWeight<OP>) {
          wt[k] = live[k] ? __ldcs(edge_w + e + k) : 0.0f;
        }
      }
    }
    V val[kEdgesPerRound];
#pragma unroll
    for (int k = 0; k < kEdgesPerRound; ++k) {
      val[k] = live[k] ? scatter_op<OP, V>(
                             __ldg(vwin + src[k]),
                             kReadsWeight<OP> ? wt[k] : 0.0f)
                       : C::identity();
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerRound; ++k) {
      const unsigned lanes = __ballot_sync(kFull, live[k]);
      if (lanes == 0) continue;                            // past the end
      if constexpr (kOrdered) {
        fold_warp<MODE, V>(acc, tag, live[k], dst[k], val[k], lane);
      } else {
        fold_exact<MODE>(img, lanes, live[k], dst[k], Image<V>::to(val[k]),
                         lane);
      }
    }
  }

  __syncthreads();
  const bool one_chunk = tile_chunk_start[tile + 1] - c0 == 1;
  if constexpr (kOrdered) {
    V* dest = one_chunk ? out + static_cast<int64_t>(tile) * t
                        : scratch + static_cast<int64_t>(chunk) * t;
    for (int s = threadIdx.x; s < t; s += kThreads) {
      V v = accs[s];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) v = C::apply(v, accs[wp * t + s]);
      dest[s] = v;
    }
  } else {
    // a tile of several chunks: its row holds the identity
    // (gas_identity_kernel), and each chunk folds its touched slots in
    V* dest = out + static_cast<int64_t>(tile) * t;
    const int none = Image<V>::to(C::identity());
    for (int s = threadIdx.x; s < t; s += kThreads) {
      const int v = img[s];
      if (one_chunk) {
        dest[s] = Image<V>::from(v);
      } else if (v != none) {
        atomic_fold_out<MODE, V>(dest + s, Image<V>::from(v));
      }
    }
  }
}

// Exact modes, before pass 1: the rows of tiles of several chunks hold
// the identity.
template <int MODE, typename V>
__global__ void __launch_bounds__(kThreads)
gas_identity_kernel(const int* __restrict__ tile_chunk_start,
                    V* __restrict__ out, int t) {
  const int tile = blockIdx.x;
  const int s = blockIdx.y * kThreads + threadIdx.x;
  if (tile_chunk_start[tile + 1] - tile_chunk_start[tile] < 2 || s >= t) {
    return;
  }
  out[static_cast<int64_t>(tile) * t + s] = Combine<MODE, V>::identity();
}

// Sum, tiles of several chunks: slot s of tile k combines scratch rows
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
int launch(const void* vwin, const void* edge_src, const void* edge_dst,
           const void* edge_w, const void* tile_edge_start,
           const void* tile_chunk_start, void* out, void* scratch,
           int n_out_tiles, int n_chunks, int chunk_edges, int t,
           cudaStream_t stream) {
  // sum: per warp an accumulator and a one-byte tag for each of the t
  // slots; exact modes: one accumulator of int images
  const size_t smem = MODE == kSum
                          ? static_cast<size_t>(kWarps) * t * (sizeof(V) + 1)
                          : static_cast<size_t>(t) * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gas_chunk_kernel<MODE, OP, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_out_tiles, (t + kThreads - 1) / kThreads);
  if constexpr (MODE != kSum) {
    gas_identity_kernel<MODE, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(tile_chunk_start), static_cast<V*>(out), t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gas_chunk_kernel<MODE, OP, V><<<n_chunks, kThreads, smem, stream>>>(
      static_cast<const V*>(vwin), static_cast<const int*>(edge_src),
      static_cast<const int*>(edge_dst), static_cast<const float*>(edge_w),
      static_cast<const int*>(tile_edge_start),
      static_cast<const int*>(tile_chunk_start), static_cast<V*>(out),
      static_cast<V*>(scratch), n_out_tiles, chunk_edges, t);
  const cudaError_t err = cudaGetLastError();
  if constexpr (MODE == kSum) {
    if (err != cudaSuccess) return static_cast<int>(err);
    gas_combine_kernel<MODE, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const V*>(scratch),
        static_cast<const int*>(tile_chunk_start), static_cast<V*>(out), t);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (the first
// cudaGetLastError() of the two launches that is not 0), or
// cudaErrorInvalidValue for a combination the kernel does not take.
// n_chunks is the grid of pass 1: at least tile_chunk_start[n_out_tiles]
// (CTAs past it exit); scratch holds n_chunks rows of t values in sum
// mode, and the exact modes read none of it (it may be null);
// tile_chunk_start counts chunks of chunk_edges edges, a multiple of 4.
// The caller checks shapes, dtypes, devices and contiguity before
// calling.
int gas_launch(int mode, int scatter, const void* vwin,
               const void* edge_src, const void* edge_dst,
               const void* edge_w, const void* tile_edge_start,
               const void* tile_chunk_start, void* out, void* scratch,
               int n_out_tiles, int n_chunks, int chunk_edges, int t,
               void* stream) {
  if (n_out_tiles <= 0) return 0;
  if (n_chunks < n_out_tiles || chunk_edges <= 0 ||
      chunk_edges % kEdgesPerRound != 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* a[] = {vwin, edge_src, edge_dst, edge_w, tile_edge_start,
                     tile_chunk_start};
#define GAS_ARGS a[0], a[1], a[2], a[3], a[4], a[5], out, scratch, \
                 n_out_tiles, n_chunks, chunk_edges, t, s
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
