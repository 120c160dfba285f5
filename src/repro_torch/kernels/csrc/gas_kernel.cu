// GAS tile kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the reference package's Pallas body
// repro/kernels/gas_kernel.py::make_gas_kernel (launched through
// gas_pallas_call / gas_pallas_call_segmented). See
// repro_torch/kernels/gas_kernel.py for the design note and its bound.
//
// One CTA owns one output tile of T destination slots. It walks that
// tile's edge blocks tile_block_start[tile] .. tile_block_start[tile + 1]
// in order. For each block of E_BLK edges the CTA
//   1. gathers vwin[window_id[b] * W + src_local[b, e]] by direct load,
//      applies the scatter op with the edge weight and stages
//      (owner key, value) in shared memory (pads stage no owner);
//   2. scans the staged edges in order: slot d belongs to thread
//      d % kThreads, which alone combines into its shared-memory
//      accumulator. Every slot therefore sees its edges in (block, edge)
//      order on every run: no atomics, bit-stable sums.
// The next block's edge data is loaded into registers while the current
// block is scanned, and staging is double-buffered, so one barrier per
// block suffices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // power of two (owner = d & mask)
constexpr int kMaxEdgesPerThread = 4;     // E_BLK <= 1024
constexpr int kOwnerBits = 9;             // owner field; kNoOwner > any tid
constexpr int kOwnerMask = (1 << kOwnerBits) - 1;
constexpr int kNoOwner = kOwnerMask;

enum Mode { kSum = 0, kMin = 1, kMax = 2, kOr = 3 };
enum ScatterOp { kCopy = 0, kAddWeight = 1 };

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
  } else {
    return p;
  }
}

// Loads this thread's edges of block b into registers: the owner key
// (slot << kOwnerBits | slot % kThreads, or kNoOwner for a pad) and the
// scattered value.
template <int MODE, int OP, typename V>
__device__ __forceinline__ void load_block(
    int b, const V* __restrict__ vwin, const int* __restrict__ src_local,
    const int* __restrict__ dst_local, const float* __restrict__ weights,
    const int* __restrict__ valid, const int* __restrict__ window_id,
    int e_blk, int w, int tid, int (&key)[kMaxEdgesPerThread],
    V (&val)[kMaxEdgesPerThread]) {
  const int64_t base = static_cast<int64_t>(b) * e_blk;
  const V* win = vwin + static_cast<int64_t>(window_id[b]) * w;
#pragma unroll
  for (int i = 0; i < kMaxEdgesPerThread; ++i) {
    const int e = tid + i * kThreads;
    key[i] = kNoOwner;
    val[i] = Combine<MODE, V>::identity();
    if (e < e_blk && valid[base + e] != 0) {
      const int d = dst_local[base + e];
      key[i] = (d << kOwnerBits) | (d & (kThreads - 1));
      val[i] = scatter_op<OP, V>(win[src_local[base + e]], weights[base + e]);
    }
  }
}

template <int MODE, int OP, typename V>
__global__ void __launch_bounds__(kThreads)
gas_tile_kernel(const V* __restrict__ vwin,
                const int* __restrict__ src_local,
                const int* __restrict__ dst_local,
                const float* __restrict__ weights,
                const int* __restrict__ valid,
                const int* __restrict__ window_id,
                const int* __restrict__ tile_block_start,
                V* __restrict__ out, int e_blk, int w, int t) {
  using C = Combine<MODE, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_key = reinterpret_cast<int*>(smem);            // [2 * e_blk]
  V* s_val = reinterpret_cast<V*>(s_key + 2 * e_blk);   // [2 * e_blk]
  V* s_acc = s_val + 2 * e_blk;                         // [t]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b0 = tile_block_start[tile];
  const int b1 = tile_block_start[tile + 1];

  // each thread initialises, accumulates and writes only its own slots
  for (int s = tid; s < t; s += kThreads) s_acc[s] = C::identity();

  int key[kMaxEdgesPerThread];
  V val[kMaxEdgesPerThread];
  if (b0 < b1) {
    load_block<MODE, OP, V>(b0, vwin, src_local, dst_local, weights, valid,
                            window_id, e_blk, w, tid, key, val);
  }
  for (int b = b0; b < b1; ++b) {
    const int buf = ((b - b0) & 1) * e_blk;
#pragma unroll
    for (int i = 0; i < kMaxEdgesPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < e_blk) {
        s_key[buf + e] = key[i];
        s_val[buf + e] = val[i];
      }
    }
    __syncthreads();
    if (b + 1 < b1) {                    // in flight during the scan
      load_block<MODE, OP, V>(b + 1, vwin, src_local, dst_local, weights,
                              valid, window_id, e_blk, w, tid, key, val);
    }
    for (int e = 0; e < e_blk; ++e) {
      const int k = s_key[buf + e];
      if ((k & kOwnerMask) == tid) {
        const int slot = k >> kOwnerBits;
        s_acc[slot] = C::apply(s_acc[slot], s_val[buf + e]);
      }
    }
  }

  V* o = out + static_cast<int64_t>(tile) * t;
  for (int s = tid; s < t; s += kThreads) o[s] = s_acc[s];
}

template <int MODE, int OP, typename V>
void launch(const void* vwin, const void* src_local, const void* dst_local,
            const void* weights, const void* valid, const void* window_id,
            const void* tile_block_start, void* out, int n_out_tiles,
            int e_blk, int w, int t, cudaStream_t stream) {
  // s_key and s_val (two buffers of e_blk each) + s_acc (t), 4 B each
  const size_t smem = (4 * static_cast<size_t>(e_blk) + t) * 4;
  gas_tile_kernel<MODE, OP, V><<<n_out_tiles, kThreads, smem, stream>>>(
      static_cast<const V*>(vwin), static_cast<const int*>(src_local),
      static_cast<const int*>(dst_local),
      static_cast<const float*>(weights), static_cast<const int*>(valid),
      static_cast<const int*>(window_id),
      static_cast<const int*>(tile_block_start), static_cast<V*>(out),
      e_blk, w, t);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (cudaGetLastError()
// right after the launch), or cudaErrorInvalidValue for a combination
// the kernel does not take. The caller checks shapes, dtypes, devices
// and contiguity before calling.
int gas_launch(int mode, int scatter, const void* vwin,
               const void* src_local, const void* dst_local,
               const void* weights, const void* valid,
               const void* window_id, const void* tile_block_start,
               void* out, int n_out_tiles, int e_blk, int w, int t,
               void* stream) {
  if (n_out_tiles <= 0) return 0;
  if (e_blk <= 0 || e_blk > kThreads * kMaxEdgesPerThread || w <= 0 ||
      t <= 0 || t >= (1 << (31 - kOwnerBits))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* a[] = {vwin, src_local, dst_local, weights, valid, window_id,
                     tile_block_start};
#define GAS_ARGS a[0], a[1], a[2], a[3], a[4], a[5], a[6], out, n_out_tiles, \
                 e_blk, w, t, s
  switch (mode * 2 + scatter) {
    case kSum * 2 + kCopy: launch<kSum, kCopy, float>(GAS_ARGS); break;
    case kSum * 2 + kAddWeight: launch<kSum, kAddWeight, float>(GAS_ARGS); break;
    case kMin * 2 + kCopy: launch<kMin, kCopy, float>(GAS_ARGS); break;
    case kMin * 2 + kAddWeight: launch<kMin, kAddWeight, float>(GAS_ARGS); break;
    case kMax * 2 + kCopy: launch<kMax, kCopy, float>(GAS_ARGS); break;
    case kMax * 2 + kAddWeight: launch<kMax, kAddWeight, float>(GAS_ARGS); break;
    case kOr * 2 + kCopy: launch<kOr, kCopy, int>(GAS_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GAS_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
