// grouped_sums: small-group segment sums for the device aggregates.
//
//   out[g] = sum of vals[i] over rows with valid[i] and ids[i] == g,  g in [0, k)
//
// Rows whose id lies outside [0, k) are dropped (invalid rows carry id k).
// vals are int64 (exact scaled-decimal sums and counts) or float32; ids are
// the engine's int64 group ids, read as they are (no cast pass); k <= 32.
//
// Replaces the Pallas TPU kernel ballista_tpu/ops/pallas_kernels.py:grouped_sums
// (its pallas_call at :78), which streamed 2048-row blocks through VMEM, did a
// dense (k x block) masked select and row sum, and carried the accumulator
// across a sequential grid. Hopper's blocks run in parallel and in no order,
// so that carried accumulator becomes two passes:
//
//   pass 1: each block walks a grid-stride range of rows; each thread keeps
//           KMAX accumulators in registers (KMAX = 4/8/16/32, the smallest
//           power of two >= k, unrolled compare-and-add per row, no
//           scatter), then the block reduces them with warp shuffles and
//           shared memory in a fixed order into one row of partials[nb, k];
//   pass 2: one block per group reduces that group's column of partials, in
//           a fixed order.
//
// No atomics anywhere, and the grid size depends only on n, so float results
// are bitwise identical from run to run (as the sequential Pallas grid's
// were). Hopper has native int64, so exact int64 sums go through this kernel
// on the card; on a TPU they never could (Mosaic has no 64-bit types).
//
// Bound: memory. The function reads each row once: 8 (vals) + 8 (ids) + 1
// (valid) bytes; at n = 2^21 that is 35.7 MB, about 10.6 us at the H100's
// 3.35 TB/s. The design reads every input exactly once with coalesced loads
// (neighbouring threads on neighbouring rows) and writes only nb*k + k
// partials, so nothing but the row stream touches device memory. The
// per-row compare-and-add costs about KMAX integer ops, which at k <= 16
// stays under the memory time; making it faster (vector loads, fewer
// compares) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see
// ballista_tpu_torch/ops/cuda_build.py); plain C interface for ctypes.

#include <cuda_runtime.h>

namespace {

using i64 = long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

int blocks_for(i64 n) {
  const i64 per_block = static_cast<i64>(kThreads) * kRowsPerThread;
  i64 b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ vals, const i64* __restrict__ ids,
             const bool* __restrict__ valid, i64 n, int k, T* __restrict__ partials) {
  T acc[KMAX];
#pragma unroll
  for (int g = 0; g < KMAX; ++g) acc[g] = T(0);

  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const i64 id = ids[i];
    const T v = valid[i] ? vals[i] : T(0);
#pragma unroll
    for (int g = 0; g < KMAX; ++g) acc[g] += (id == g) ? v : T(0);
  }

  // fixed-order block reduction: shuffle tree inside each warp, then the
  // warps' sums in warp order. Accumulators g >= k hold rows with ids in
  // [k, KMAX) and are never written out.
  __shared__ T warp_part[kWarps][KMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    const T s = warp_sum(acc[g]);
    if (lane == 0) warp_part[warp][g] = s;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    partials[static_cast<i64>(blockIdx.x) * k + threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
final_sums(const T* __restrict__ partials, int nblocks, int k, T* __restrict__ out) {
  const int g = blockIdx.x;
  T s = T(0);
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) s += partials[static_cast<i64>(b) * k + g];
  __shared__ T warp_part[kWarps];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_part[w];
    out[g] = t;
  }
}

template <typename T>
int launch(const void* vals, const void* ids, const void* valid, i64 n, int k,
           void* partials, void* out, void* stream) {
  if (k < 1 || k > 32 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(vals);
  const i64* id = static_cast<const i64*>(ids);
  const bool* ok = static_cast<const bool*>(valid);
  T* part = static_cast<T*>(partials);
  if (k <= 4) {
    partial_sums<T, 4><<<nb, kThreads, 0, s>>>(v, id, ok, n, k, part);
  } else if (k <= 8) {
    partial_sums<T, 8><<<nb, kThreads, 0, s>>>(v, id, ok, n, k, part);
  } else if (k <= 16) {
    partial_sums<T, 16><<<nb, kThreads, 0, s>>>(v, id, ok, n, k, part);
  } else {
    partial_sums<T, 32><<<nb, kThreads, 0, s>>>(v, id, ok, n, k, part);
  }
  final_sums<T><<<k, kThreads, 0, s>>>(part, nb, k, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows of the partials buffer the caller allocates: partials is [nb, k]
int grouped_sums_blocks(long long n) { return blocks_for(n); }

// each returns cudaGetLastError() after its launches (0 = launched)
int grouped_sums_i64(const void* vals, const void* ids, const void* valid, long long n,
                     int k, void* partials, void* out, void* stream) {
  return launch<long long>(vals, ids, valid, n, k, partials, out, stream);
}

int grouped_sums_f32(const void* vals, const void* ids, const void* valid, long long n,
                     int k, void* partials, void* out, void* stream) {
  return launch<float>(vals, ids, valid, n, k, partials, out, stream);
}

}  // extern "C"
