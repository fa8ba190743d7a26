// grouped_sums: small-group segment sums of several columns over one ids
// array, in one launch.
//
//   out[c, g] = sum of vals_c[i] over rows i with mask_c[i] and ids[i] == g
//               (a count column has no value array and adds 1 per row)
//   g in [0, k), k <= 32; rows whose id lies outside [0, k) are dropped.
//
// ids are the engine's int64 group ids (invalid rows carry id k), read as
// they are. A call is one accumulator type: int64 (exact scaled-decimal sums
// and counts) or float32. Columns may share a mask; the caller passes the
// columns ordered so that equal masks are adjacent, with the output row of
// each.
//
// Replaces the Pallas TPU kernel ballista_tpu/ops/pallas_kernels.py:grouped_sums
// (its pallas_call at :78), which streamed 2048-row blocks of ONE column
// through VMEM, did a dense (k x block) masked select and row sum, and carried
// the accumulator across a sequential grid. The engine called it once per
// column, re-reading ids and materialising a mask per call; here one launch
// covers every small-k sum and count of an aggregate stage.
//
// Bound: memory. One launch must read ids once (8 B/row), each distinct mask
// once (1 B/row) and each value column once (8 or 4 B/row). At q1's partial
// stage (n = 2^21, k = 12, 7 int64 sums + 1 count over one mask) that is
// n * (8 + 1 + 7 * 8) = 136,314,880 bytes, 40.7 us at 3.35 TB/s. How the
// design meets its constraints:
//
// * One pass, every input read once. Each warp walks 256-row tiles (grid
//   stride over warps); a lane owns 8 rows of a tile. For a tile the warp
//   loads the ids once and turns each into one byte: the id if it lies in
//   [0, k), else k. It takes the columns two at a time; a column's mask is
//   loaded only when it differs from the previous column's (so a mask that
//   adjacent columns share is read once per tile), and the next pair's
//   values are loaded while the current pair is added (two pairs of
//   register buffers).
// * Loads made for the card. The rows of a lane are laid out so that ids
//   and int64 values come 16 bytes (two rows) a lane, neighbouring lanes on
//   neighbouring 16-byte pieces: 512 bytes per warp load. float32 values
//   then come 8 bytes and masks 2 bytes a lane, each warp load again one
//   unbroken run (256 and 64 bytes). (Giving each lane 16 consecutive rows
//   instead, so that masks too come 16 bytes a lane, puts a lane's ids and
//   values 128 bytes from its neighbour's: each warp load then touches 32
//   cache lines instead of 4.) The tiles start at row 0 or 1,
//   whichever aligns every array; the rows after the last whole tile, and
//   every row of arrays whose alignments disagree (views at unrelated
//   offsets), go one at a time.
// * Per-row work does not grow with k or C x k. Each thread has private
//   accumulator slots in shared memory, slot[c][g][thread] for g in [0, k]
//   (slot k takes dropped and masked-out rows, so no branch). A row adds its
//   value to ONE slot per column: a shared load, an add and a store, the
//   address from the row's byte; the two columns of a pair interleave, so
//   two such chains run at once. Slots of one (c, g) are consecutive across
//   threads, so a warp's accesses fall on distinct banks. Ids are checked as
//   unsigned, (uint64)id < k, before they pick a slot.
// * Deterministic float sums, no float atomics. Each thread sums its rows in
//   a fixed order; the block folds each (c, g) over its threads (fixed runs
//   of threads, each summed in order, then the runs in order), writes one row
//   of partials, and the last block to finish (a counter in the workspace)
//   folds the partials over the blocks the same way. The grid depends only
//   on the shape, the device and the data pointers' alignment, so float
//   results are bitwise identical run to run. Integer sums are exact in any
//   order.
// * One launch at every size, one resident wave. The block size is the
//   largest of 256/128/64/32 whose slots fit the SM's shared memory; the grid
//   is the blocks the occupancy API says fit at once on all SMs, cut to the
//   work there is (one block for a few rows) and to the workspace. The
//   cross-block fold happens in the same launch.
// * How many columns one launch takes. The slots are C * (k + 1) values a
//   thread, so C is bounded: grouped_sums_max_columns(k) is the most columns
//   whose slots still leave a block of kMinThreads (and at most kMaxCols, the
//   parameter block). The caller splits a wider stage into launches of at
//   most that many columns, the columns of one mask together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see
// ballista_tpu_torch/ops/cuda_build.py); plain C interface for ctypes.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

using i64 = long long;
using u64 = unsigned long long;

constexpr int kMaxCols = 32;
constexpr int kMaxGroups = 32;
constexpr int kLaneRows = 8;                 // rows a lane owns in a warp tile
constexpr int kWarpRows = 32 * kLaneRows;    // rows of a warp tile
constexpr int kMaxThreads = 256;
// The smallest block grouped_sums_max_columns allows: the slots fill the
// SM's shared memory, so a block is alone on its SM, and fewer than four
// warps an SM keep too few loads in flight to stream from HBM.
constexpr int kMinThreads = 128;
constexpr i64 kCounterBytes = 16;  // the workspace's head: the blocks-done counter

struct Cols {
  const void* vals[kMaxCols];            // nullptr: a count column
  const unsigned char* masks[kMaxCols];  // bool masks, equal ones adjacent
  int out_row[kMaxCols];                 // the row of out this column fills
  int n;                                 // columns
};

__device__ __forceinline__ unsigned int slot_of(i64 id, int k) {
  return static_cast<u64>(id) < static_cast<u64>(k) ? static_cast<unsigned int>(id)
                                                     : static_cast<unsigned int>(k);
}

// A lane's rows in the warp tile at w0: row w0 + 64 j + 2 lane + e is the
// lane's row r = 2 j + e (j < 4, e < 2). So the j-th load of the warp reads
// 32 neighbouring 16-byte pieces (512 bytes) of an int64 array, 256 bytes of
// a float32 one and 64 bytes of a mask: every load instruction is coalesced.
__device__ __forceinline__ void load_rows(const i64* p, int lane, i64 (&v)[kLaneRows]) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p) + lane;
#pragma unroll
  for (int j = 0; j < kLaneRows / 2; ++j) {
    const longlong2 x = __ldg(q + 32 * j);
    v[2 * j] = x.x;
    v[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void load_rows(const float* p, int lane, float (&v)[kLaneRows]) {
  const float2* q = reinterpret_cast<const float2*>(p) + lane;
#pragma unroll
  for (int j = 0; j < kLaneRows / 2; ++j) {
    const float2 x = __ldg(q + 32 * j);
    v[2 * j] = x.x;
    v[2 * j + 1] = x.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_col(const void* vals, i64 w0, int lane, T (&v)[kLaneRows]) {
  if (vals != nullptr) load_rows(static_cast<const T*>(vals) + w0, lane, v);
}

// slot bytes of the lane's rows under one mask: the row's id byte where the
// mask is set, else k (bool bytes are 0 or 1, so byte * 0xFF is 0x00 or 0xFF)
__device__ __forceinline__ void mask_slots(const unsigned char* mask, i64 w0, int lane,
                                           const unsigned int (&ids8)[2], unsigned int kk,
                                           unsigned int (&slot)[2]) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(mask + w0) + lane;
  unsigned int m[kLaneRows / 2];
#pragma unroll
  for (int j = 0; j < kLaneRows / 2; ++j) m[j] = __ldg(q + 32 * j);
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const unsigned int ff = (m[2 * w] | (m[2 * w + 1] << 16)) * 0xFFu;
    slot[w] = (ids8[w] & ff) | (kk & ~ff);
  }
}

__device__ __forceinline__ unsigned int byte_of(const unsigned int (&s)[2], int r) {
  return (s[r >> 2] >> ((r & 3) * 8)) & 0xFFu;
}

// Adds the lane's rows of two columns to their slots. col points at this
// thread's slot (c, 0); slot g lies g * nt further. Both columns' slots are
// read before either is written, so the two read-add-write chains overlap
// (columns never share slots).
template <typename T>
__device__ __forceinline__ void add_pair(T* col_a, const unsigned int (&sa)[2],
                                         const T (&va)[kLaneRows], bool count_a, T* col_b,
                                         const unsigned int (&sb)[2], const T (&vb)[kLaneRows],
                                         bool count_b, int nt) {
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) {
    T* pa = col_a + byte_of(sa, r) * nt;
    T* pb = col_b + byte_of(sb, r) * nt;
    const T xa = *pa;
    const T xb = *pb;
    *pa = xa + (count_a ? T(1) : va[r]);
    *pb = xb + (count_b ? T(1) : vb[r]);
  }
}

template <typename T>
__device__ __forceinline__ void add_one(T* col, const unsigned int (&s)[2],
                                        const T (&v)[kLaneRows], bool count, int nt) {
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) col[byte_of(s, r) * nt] += count ? T(1) : v[r];
}

// Sums at(i) over i in [begin, end), in order; unrolled so that sixteen
// loads are in flight together.
template <typename T, typename At>
__device__ __forceinline__ T sum_run(At at, int begin, int end) {
  T s = T(0);
#pragma unroll 16
  for (int i = begin; i < end; ++i) s += at(i);
  return s;
}

// For each output o < nout, sums item(o)(i) over i < len in a fixed order and
// calls emit(o, sum), using the whole block: where there are threads for two
// or more runs of at least 16 items per output, each thread sums one
// contiguous run of i and the runs' sums are added in run order through
// scratch; otherwise each thread takes whole outputs. item(o) returns the
// accessor of output o's values. Every thread of the block must call it.
template <typename T, typename Item, typename Emit>
__device__ __forceinline__ void fold(int nout, int len, T* scratch, Item item, Emit emit) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int by_len = len / 16 > 1 ? len / 16 : 1;
  const int runs = nt / nout < by_len ? nt / nout : by_len;
  if (runs < 2) {
    for (int o = tid; o < nout; o += nt) emit(o, sum_run<T>(item(o), 0, len));
    return;
  }
  const int o = tid % nout;
  const int run = tid / nout;
  const T s = run < runs ? sum_run<T>(item(o), run * len / runs, (run + 1) * len / runs) : T(0);
  __syncthreads();  // every read is done: scratch may overwrite what they read
  if (run < runs) scratch[run * nout + o] = s;
  __syncthreads();
  if (tid < nout) {
    T t = T(0);
    for (int r = 0; r < runs; ++r) t += scratch[r * nout + tid];
    emit(tid, t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
grouped_sums_kernel(Cols cols, const i64* __restrict__ ids, i64 n, int k, i64 head,
                    i64 vec_end, unsigned int* __restrict__ done, T* __restrict__ partials,
                    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ const void* s_vals[kMaxCols];
  __shared__ const unsigned char* s_masks[kMaxCols];
  __shared__ int s_row[kMaxCols];
  __shared__ bool s_last;

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ncols = cols.n;
  const int k1 = k + 1;
  if (tid == 0) {
    // constant indices: the parameter block is read in place
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      s_vals[c] = cols.vals[c];
      s_masks[c] = cols.masks[c];
      s_row[c] = cols.out_row[c];
    }
  }
  T* acc = reinterpret_cast<T*>(smem_raw);
  T* mine = acc + tid;
  for (int s = 0; s < ncols * k1; ++s) mine[s * nt] = T(0);
  __syncthreads();

  const i64 gt = static_cast<i64>(blockIdx.x) * nt + tid;
  const i64 stride = static_cast<i64>(gridDim.x) * nt;

  // one row at a time: the head, the tail, and arrays whose alignments
  // disagree. Eight columns' loads are issued before any is added.
  auto add_row = [&](i64 i) {
    const unsigned int g0 = slot_of(ids[i], k);
    for (int c0 = 0; c0 < ncols; c0 += 8) {
      T v[8];
      bool m[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u < ncols ? c0 + u : ncols - 1;
        m[u] = s_masks[c][i];
        const void* vp = s_vals[c];
        v[u] = vp != nullptr ? static_cast<const T*>(vp)[i] : T(1);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u < ncols) {
          const unsigned int g = m[u] ? g0 : static_cast<unsigned int>(k);
          mine[((c0 + u) * k1 + static_cast<int>(g)) * nt] += v[u];
        }
      }
    }
  };

  if (gt < head) add_row(gt);

  const unsigned int kk = static_cast<unsigned int>(k) * 0x01010101u;
  const i64 ntiles = (vec_end - head) / kWarpRows;
  // count columns leave their buffer as it was: start it defined
  T a0[kLaneRows] = {}, b0[kLaneRows] = {}, a1[kLaneRows] = {}, b1[kLaneRows] = {};
  for (i64 t = gt >> 5; t < ntiles; t += stride >> 5) {
    const i64 w0 = head + t * kWarpRows;
    i64 id[kLaneRows];
    load_rows(ids + w0, lane, id);
    load_col(s_vals[0], w0, lane, a0);
    if (ncols > 1) load_col(s_vals[1], w0, lane, b0);
    unsigned int ids8[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      ids8[w] = slot_of(id[4 * w], k) | (slot_of(id[4 * w + 1], k) << 8) |
                (slot_of(id[4 * w + 2], k) << 16) | (slot_of(id[4 * w + 3], k) << 24);
    }
    const unsigned char* cur_mask = nullptr;
    unsigned int slot[2];
    auto slots_of = [&](int c, unsigned int (&s)[2]) {
      if (s_masks[c] != cur_mask) {
        cur_mask = s_masks[c];
        mask_slots(cur_mask, w0, lane, ids8, kk, slot);
      }
      s[0] = slot[0];
      s[1] = slot[1];
    };
    // columns two at a time, from two pairs of buffers: one pair's loads
    // are in flight while the other pair is added
    auto add_cols = [&](int c, const T (&va)[kLaneRows], const T (&vb)[kLaneRows]) {
      unsigned int sa[2], sb[2];
      slots_of(c, sa);
      if (c + 1 < ncols) {
        slots_of(c + 1, sb);
        add_pair(mine + c * k1 * nt, sa, va, s_vals[c] == nullptr, mine + (c + 1) * k1 * nt,
                 sb, vb, s_vals[c + 1] == nullptr, nt);
      } else {
        add_one(mine + c * k1 * nt, sa, va, s_vals[c] == nullptr, nt);
      }
    };
    for (int c = 0; c < ncols; c += 4) {
      if (c + 2 < ncols) load_col(s_vals[c + 2], w0, lane, a1);
      if (c + 3 < ncols) load_col(s_vals[c + 3], w0, lane, b1);
      add_cols(c, a0, b0);
      if (c + 2 < ncols) {
        if (c + 4 < ncols) load_col(s_vals[c + 4], w0, lane, a0);
        if (c + 5 < ncols) load_col(s_vals[c + 5], w0, lane, b0);
        add_cols(c + 2, a1, b1);
      }
    }
  }

  for (i64 i = vec_end + gt; i < n; i += stride) add_row(i);
  __syncthreads();

  // The block's sums: each (c, g) over the block's threads, in a fixed order.
  const int nout = ncols * k;
  fold<T>(nout, nt, acc, [&](int o) {
    // rotated by o, so that threads on neighbouring outputs read distinct banks
    const T* row = acc + ((o / k) * k1 + o % k) * nt;
    const int mask = nt - 1;
    return [=](int i) { return row[(i + o) & mask]; };
  }, [&](int o, T s) { partials[static_cast<i64>(blockIdx.x) * nout + o] = s; });
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block to finish: each output over the blocks, in block order.
  __threadfence();
  fold<T>(nout, static_cast<int>(gridDim.x), acc, [&](int o) {
    const T* col = partials + o;
    return [=](int b) { return __ldcg(col + static_cast<i64>(b) * nout); };
  }, [&](int o, T s) { out[static_cast<i64>(s_row[o / k]) * k + o % k] = s; });
  if (tid == 0) *done = 0u;  // ready for the next launch on this workspace
}

bool aligned(const void* p, i64 offset_bytes, u64 to) {
  return (reinterpret_cast<u64>(p) + static_cast<u64>(offset_bytes)) % to == 0;
}

// How one launch shape runs on one device: the largest block whose private
// slots fit in shared memory, its shared memory, and the blocks an SM holds.
struct Plan {
  int threads;
  i64 smem;
  int per_sm;
  int sms;
};

// The shared memory a block's slots may take on a device: the opt-in maximum
// less the kernel's static shared memory. Found once per device and kept.
template <typename T>
cudaError_t slot_capacity(int dev, i64* cap) {
  static std::mutex mu;
  static std::map<int, i64> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(dev);
  if (it != known.end()) {
    *cap = it->second;
    return cudaSuccess;
  }
  cudaError_t err;
  int optin = 0;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, grouped_sums_kernel<T>)) != cudaSuccess) return err;
  *cap = known[dev] = static_cast<i64>(optin) - static_cast<i64>(fa.sharedSizeBytes);
  return cudaSuccess;
}

// Found once per device and slot size and kept: the runtime's attribute and
// occupancy queries cost more host time than the launch itself.
template <typename T>
cudaError_t plan(int dev, i64 per_thread, Plan* out) {
  i64 cap = 0;
  cudaError_t err = slot_capacity<T>(dev, &cap);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, i64>, Plan> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, per_thread);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  auto kernel = grouped_sums_kernel<T>;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  int threads = kMaxThreads;
  while (threads > 32 && per_thread * threads > cap) threads >>= 1;
  if (per_thread * threads > cap) return cudaErrorInvalidValue;
  // allow the kernel all of it, so any later slot size fits too
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(cap))) != cudaSuccess)
    return err;
  const i64 smem = per_thread * threads;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           static_cast<size_t>(smem))) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = known[key] = Plan{threads, smem, per_sm, sms};
  return cudaSuccess;
}

template <typename T>
int launch(const Cols& cols, const i64* ids, i64 n, int k, unsigned char* ws, i64 ws_bytes,
           T* out, cudaStream_t stream) {
  if (cols.n < 1 || cols.n > kMaxCols || k < 1 || k > kMaxGroups || n < 0 ||
      ws_bytes <= kCounterBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan pl;
  err = plan<T>(dev, static_cast<i64>(cols.n) * (k + 1) * static_cast<i64>(sizeof(T)), &pl);
  if (err != cudaSuccess) return static_cast<int>(err);

  // Rows [head, vec_end) go in warp tiles, when at row head the ids and
  // int64 values are 16-byte aligned, float32 values 8-byte and masks
  // 2-byte aligned; head is 0 or 1, as those are the alignments of element
  // 0 or 1 of a tensor. Otherwise every row goes one at a time.
  i64 head = -1;
  for (i64 h = 0; h < 2 && head < 0; ++h) {
    bool ok = n - h >= kWarpRows && aligned(ids, h * 8, 16);
    for (int c = 0; ok && c < cols.n; ++c) {
      ok = aligned(cols.masks[c], h, 2) &&
           (cols.vals[c] == nullptr ||
            aligned(cols.vals[c], h * static_cast<i64>(sizeof(T)), 2 * sizeof(T)));
    }
    if (ok) head = h;
  }
  const bool vec = head >= 0;
  if (!vec) head = 0;
  const i64 vec_end = vec ? head + (n - head) / kWarpRows * kWarpRows : 0;

  // threads wanted: a warp per tile, or a thread per row where there are
  // more of those
  const i64 tile_threads = (vec_end - head) / kWarpRows * 32;
  const i64 rows = vec ? n - vec_end : n;
  const i64 items = tile_threads > rows ? tile_threads : rows;
  // one resident wave, no more blocks than the work fills, and no more
  // partials than the workspace holds
  const i64 fit = (ws_bytes - kCounterBytes) /
                  (static_cast<i64>(cols.n) * k * static_cast<i64>(sizeof(T)));
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pl.threads;
  i64 grid = static_cast<i64>(pl.per_sm) * pl.sms;
  const i64 wanted = (items + threads - 1) / threads;
  if (wanted < grid) grid = wanted;
  if (fit < grid) grid = fit;
  if (grid < 1) grid = 1;

  unsigned int* done = reinterpret_cast<unsigned int*>(ws);
  T* partials = reinterpret_cast<T*>(ws + kCounterBytes);
  grouped_sums_kernel<T><<<static_cast<unsigned int>(grid), threads,
                           static_cast<size_t>(pl.smem), stream>>>(
      cols, ids, n, k, head, vec_end, done, partials, out);
  return static_cast<int>(cudaGetLastError());
}

// The most columns of one launch at k groups on the current device: their
// slots leave a block of kMinThreads, and they fit the parameter block.
template <typename T>
int max_columns(int k) {
  if (k < 1 || k > kMaxGroups) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  i64 cap = 0;
  if ((err = slot_capacity<T>(dev, &cap)) != cudaSuccess) return -static_cast<int>(err);
  const i64 cols = cap / ((k + 1) * static_cast<i64>(sizeof(T)) * kMinThreads);
  return static_cast<int>(cols < kMaxCols ? cols : kMaxCols);
}

}  // namespace

extern "C" {

// Sums ncols columns over one ids array into out[ncols, k] in one launch and
// returns cudaGetLastError() after it (0 = launched); ncols is at most
// grouped_sums_max_columns(is_f32, k), and out may have more rows, which
// other launches fill. vals[c] is the value
// array of column c (int64, or float32 when is_f32) or NULL for a count;
// masks[c] its bool mask (equal masks adjacent); out_rows[c] the row of out
// it fills. ws is the caller's workspace of ws_bytes: a 16-byte counter that
// must be 0 before the first launch (each launch leaves it 0), then the
// per-block partials. Launches on `stream`; does not synchronise.
int grouped_sums_launch(int is_f32, int ncols, const void* const* vals,
                        const void* const* masks, const int* out_rows, const void* ids,
                        long long n, int k, void* ws, long long ws_bytes, void* out,
                        void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  Cols cols = {};
  cols.n = ncols;
  for (int c = 0; c < ncols; ++c) {
    cols.vals[c] = vals[c];
    cols.masks[c] = static_cast<const unsigned char*>(masks[c]);
    cols.out_row[c] = out_rows[c];
  }
  const i64* id = static_cast<const i64*>(ids);
  unsigned char* w = static_cast<unsigned char*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) return launch<float>(cols, id, n, k, w, ws_bytes, static_cast<float*>(out), s);
  return launch<i64>(cols, id, n, k, w, ws_bytes, static_cast<i64*>(out), s);
}

// The most columns one grouped_sums_launch takes at k groups (int64, or
// float32 when is_f32) on the current device, at least 1 for every k in
// [1, 32]; a negative CUDA error on failure.
int grouped_sums_max_columns(int is_f32, int k) {
  return is_f32 ? max_columns<float>(k) : max_columns<i64>(k);
}

}  // extern "C"
