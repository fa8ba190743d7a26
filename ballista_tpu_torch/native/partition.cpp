// Native shuffle kernels: hash bucketing + counting-sort partition permutation.
//
// Reference analog: the executor's hot repartition loop
// (arrow-ballista: ballista/core/src/execution_plans/shuffle_writer.rs:233-329,
// BatchPartitioner) — native Rust there, C++ here. Semantics are identical to
// the Python kernels (kernels_np.splitmix64 / hash_partition): same splitmix64
// constants, so buckets agree across the native, numpy and JAX paths.
//
// Built at first use: g++ -O3 -shared -fPIC (see ballista_tpu_torch/native/__init__.py).
#include <cstdint>
#include <cstring>

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

extern "C" {

// Mix n_cols canonical int64 key columns into buckets in [0, n_buckets).
void hash_buckets(const int64_t* const* keys, int32_t n_cols, int64_t n_rows,
                  uint32_t n_buckets, int32_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    uint64_t mixed = 0;
    for (int32_t c = 0; c < n_cols; ++c) {
      mixed = splitmix64(mixed ^ (uint64_t)keys[c][i]);
    }
    out[i] = (int32_t)(mixed % (uint64_t)n_buckets);
  }
}

// Stable counting sort of row indices by bucket.
// order[n_rows]: permutation grouping rows by bucket; bounds[n_buckets+1]:
// bucket i occupies order[bounds[i]:bounds[i+1]].
void partition_order(const int32_t* buckets, int64_t n_rows, uint32_t n_buckets,
                     int64_t* order, int64_t* bounds) {
  int64_t* counts = new int64_t[n_buckets + 1];
  std::memset(counts, 0, sizeof(int64_t) * (n_buckets + 1));
  for (int64_t i = 0; i < n_rows; ++i) counts[buckets[i] + 1]++;
  bounds[0] = 0;
  for (uint32_t b = 0; b < n_buckets; ++b) bounds[b + 1] = bounds[b] + counts[b + 1];
  int64_t* cursor = counts;  // reuse as running cursor
  for (uint32_t b = 0; b < n_buckets; ++b) cursor[b] = bounds[b];
  for (int64_t i = 0; i < n_rows; ++i) {
    order[cursor[buckets[i]]++] = i;
  }
  delete[] counts;
}

// Fused gather: out[j] = src[order[j]] for fixed-width columns (elem_size bytes).
void gather_rows(const uint8_t* src, const int64_t* order, int64_t n_rows,
                 int32_t elem_size, uint8_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + i * elem_size, src + order[i] * elem_size, elem_size);
  }
}

}  // extern "C"
