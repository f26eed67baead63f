// The Minority-Report encode after the host's walk, on Hopper (sm_90a).
//
// The JAX package encodes on the host (numpy); this has no TPU kernel to
// replace.  The host walks the rows into flat item ids (ids[offsets[r] ..
// offsets[r + 1]) are row r's, in the order walked, repeats included) and
// these kernels do the rest, around a sort of the rows (torch.argsort, one
// stable pass a key, last key first) and a prefix sum of the heads:
//
//   count_rows   one thread a row: heap-sorts the row's ids in place
//                (O(L log L) for a row of L, whatever the vocabulary), so
//                that each distinct (item, row) pair is the first of a run
//                of equal ids, counted per item in all rows, in rare-class
//                rows, and tagged with n - r (atomicMax: the first
//                rare-class row holding the item wins);
//   pack_rows    one thread a row: sets bit col & 31 of word col >> 5 of
//                the row's `w` words for each occurrence whose item has a
//                column (col = cols[id] >= 0; a repeat sets its bit again,
//                and the order within the row does not matter),
//                then makes each pair of words (a, b) a sort key (a, b as
//                unsigned) ^ 2^63 as int64, so that the signed order of key
//                p is the unsigned order of words 2p, 2p + 1;
//   row_heads    one thread a sorted row: 1 where it differs from the row
//                before it (the first of each run of equal rows);
//   gather_rows  one thread a sorted row: adds it to its run's class weight
//                and writes the run's words once, from its head.
//
// Memory grows with the occurrences (T) and the packed rows (n * w), never
// with the walked vocabulary: pass 1 needs no buffer past the walk's own.
// Every count is int32 and every row index and item id below 2^31 (the
// wrapper checks).  The kernels are memory-bound and short: the point is one
// launch a stage in place of the dozens of elementwise launches (or the
// dozen of a radix sort) the same work takes in torch ops.  Each entry point
// returns the cudaError_t of its launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Sifts a[root] down the max-heap a[0 .. end].
__device__ void sift_down(int32_t* a, long long root, long long end) {
  for (long long child; (child = 2 * root + 1) <= end; root = child) {
    if (child < end && a[child] < a[child + 1]) ++child;
    if (a[root] >= a[child]) return;
    const int32_t t = a[root];
    a[root] = a[child];
    a[child] = t;
  }
}

__global__ void count_rows_kernel(int32_t* __restrict__ ids,
                                  const int64_t* __restrict__ offsets,
                                  const uint8_t* __restrict__ rare,
                                  long long n, int n_ids,
                                  int32_t* __restrict__ counts) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  int32_t* a = ids + offsets[r];
  const long long len = offsets[r + 1] - offsets[r];
  for (long long i = len / 2 - 1; i >= 0; --i) sift_down(a, i, len - 1);
  for (long long end = len - 1; end > 0; --end) {
    const int32_t t = a[0];
    a[0] = a[end];
    a[end] = t;
    sift_down(a, 0, end - 1);
  }
  const bool in_rare = rare[r] != 0;
  const int32_t tag = static_cast<int32_t>(n - r);
  for (long long k = 0; k < len; ++k) {
    const int id = a[k];
    if (k > 0 && a[k - 1] == id) continue;  // a repeat in this row
    atomicAdd(counts + id, 1);
    if (in_rare) {
      atomicAdd(counts + n_ids + id, 1);
      atomicMax(counts + 2 * n_ids + id, tag);
    }
  }
}

__global__ void pack_rows_kernel(const int32_t* __restrict__ ids,
                                 const int64_t* __restrict__ offsets,
                                 long long n,
                                 const int32_t* __restrict__ cols, int w,
                                 uint32_t* __restrict__ words,
                                 int64_t* __restrict__ keys) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t* out = words + r * w;
  for (int wd = 0; wd < w; ++wd) out[wd] = 0;
  for (long long k = offsets[r], end = offsets[r + 1]; k < end; ++k) {
    const int col = cols[ids[k]];
    if (col >= 0) out[col >> 5] |= 1u << (col & 31);
  }
  uint32_t hi = 0;
  for (int wd = 0; wd < w; ++wd) {
    const uint32_t word = out[wd];
    if (wd & 1) {
      keys[(wd >> 1) * n + r] = static_cast<int64_t>(
          ((static_cast<uint64_t>(hi) << 32) | word) ^ (1ull << 63));
    }
    hi = word;
  }
  if (w & 1) {
    keys[(w >> 1) * n + r] = static_cast<int64_t>(
        (static_cast<uint64_t>(hi) << 32) ^ (1ull << 63));
  }
}

__global__ void row_heads_kernel(const uint32_t* __restrict__ words,
                                 const int64_t* __restrict__ perm,
                                 long long n, int w,
                                 int32_t* __restrict__ head) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t h = 1;
  if (i > 0) {
    const uint32_t* a = words + perm[i] * w;
    const uint32_t* b = words + perm[i - 1] * w;
    h = 0;
    for (int wd = 0; wd < w; ++wd) h |= a[wd] != b[wd];
  }
  head[i] = h;
}

__global__ void gather_rows_kernel(const uint32_t* __restrict__ words,
                                   const int64_t* __restrict__ perm,
                                   const int32_t* __restrict__ run,
                                   const int32_t* __restrict__ head,
                                   const uint8_t* __restrict__ rare,
                                   long long n, int w,
                                   uint32_t* __restrict__ bits,
                                   int32_t* __restrict__ weights) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = perm[i];
  const long long g = run[i] - 1;  // runs are numbered from 1
  atomicAdd(weights + 2 * g + (rare[r] != 0), 1);
  if (head[i]) {
    for (int wd = 0; wd < w; ++wd) bits[g * w + wd] = words[r * w + wd];
  }
}

}  // namespace

extern "C" {

// ids: sorted within each row in place; counts: 3 * n_ids int32, zeroed by
// the caller (all rows, rare-class rows, n - the first rare-class row).
int mra_count_rows(void* ids, const void* offsets, const void* rare,
                   long long n, int n_ids, void* counts, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  count_rows_kernel<<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<int32_t*>(ids), static_cast<const int64_t*>(offsets),
      static_cast<const uint8_t*>(rare), n, n_ids,
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

// cols: one int32 a walked id (its column, or -1); words: n * w uint32;
// keys: ceil(w / 2) * n int64.
int mra_pack_rows(const void* ids, const void* offsets, long long n,
                  const void* cols, int w, void* words, void* keys,
                  void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  pack_rows_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int64_t*>(offsets),
      n, static_cast<const int32_t*>(cols), w, static_cast<uint32_t*>(words),
      static_cast<int64_t*>(keys));
  return (int)cudaGetLastError();
}

// head: n int32.
int mra_row_heads(const void* words, const void* perm, long long n, int w,
                  void* head, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  row_heads_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(perm),
      n, w, static_cast<int32_t*>(head));
  return (int)cudaGetLastError();
}

// run: the inclusive prefix sum of head; bits: runs * w uint32; weights:
// runs * 2 int32, zeroed by the caller.
int mra_gather_rows(const void* words, const void* perm, const void* run,
                    const void* head, const void* rare, long long n, int w,
                    void* bits, void* weights, void* stream_ptr) {
  if (n <= 0) return (int)cudaSuccess;
  gather_rows_kernel<<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(perm),
      static_cast<const int32_t*>(run), static_cast<const int32_t*>(head),
      static_cast<const uint8_t*>(rare), n, w, static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(weights));
  return (int)cudaGetLastError();
}

}  // extern "C"
