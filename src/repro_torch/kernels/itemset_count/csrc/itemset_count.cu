// Multitude-targeted itemset counting on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/itemset_count/kernel.py
// (_itemset_count_kernel with accum="vpu_int32", launched by
// itemset_counts_pallas) and its accumulate-into use
// (src/repro/kernels/itemset_count/ops.py::itemset_counts_into).
//
//   out[k, c] (+)= sum_n w[n, c] * [ for all words j: tx[n, j] & tgt[k, j] == tgt[k, j] ]
//
// tx (N, W) uint32 row-major, tgt (K, W) uint32, w (N, C) int32, out (K, C)
// int32.  No transposes: the TPU's (W, N) layout existed for its 128-lane
// vector registers and buys nothing here.
//
// Bound: the integer pipe.  The containment test of one (row, target) pair
// takes one LOP3 per word (`miss |= t & ~row`; the last one also writes
// `miss == 0` to a predicate), and only a contained pair adds its C weights:
// N*K*W + C*hits int32 operations, where hits is the number of contained
// (row, target) pairs, against only 4*(N*(W+C) + K*(W+C)) bytes.  At the
// main-path geometries (W = 2, C = 2, K in the thousands) that is hundreds
// of operations per byte, on the 64 INT32 lanes of each SM
// (roofline/kernel_model.py).
//
// Design (simple first):
//   * one thread per target, its W target words held in registers;
//   * gridDim.x tiles the targets, gridDim.y splits N so that about one
//     full wave of CTAs is resident on the 132 SMs;
//   * each CTA walks its row range in tiles of rows + weights staged in
//     shared memory; every thread reads the same row, a broadcast with no
//     bank conflicts;
//   * each thread keeps C int32 partial counts in registers and ends with one
//     atomicAdd per (k, c).  Integer addition is exact in any order, so the
//     result is bit-identical to the plain version whatever order the atomics
//     land in;
//   * ragged edges are masked here: no padded copies of the bitmap;
//   * accumulate flag: with accumulate = 0 the launcher zeroes `out` first,
//     with accumulate = 1 the counts are added into the caller's buffer.
//   W <= 4 and C <= 2 (the paper's configurations) take the register kernel,
//   one exact instantiation per (W, C).  Every other W and C takes the
//   general kernel, which stages the CTA's targets in shared memory (in
//   global memory only if they do not fit there) and adds each hit with an
//   atomic, so every W and C the plain version accepts runs here.
//
// Left for later: an int8 tensor-core (wgmma s8.s8.s32) weighted reduction,
// bit-sliced containment (32 rows per word, one LOP3 per row-word and target
// word), several targets per thread to amortise the shared-memory loads, and
// a tuned tile table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStaticSmemBytes = 48 * 1024;

template <int W, int C>
__global__ void count_reg_kernel(const uint32_t* __restrict__ tx,
                                 const uint32_t* __restrict__ tgt,
                                 const int32_t* __restrict__ wts,
                                 int32_t* __restrict__ out, long long n,
                                 long long k, long long rows_per_cta,
                                 int tile_rows) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_tx = smem;                                   // [tile_rows][W]
  int32_t* s_w = reinterpret_cast<int32_t*>(smem + (long long)tile_rows * W);

  const long long kk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = kk < k;
  uint32_t t[W];
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = active ? tgt[kk * W + i] : 0u;
  int32_t acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0;

  const long long r0 = (long long)blockIdx.y * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  for (long long base = r0; base < r1; base += tile_rows) {
    const int rows = (int)min((long long)tile_rows, r1 - base);
    __syncthreads();  // the previous tile is consumed
    const uint32_t* gtx = tx + base * W;
    const int32_t* gw = wts + base * C;
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) s_tx[i] = gtx[i];
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) s_w[i] = gw[i];
    __syncthreads();
    if (active) {
      for (int r = 0; r < rows; ++r) {
        const uint32_t* row = s_tx + r * W;
        uint32_t miss = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) miss |= t[i] & ~row[i];
        if (miss == 0) {
          const int32_t* wr = s_w + r * C;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += wr[c];
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (acc[c] != 0) atomicAdd(out + kk * C + c, acc[c]);
  }
}

__global__ void count_general_kernel(const uint32_t* __restrict__ tx,
                                     const uint32_t* __restrict__ tgt,
                                     const int32_t* __restrict__ wts,
                                     int32_t* __restrict__ out,
                                     long long n, long long k, int nw, int nc,
                                     long long rows_per_cta, int tgt_in_smem) {
  extern __shared__ uint32_t smem[];                        // [nw][blockDim.x]
  const long long kk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kk >= k) return;
  const uint32_t* tp;
  long long stride;
  if (tgt_in_smem) {
    // each thread stages and reads only its own column: no barrier needed
    for (int i = 0; i < nw; ++i)
      smem[(long long)i * blockDim.x + threadIdx.x] = tgt[kk * nw + i];
    tp = smem + threadIdx.x;
    stride = blockDim.x;
  } else {
    tp = tgt + kk * nw;
    stride = 1;
  }
  const long long r0 = (long long)blockIdx.y * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  for (long long r = r0; r < r1; ++r) {
    const uint32_t* row = tx + r * nw;
    bool hit = true;
    for (int i = 0; i < nw && hit; ++i) {
      const uint32_t tw = tp[i * stride];
      hit = (__ldg(row + i) & tw) == tw;
    }
    if (hit) {
      for (int c = 0; c < nc; ++c) {
        const int32_t v = __ldg(wts + r * nc + c);
        if (v != 0) atomicAdd(out + kk * nc + c, v);
      }
    }
  }
}

int g_sm_count = 0;

int sm_count() {
  if (g_sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (g_sm_count <= 0) g_sm_count = 132;
  }
  return g_sm_count;
}

// Rows per CTA: split N so that about one wave of CTAs (2048 resident
// threads per SM) is in flight, never below one tile of rows per CTA.
long long rows_per_cta_for(long long n, long long grid_x, int threads,
                           int tile_rows) {
  const long long wave = (long long)sm_count() * (2048 / threads);
  long long splits = (wave + grid_x - 1) / grid_x;
  const long long max_splits = (n + tile_rows - 1) / tile_rows;
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  return (n + splits - 1) / splits;
}

template <int W, int C>
cudaError_t launch_reg(const uint32_t* tx, const uint32_t* tgt,
                       const int32_t* wts, int32_t* out, long long n,
                       long long k, int threads, int tile_rows,
                       cudaStream_t stream) {
  const int max_tile = kStaticSmemBytes / (4 * (W + C));
  if (tile_rows > max_tile) tile_rows = max_tile;
  const long long grid_x = (k + threads - 1) / threads;
  const long long rpc = rows_per_cta_for(n, grid_x, threads, tile_rows);
  const dim3 grid((unsigned)grid_x, (unsigned)((n + rpc - 1) / rpc));
  const size_t smem = (size_t)tile_rows * (W + C) * 4;
  count_reg_kernel<W, C><<<grid, threads, smem, stream>>>(
      tx, tgt, wts, out, n, k, rpc, tile_rows);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_reg_c(const uint32_t* tx, const uint32_t* tgt,
                         const int32_t* wts, int32_t* out, long long n,
                         long long k, int nc, int threads, int tile_rows,
                         cudaStream_t stream) {
  if (nc == 1) return launch_reg<W, 1>(tx, tgt, wts, out, n, k, threads, tile_rows, stream);
  return launch_reg<W, 2>(tx, tgt, wts, out, n, k, threads, tile_rows, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// threads: targets per CTA, one thread each (1..1024); tile_rows: rows
// staged in shared memory per step of the register kernel (the general
// kernel reads rows from global memory and ignores it).
int itemset_count_launch(const void* tx, const void* tgt, const void* wts,
                         void* out, long long n, long long k, int nw, int nc,
                         int threads, int tile_rows, int accumulate,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || k < 0 || nw < 1 || nc < 1 || threads < 1 || threads > 1024 ||
      tile_rows < 1)
    return (int)cudaErrorInvalidValue;
  int32_t* o = static_cast<int32_t*>(out);
  if (!accumulate) {
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)k * nc * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0 || k == 0) return (int)cudaSuccess;
  const uint32_t* x = static_cast<const uint32_t*>(tx);
  const uint32_t* g = static_cast<const uint32_t*>(tgt);
  const int32_t* w = static_cast<const int32_t*>(wts);
  if (nw <= 4 && nc <= 2) {
    cudaError_t e;
    if (nw == 1) e = launch_reg_c<1>(x, g, w, o, n, k, nc, threads, tile_rows, stream);
    else if (nw == 2) e = launch_reg_c<2>(x, g, w, o, n, k, nc, threads, tile_rows, stream);
    else if (nw == 3) e = launch_reg_c<3>(x, g, w, o, n, k, nc, threads, tile_rows, stream);
    else e = launch_reg_c<4>(x, g, w, o, n, k, nc, threads, tile_rows, stream);
    return (int)e;
  }
  // General kernel: shrink the CTA until its targets fit in shared memory.
  int t = threads;
  while (t > 32 && (long long)t * nw * 4 > kStaticSmemBytes) t /= 2;
  const int in_smem = (long long)t * nw * 4 <= kStaticSmemBytes ? 1 : 0;
  const long long grid_x = (k + t - 1) / t;
  const long long rpc = rows_per_cta_for(n, grid_x, t, 32);
  const dim3 grid((unsigned)grid_x, (unsigned)((n + rpc - 1) / rpc));
  count_general_kernel<<<grid, t, in_smem ? (size_t)t * nw * 4 : 0, stream>>>(
      x, g, w, o, n, k, nw, nc, rpc, in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
