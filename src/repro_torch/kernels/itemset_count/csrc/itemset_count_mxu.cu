// Multitude-targeted itemset counting on Hopper (sm_90a), with the weighted
// reduction on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/itemset_count/kernel.py
// (_itemset_count_kernel with accum="mxu_f32", kernel.py:53-60: the weighted
// reduce as an f32 product on the MXU) and, through the accumulate flag, its
// accumulate-into use (src/repro/kernels/itemset_count/ops.py::
// itemset_counts_into with accum="mxu_f32").
//
//   out[k, c] (+)= sum_n w[n, c] * [ for all words j: tx[n, j] & tgt[k, j] == tgt[k, j] ]
//
// tx (N, W) uint32 row-major, tgt (K, W) uint32, w (N, C) int32, out (K, C)
// int32 -- the same function and layouts as itemset_count.cu (K1).
//
// An f32 product on the tensor cores is TF32 here, which keeps 10 mantissa
// bits and would round integer weights.  The reduction is done exactly in
// integers instead:
//   * containment on the CUDA cores, as in K1: one thread per target, its W
//     words in registers (W <= 4) or read through the L1 cache (any other
//     W), rows staged in shared memory.  Each thread writes its target's
//     0/1 containment bytes for the staged rows into shared memory, laid out
//     as the A operand (targets x rows, row-major);
//   * each int32 weight is split into 4 byte planes, so B is rows x (4 * C)
//     uint8 columns (column c * 4 + p = byte p of class c), zero-padded to a
//     multiple of 8 columns;
//   * mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 sums A x B into s32
//     accumulators: a warp owns 32 targets (two m16 tiles) and walks the
//     staged rows in k32 steps;
//   * after each staged step of kRows rows the planes are folded into the
//     count, p0 + (p1 << 8) + (p2 << 16) + (p3 << 24) in wrapping 32-bit
//     arithmetic, and the accumulators restart.  A plane's sum over one
//     step is at most 255 * kRows, far inside s32; unfolded it would reach
//     255 * N and overflow once a CTA summed about 2^23 rows.  The fold is
//     exact modulo 2^32 for any int32 weights, so it equals K1's wrapping
//     int32 sum, and the true count whenever that fits int32 (the weight-
//     total guards of the streaming sweep and the GFP backend ensure it).
//
// Bound: as K1, the integer pipe.  The containment test is N*K*W LOP3s on
// the 64 INT32 lanes per SM; the tensor-core work, 2*N*K*4C int8 operations,
// is about 15x smaller at the card's 1,979 TOP/s (roofline/kernel_model.py).
// So this route cannot beat K1's bound; it moves the C weight adds of each
// contained pair off the integer pipe and adds one packing step and a
// shared-memory byte store (a 32-bit store per 4 rows) per pair.
//
// Work split: gridDim.x tiles the targets (blockDim.x of them, a multiple of
// 32), gridDim.y splits N so that about one wave of CTAs is resident, each
// CTA folds into per-target counts in shared memory and ends with one
// atomicAdd per (k, c).  Classes are launched in groups of kClassGroup so
// that shared memory stays bounded for any C.  Ragged K and N are masked
// here: missing rows stage as zero weights, missing targets write nothing.
//
// Left for later: wgmma with TMA-fed, pipelined stages, and packing the
// containment bits of several rows per instruction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;               // rows staged per step: 4 k32 steps
constexpr int kRowWords = kRows / 4;     // packed containment words per target
// Word strides of the A and B tiles.  A: kAStride = 5 (mod 32) keeps the
// containment stores (thread i writes word i * kAStride + q) conflict-free
// and the fragment loads at most 2-way; B: kBStride = 4 (mod 32) makes the
// fragment loads (word g * kBStride + t) conflict-free.
constexpr int kAStride = kRowWords + 5;
constexpr int kBStride = kRowWords + 4;
constexpr int kClassGroup = 16;          // classes per kernel launch
constexpr int kMaxThreads = 256;
constexpr int kSmemBudget = 48 * 1024;

__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// W > 0: the target's W words in registers, rows staged in shared memory.
// W == 0: any width `nw`; target and row words read through the L1 cache.
template <int W>
__global__ void count_mxu_kernel(const uint32_t* __restrict__ tx,
                                 const uint32_t* __restrict__ tgt,
                                 const int32_t* __restrict__ wts,
                                 int32_t* __restrict__ out, long long n,
                                 long long k, int nw, int nc, int c0, int cg,
                                 long long rows_per_cta) {
  extern __shared__ uint32_t smem[];
  const int n_tiles = (cg + 1) / 2;                 // n8 tiles of B
  uint32_t* s_a = smem;                             // [blockDim.x][kAStride]
  uint32_t* s_b = s_a + blockDim.x * kAStride;      // [8 * n_tiles][kBStride]
  uint32_t* s_out = s_b + 8 * n_tiles * kBStride;   // [blockDim.x][cg]
  uint32_t* s_tx = s_out + blockDim.x * cg;         // [kRows][W], W > 0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;                          // fragment group
  const int t = lane & 3;                           // thread in group
  const int warp_row0 = tid & ~31;                  // the warp's 32 targets
  const long long kk = (long long)blockIdx.x * blockDim.x + tid;
  const bool active = kk < k;

  uint32_t treg[W > 0 ? W : 1];
#pragma unroll
  for (int i = 0; i < W; ++i) treg[i] = active ? tgt[kk * W + i] : 0u;
  for (int c = 0; c < cg; ++c) s_out[tid * cg + c] = 0u;
  // B columns past 4 * cg (cg odd) are zero for the whole kernel
  for (int i = tid; i < (8 * n_tiles - 4 * cg) * kBStride; i += blockDim.x)
    s_b[4 * cg * kBStride + i] = 0u;

  const long long r0 = (long long)blockIdx.y * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  for (long long base = r0; base < r1; base += kRows) {
    const int rows = (int)min((long long)kRows, r1 - base);
    __syncthreads();  // every warp has consumed the previous step's B and rows
    // weights as byte planes: word q of column c*4+p holds byte p of the
    // weights of rows 4q..4q+3 (row 4q in the lowest byte)
    for (int i = tid; i < cg * kRowWords; i += blockDim.x) {
      const int c = i / kRowWords;
      const int q = i - c * kRowWords;
      uint32_t w4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q * 4 + j;
        w4[j] = r < rows ? (uint32_t)wts[(base + r) * nc + c0 + c] : 0u;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) word |= ((w4[j] >> (8 * p)) & 0xFFu) << (8 * j);
        s_b[(c * 4 + p) * kBStride + q] = word;
      }
    }
    if constexpr (W > 0) {
      const uint32_t* gtx = tx + base * W;
      for (int i = tid; i < kRows * W; i += blockDim.x)
        s_tx[i] = i < rows * W ? gtx[i] : 0u;
    }
    __syncthreads();

    // containment of this thread's target against the staged rows -> A
    uint32_t* arow = s_a + tid * kAStride;
    for (int q = 0; q < kRowWords; ++q) {
      uint32_t word = 0;
      if (active) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q * 4 + j;
          bool hit;
          if constexpr (W > 0) {
            uint32_t miss = 0;
#pragma unroll
            for (int i = 0; i < W; ++i) miss |= treg[i] & ~s_tx[r * W + i];
            hit = miss == 0;
          } else {
            hit = r < rows;
            const uint32_t* row = tx + (base + r) * nw;
            for (int i = 0; i < nw && hit; ++i) {
              const uint32_t tw = __ldg(tgt + kk * nw + i);
              hit = (__ldg(row + i) & tw) == tw;
            }
          }
          word |= (uint32_t)hit << (8 * j);
        }
      }
      arow[q] = word;
    }
    __syncwarp();  // the warp's A rows are its own: no block barrier needed

    // the weighted reduction on the tensor cores, one n8 tile at a time
    const int p = 2 * (t & 1);        // planes p, p+1 in this thread's columns
    for (int nt = 0; nt < n_tiles; ++nt) {
      int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      const uint32_t* bcol = s_b + (nt * 8 + g) * kBStride;
#pragma unroll
      for (int ks = 0; ks < kRows / 32; ++ks) {
        const uint32_t b0 = bcol[ks * 8 + t];
        const uint32_t b1 = bcol[ks * 8 + 4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* a_lo = s_a + (warp_row0 + mt * 16 + g) * kAStride + ks * 8;
          const uint32_t* a_hi = a_lo + 8 * kAStride;
          mma_u8(d[mt], a_lo[t], a_hi[t], a_lo[4 + t], a_hi[4 + t], b0, b1);
        }
      }
      // fold: columns 2t, 2t+1 of tile nt are planes p, p+1 of class
      // nt*2 + t/2; the neighbour thread t^1 holds the other two planes
      const int c = nt * 2 + (t >> 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t lo = ((uint32_t)d[mt][0] << (8 * p)) +
                      ((uint32_t)d[mt][1] << (8 * p + 8));
        uint32_t hi = ((uint32_t)d[mt][2] << (8 * p)) +
                      ((uint32_t)d[mt][3] << (8 * p + 8));
        lo += __shfl_xor_sync(0xffffffffu, lo, 1);
        hi += __shfl_xor_sync(0xffffffffu, hi, 1);
        if ((t & 1) == 0 && c < cg) {
          s_out[(warp_row0 + mt * 16 + g) * cg + c] += lo;
          s_out[(warp_row0 + mt * 16 + g + 8) * cg + c] += hi;
        }
      }
    }
  }
  __syncwarp();
  if (active) {
    unsigned int* o = reinterpret_cast<unsigned int*>(out) + kk * nc + c0;
    for (int c = 0; c < cg; ++c) {
      const uint32_t v = s_out[tid * cg + c];
      if (v != 0u) atomicAdd(o + c, v);
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

size_t smem_bytes(int threads, int cg, int w_staged) {
  const int n_tiles = (cg + 1) / 2;
  return 4 * ((size_t)threads * kAStride + (size_t)8 * n_tiles * kBStride +
              (size_t)threads * cg + (size_t)kRows * w_staged);
}

template <int W>
cudaError_t launch_group(const uint32_t* tx, const uint32_t* tgt,
                         const int32_t* wts, int32_t* out, long long n,
                         long long k, int nw, int nc, int c0, int cg,
                         int threads, cudaStream_t stream) {
  size_t smem = smem_bytes(threads, cg, W);
  while (smem > (size_t)kSmemBudget && threads > 32) {
    threads /= 2;
    smem = smem_bytes(threads, cg, W);
  }
  const long long grid_x = (k + threads - 1) / threads;
  // split N so that about one wave of CTAs is resident on the SMs
  long long per_sm = 2048 / threads;
  const long long by_smem = (long long)(227 * 1024) / (long long)smem;
  if (by_smem < per_sm) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  const long long wave = (long long)sm_count() * per_sm;
  long long splits = (wave + grid_x - 1) / grid_x;
  const long long max_splits = (n + kRows - 1) / kRows;
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  long long rpc = (n + splits - 1) / splits;
  rpc = (rpc + kRows - 1) / kRows * kRows;
  const dim3 grid((unsigned)grid_x, (unsigned)((n + rpc - 1) / rpc));
  count_mxu_kernel<W><<<grid, threads, smem, stream>>>(
      tx, tgt, wts, out, n, k, nw, nc, c0, cg, rpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The argument list is itemset_count_launch's: threads is the requested
// number of targets per CTA (rounded up to a multiple of 32 and capped at
// kMaxThreads, then halved while shared memory exceeds 48 KB); tile_rows is
// accepted and ignored -- every CTA stages kRows rows per step.  The counts
// do not depend on either.
int itemset_count_mxu_launch(const void* tx, const void* tgt, const void* wts,
                             void* out, long long n, long long k, int nw,
                             int nc, int threads, int tile_rows,
                             int accumulate, void* stream_ptr) {
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
  int t = (threads + 31) / 32 * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  for (int c0 = 0; c0 < nc; c0 += kClassGroup) {
    const int cg = nc - c0 < kClassGroup ? nc - c0 : kClassGroup;
    cudaError_t e;
    if (nw == 1) e = launch_group<1>(x, g, w, o, n, k, nw, nc, c0, cg, t, stream);
    else if (nw == 2) e = launch_group<2>(x, g, w, o, n, k, nw, nc, c0, cg, t, stream);
    else if (nw == 3) e = launch_group<3>(x, g, w, o, n, k, nw, nc, c0, cg, t, stream);
    else if (nw == 4) e = launch_group<4>(x, g, w, o, n, k, nw, nc, c0, cg, t, stream);
    else e = launch_group<0>(x, g, w, o, n, k, nw, nc, c0, cg, t, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
