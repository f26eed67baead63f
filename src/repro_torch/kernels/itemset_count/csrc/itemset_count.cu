// Multitude-targeted itemset counting on Hopper (sm_90a), bit-sliced.
//
// Replaces the Pallas TPU kernel src/repro/kernels/itemset_count/kernel.py
// (_itemset_count_kernel with accum="vpu_int32", launched by
// itemset_counts_pallas) and its accumulate-into use
// (src/repro/kernels/itemset_count/ops.py::itemset_counts_into).
//
//   out[k, c] (+)= sum_n w[n, c] * [ for all words j: tx[n, j] & tgt[k, j] == tgt[k, j] ]
//
// tx (N, W) uint32 row-major, tgt (K, W) uint32, w (N, C) int32, out (K, C)
// int32; sums wrap modulo 2^32.
//
// What bounds it.  Read row by row ("horizontally"), the containment test
// costs one LOP3 per word for every (row, target) pair, N*K*W operations on
// the 64 INT32 lanes of each SM, against only 4*(N + K)*(W + C) bytes: the
// kernel is bound by integer operations, hundreds per byte.  At the
// main-path geometries (W = 2, targets of 1-3 items) that is two LOP3s and
// a predicated weight add per pair, and the instructions around them (row
// loads, loop) cost more than the test itself.
//
// The bit-sliced design.  A first pass (layout_kernel) turns the rows into
// item columns: column i holds bit i of 32 consecutive rows in one word
// (one __ballot_sync per item bit over a warp of 32 rows), so the test of a
// target of s items over 32 rows is the AND of its s column words:
// ceil((s - 1) / 2) three-input LOP3s per 32 rows, whatever W is.  A last
// all-ones column stands for the empty itemset.  The weights are split the
// same way: each class's odd plane (bit 0 of its weights), and one heavy
// column marking the rows whose weight is neither 0 nor 1 in some class;
// per stage of rows, each class's live mask is the OR of its weights (bit b
// set iff bit plane b has a set bit there).  With h the target's AND word,
// the count kernel adds popc(h & odd) for each class whose bit 0 is live,
// and walks the set bits of h & heavy (none in most words: weights are
// dedup multiplicities, mostly 1) adding w & ~1 from the weights in device
// memory.  Both parts wrap modulo 2^32 as K1's int32 sums do, for any int32
// weights.  This costs one LOP3 + POPC per class and one LOP3 per 32 rows and
// target.  (Popcounting all 32 two's-complement bit planes over the live
// ones instead costs a POPC per live plane, and the main-path weights keep
// several planes live; walking every set bit of h costs a load per
// contained row.  Both were measured slower, PERF.md.)
//
// The layout, its stage geometry and the layout pass are bitslice.cuh's
// (route kRouteVpu), shared with K2 (itemset_count_mxu.cu).
//
// The count kernel.  A CTA owns block_k targets, one thread each (the CTA
// runs ceil(block_k / 32) warps; threads past block_k only help with the
// copies), and a range of whole stages (gridDim.y splits the stages into
// at least four waves of resident CTAs, the last one nearly full: CTAs take
// unequal times, and a grid of one wave and a few CTAs doubles the tail).  Each thread decodes its target
// once into the offsets of its item columns in shared memory; a CTA whose
// largest target has at most 2 or 3 items (the main path's, and the GFP
// hybrid's) runs an unrolled loop of 2 or 3 columns, in which smaller
// targets read the all-ones column for their missing items; any larger
// target sends its CTA to a general loop that walks the target's words.
// Every
// stage's columns (items, all-ones, heavy, the odd planes of the classes
// counted) are copied into shared memory with cp.async, double-buffered
// (the next stage's copy runs under this stage's count; deeper rings were
// measured slower), and read four row-words at a time (16-byte loads; a column's stride is 4
// mod 8 words, so eight consecutive items hit eight distinct bank
// groups).  The threads
// count in uint32 registers and end with one atomicAdd per (k, c): integer
// sums are exact in any order.  More than 2 classes go in groups of 4, one
// sweep of the stages each.
//
// Every W and C the plain version accepts runs here.  When not even a stage
// of 4 row-words fits in shared memory (W above about 200) the kernel reads
// the columns from device memory instead.
//
// The knobs.  block_k is any value in [1, 1024].  block_n is any value >= 1:
// the stage is ceil(block_n / 32) row-words rounded up to a multiple of 4
// (128 rows), as bitslice.cuh sets it.
//
// Left for later: sharing the AND of a common prefix of items across
// targets (lexicographic candidates share all but their last item), copying
// only the columns a CTA's targets use, TMA multicast of the stage to the
// CTAs of a cluster, a carry-save (Harley-Seal) reduction that pays fewer
// POPCs for several classes.  (K2, itemset_count_mxu.cu, reduces the same
// AND words with the b1 tensor-core product.)

#include "bitslice.cuh"

namespace {

// acc[c] += popc(h & odd plane of class c0 + c) for the classes whose bit 0
// is live (lm[c] & 1); that plane lies at offset odd + c * stride.
template <int CG, bool STAGED>
__device__ __forceinline__ void add_odd(const uint4& h, const Cols<STAGED>& cols,
                                        typename Cols<STAGED>::Off odd,
                                        typename Cols<STAGED>::Off stride,
                                        const uint32_t (&lm)[CG],
                                        uint32_t (&acc)[CG]) {
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    if (lm[c] & 1u) {
      const uint4 v = cols.at(odd + c * stride);
      acc[c] += __popc(h.x & v.x) + __popc(h.y & v.y) + __popc(h.z & v.z) +
                __popc(h.w & v.w);
    }
  }
}

// acc[c] += w & ~1 of class c0 + c for each row set in x (4 row-words from
// global row-word g), the weights read from device memory.
template <int CG>
__device__ __forceinline__ void add_heavy(const uint4& x, const Problem& p, long long g,
                          int c0, int gn, uint32_t (&acc)[CG]) {
  const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t m = xw[q];
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      const int32_t* wr = p.wts + ((g + q) * 32 + b) * p.nc + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c < gn) acc[c] += (uint32_t)__ldg(wr + c) & ~1u;
    }
  }
}

// One sweep of the CTA's stages [st0, st1) for classes [c0, c0 + gn).
template <int S, int CG, bool STAGED>
__device__ void sweep(const Problem& p, const Sliced& s, int swp, bool valid,
                      const uint32_t* trow, int st0, int st1, int c0, int gn,
                      uint32_t (&acc)[CG]) {
  using Off = typename Cols<STAGED>::Off;
  // words between two columns: in the stage buffer, or in the scratch
  const Off stride = (Off)(STAGED ? (long long)swp : s.nwp);
  Off off[S > 0 ? S : 1];
  if constexpr (S > 0) {
    decode_target<S>(trow, valid, p.nw, s.ncols, stride, off);
  } else {
    off[0] = 0;
  }
  if (st0 >= st1) return;
  const int buf_words = (s.ncols + 1 + CG) * swp;
  // the item, all-ones and heavy columns, then the odd planes of classes
  // [c0, c0 + gn)
  const int lead = s.ncols + 1;
  auto src = [=](int col) -> long long { return col < lead ? col : col + c0; };
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < kBuffers - 1; ++i) {
      if (st0 + i < st1)
        issue_stage(s, g_stage + i * buf_words, swp, st0 + i, lead + gn, src);
      cp_async_commit();
    }
  }
  Cols<STAGED> cols;
  for (int st = st0; st < st1; ++st) {
    Off base;   // this stage's row-word 0 of column 0
    Off odd;    // the odd plane of class c0, from column 0
    if constexpr (STAGED) {
      cp_async_wait<kBuffers - 2>();  // this thread's copies of stage st
      __syncthreads();  // stage st visible; stage st - 1's buffer is free
      const int next = st + kBuffers - 1;
      if (next < st1)
        issue_stage(s, g_stage + ((next - st0) % kBuffers) * buf_words, swp,
                    next, lead + gn, src);
      cp_async_commit();
      base = ((st - st0) % kBuffers) * buf_words;
      odd = (s.ncols + 1) * stride;
    } else {
      cols.base = s.cols;
      base = (long long)st * s.sw;
      odd = (s.ncols + 1LL + c0) * stride;
    }
    if (!valid) continue;
    uint32_t lm[CG];
    uint32_t high = 0;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      lm[c] = c < gn ? __ldg(s.live + (long long)(c0 + c) * s.nst + st) : 0u;
      high |= lm[c] & ~1u;
    }
    const Off hv = s.ncols * stride;
    for (int q = 0; q < s.sw; q += 4) {
      const Off at = base + q;
      const uint4 h = contained<S, STAGED>(cols, at, off, stride, trow, p.nw);
      add_odd<CG, STAGED>(h, cols, at + odd, stride, lm, acc);
      if (high) {
        uint4 x = cols.at(at + hv);
        and4(x, h);
        if ((x.x | x.y | x.z | x.w) != 0u)
          add_heavy<CG>(x, p, (long long)st * s.sw + q, c0, gn, acc);
      }
    }
  }
  if constexpr (STAGED) {
    cp_async_wait<0>();
    __syncthreads();  // the buffers are free for the next sweep
  }
}

// MAXT: the largest CTA the instantiation runs (256, or 1024 when it must,
// which caps it at 64 registers a thread).
template <int CG, bool STAGED, int MAXT>
__global__ void __launch_bounds__(MAXT)
count_kernel(Problem p, Sliced s, int block_k, int stages_per_cta, int swp) {
  __shared__ int s_max;
  const long long kk = (long long)blockIdx.x * block_k + threadIdx.x;
  const bool valid = (int)threadIdx.x < block_k && kk < p.k;
  const uint32_t* trow = p.tgt + (valid ? kk : 0) * p.nw;
  const int size = valid ? target_size(trow, p.nw) : 0;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  if (valid) atomicMax(&s_max, size);
  __syncthreads();
  const int smax = s_max;
  const int st0 = blockIdx.y * stages_per_cta;
  const int st1 = min(s.nst, st0 + stages_per_cta);
  for (int c0 = 0; c0 < p.nc; c0 += CG) {
    const int gn = min(CG, p.nc - c0);
    uint32_t acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0;
    if (smax <= 2)
      sweep<2, CG, STAGED>(p, s, swp, valid, trow, st0, st1, c0, gn, acc);
    else if (smax == 3)
      sweep<3, CG, STAGED>(p, s, swp, valid, trow, st0, st1, c0, gn, acc);
    else
      sweep<0, CG, STAGED>(p, s, swp, valid, trow, st0, st1, c0, gn, acc);
    if (valid) {
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c < gn && acc[c] != 0) atomicAdd(p.out + kk * p.nc + c0 + c, (int)acc[c]);
    }
  }
}

template <int CG, bool STAGED>
cudaError_t launch_count_t(const Problem& p, const Sliced& s, const Geometry& g,
                           int block_k, cudaStream_t stream) {
  const int threads = (int)cdiv(block_k, 32) * 32;
  auto kernel = threads <= 256 ? count_kernel<CG, STAGED, 256>
                               : count_kernel<CG, STAGED, 1024>;
  const long long grid_x = cdiv(p.k, block_k);
  int per_cta = 0;
  cudaError_t e = prepare_count(kernel, threads, g.smem, grid_x, g.nst,
                                &per_cta);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)grid_x, (unsigned)cdiv(g.nst, per_cta));
  kernel<<<grid, threads, g.smem, stream>>>(p, s, block_k, per_cta, g.swp);
  return cudaGetLastError();
}

template <int CG>
cudaError_t launch_count_cg(const Problem& p, const Sliced& s,
                            const Geometry& g, int block_k,
                            cudaStream_t stream) {
  if (g.staged) return launch_count_t<CG, true>(p, s, g, block_k, stream);
  return launch_count_t<CG, false>(p, s, g, block_k, stream);
}

}  // namespace

extern "C" {

// The layout of n rows for block_n on route (0: K1, 1: K2): geometry_report
// of bitslice.cuh.
int itemset_count_geometry(long long n, int nw, int nc, int block_n, int route,
                           long long* out) {
  return geometry_report(n, nw, nc, block_n, route, out);
}

// K1's layout pass alone: writes its columns and live masks into `scratch`
// (out[3] of the geometry) on `stream`; returns the cudaError_t.
int itemset_count_layout(const void* tx, const void* wts, void* scratch,
                         long long scratch_len, long long n, int nw, int nc,
                         int block_n, void* stream_ptr) {
  return layout_only<kRouteVpu>(tx, wts, scratch, scratch_len, n, nw, nc,
                                block_n, stream_ptr);
}

// One count: the layout pass, then the count kernel, on `stream`.  With
// accumulate = 0 `out` is zeroed first; with 1 the counts are added into
// it.  Returns the cudaError_t of the first failing step (0 = success).
int itemset_count_launch(const void* tx, const void* tgt, const void* wts,
                         void* out, void* scratch, long long scratch_len,
                         long long n, long long k, int nw, int nc,
                         int block_k, int block_n, int accumulate,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || k < 0 || nw < 1 || nc < 1 || block_k < 1 || block_k > 1024 ||
      block_n < 1)
    return (int)cudaErrorInvalidValue;
  if (!accumulate) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)k * nc * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0 || k == 0) return (int)cudaSuccess;
  const Geometry g = geometry(n, nw, nc, block_n, kRouteVpu);
  if (scratch_len < scratch_words(nw, nc, g, kRouteVpu))
    return (int)cudaErrorInvalidValue;
  Problem p = problem(tx, wts, n, nw, nc);
  p.tgt = static_cast<const uint32_t*>(tgt);
  p.out = static_cast<int32_t*>(out);
  p.k = k;
  const Sliced s =
      sliced_view(static_cast<uint32_t*>(scratch), nw, nc, g, kRouteVpu);
  cudaError_t e = launch_layout<kRouteVpu>(p, s, stream);
  if (e != cudaSuccess) return (int)e;
  if (g.cg == 1) e = launch_count_cg<1>(p, s, g, block_k, stream);
  else if (g.cg == 2) e = launch_count_cg<2>(p, s, g, block_k, stream);
  else e = launch_count_cg<kClassGroup>(p, s, g, block_k, stream);
  return (int)e;
}

}  // extern "C"
