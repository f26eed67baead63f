// Multitude-targeted itemset counting on Hopper (sm_90a), with the weighted
// reduction as a b1 AND + POPC product on the tensor cores.
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
// The layout.  K1's layout pass (bitslice.cuh, route kRouteMxu) turns the
// rows into item columns of 32 rows a word and each class's weights into
// its 32 two's-complement bit planes, with live masks per stage and for the
// whole launch (the OR of the weights).  A target's containment over 32
// rows is then the AND h of its item columns, as in K1, and its count is
//   sum over live planes (c, b) of popc(h & plane_cb) << b   (mod 2^32),
// the wrapping int32 sum for any int32 weights (plane 31 is the sign).
//
// The product.  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// adds popc(a & b) over 256 rows for 16 targets (A, one AND word per
// target and row-word) x 8 planes (B, the staged plane columns): the AND
// words go to the tensor cores as they are, with no byte expansion.  A sum
// over k does not change when the same permutation of k is applied to A and
// B, so thread (g, t) of the fragment layout (lane = 4g + t; A rows g and
// g + 8, B column g, k-words t and 4 + t of each k256 step) takes row-words
// 4t .. 4t + 3 of a 16-row-word group over two k256 steps, read as one
// 16-byte load per column, as K1 reads them.  A warp owns 32 targets (two
// m16 tiles); its column loads and ANDs are K1's, per 4 row-words and
// target, and the B load of a plane is shared by the warp's 32 targets.
//
// Live planes.  Only live planes feed the tensor cores.  At CTA start one
// warp builds the list of live (class, bit) pairs from the whole-launch
// masks, bit-major (plane 0 of every class, then plane 1, ...), taken in
// groups of up to 16 (n8 tiles of 8 planes; 1 or 2 tiles a sweep).  Bit-major
// order packs the classes together and puts the rarely live high planes in
// the last tiles; per stage, a tile none of whose planes is live there
// (the stage's live masks) is skipped.  After a group's sweep each thread
// folds its accumulators, count[k, c] += acc[k, (c, b)] << b in wrapping
// uint32, sums the four threads of a fragment row with two shuffles, and
// adds it with one atomicAdd per (k, c).
//
// Why no overflow.  A plane's sum over a CTA's rows is at most those rows,
// below 2^24 under the route's N < 2^24 contract (the JAX package's f32
// exactness bound, kept by the wrapper), so the s32 accumulators never
// overflow; the fold is exact modulo 2^32.
//
// What bounds it.  The function needs, per target and 32 rows, the
// ceil((s - 1) / 2) LOP3s of the AND (on the INT32 lanes) and a b1 product
// of 2 * 32 bit operations per plane live in those rows (on the tensor
// cores; roofline/kernel_model.py counts both at the card's rates: on the
// H100 a b1 m16n8k256 issues at the rate of a u8 m16n8k32, 8x the int8
// operations, as the rate loop of b1_probe.cu measures).  The
// kernel's own cost is spread: taking out in turn the stage copies (every
// CTA copies all the columns of its stages from L2), the column loads and
// ANDs, the products or the per-stage barrier each saved a share at the
// main path's level 3, none most of it (PERF.md).  Measured slower and not
// kept: the stage copied by the bulk copy engine, one TMA copy per column
// (76 small copies a stage at the main path), the columns read through L1
// with no staging, the AND of a shared prefix loaded once for four
// consecutive targets, a third stage buffer.
//
// Work split and knobs: as K1's.  block_k targets per CTA (any value in
// [1, 1024]; ceil(block_k / 32) warps, ragged K masked), stages of
// ceil(block_n / 32) row-words rounded up to a multiple of 32 (bitslice.cuh),
// double-buffered with cp.async, split into at least 4 nearly full waves of
// CTAs.  CTAs whose largest target has at most 2 or 3 items run K1's
// unrolled 2- and 3-column loops; any larger target sends its CTA to the
// general loop.  More than 16 live planes (C > 1 with wide weights) go in
// groups, one sweep of the stages each.  W too wide for a stage in shared
// memory (above about 50) reads the columns from device memory.
//
// Left for later: wgmma with .b1 operands from shared memory, fed by TMA
// (the route after this one), and per-stage compaction of the live planes.

#include "bitslice.cuh"
#include "mma_b1.cuh"

namespace {

constexpr int kTargetsPerWarp = 32;   // two m16 tiles

// A thread's four targets: rows g and g + 8 of the warp's two m16 tiles,
// target i = 2 * tile + half at local index 32 * warp + 16 * tile + 8 * half
// + g of the CTA's block_k.
struct Targets {
  long long k0;         // the CTA's first target
  int local0;           // this thread's target 0, local to the CTA
  int block_k;
  long long k;
  __device__ __forceinline__ int local(int i) const {
    return local0 + 16 * (i >> 1) + 8 * (i & 1);
  }
  __device__ __forceinline__ bool valid(int i) const {
    return local(i) < block_k && k0 + local(i) < k;
  }
  __device__ __forceinline__ long long kk(int i) const { return k0 + local(i); }
};

// One sweep of the CTA's stages [st0, st1) over the plane group
// s_plane[0, np) (plane code 32 * c + b: scratch column ncols + code), then
// the fold into out.
template <int S, int NT, bool STAGED>
__device__ __forceinline__ void sweep(const Problem& p, const Sliced& s, int swp,
                      const Targets& tg, bool busy, int st0, int st1, int np,
                      const int* s_plane, int clo, int chi) {
  using Off = typename Cols<STAGED>::Off;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // words between two columns: in the stage buffer, or in the scratch
  const Off stride = (Off)(STAGED ? (long long)swp : s.nwp);
  Off off[4][S > 0 ? S : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (S > 0)
      decode_target<S>(p.tgt + tg.kk(i) * p.nw, tg.valid(i), p.nw, s.ncols,
                       stride, off[i]);
    else
      off[i][0] = 0;
  }
  // this thread's B column of each n8 tile: plane slot 8 * nt + g
  Off boff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int slot = min(8 * nt + g, np - 1);
    boff[nt] = (Off)(STAGED ? s.ncols + slot : s.ncols + s_plane[slot]) * stride;
  }
  // this lane's plane for the per-stage tile mask
  const int mycode = lane < np ? s_plane[lane] : -1;
  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int buf_words = (s.ncols + kPlaneGroup) * swp;
  const int ncols = s.ncols;
  auto src = [=](int col) -> long long {
    return col < ncols ? col : ncols + s_plane[col - ncols];
  };
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < kBuffers - 1; ++i) {
      if (st0 + i < st1)
        issue_stage(s, g_stage + i * buf_words, swp, st0 + i, ncols + np, src);
      cp_async_commit();
    }
  }
  // this lane's plane's live mask, loaded one stage ahead
  const uint32_t* lrow = s.live + (long long)(mycode >> 5) * s.nst;
  uint32_t lv_next = busy && mycode >= 0 && st0 < st1 ? __ldg(lrow + st0) : 0u;
  Cols<STAGED> cols;
  for (int st = st0; st < st1; ++st) {
    Off base;   // this stage's row-word 0 of column 0
    if constexpr (STAGED) {
      cp_async_wait<kBuffers - 2>();  // this thread's copies of stage st
      __syncthreads();  // stage st visible; stage st - 1's buffer is free
      const int next = st + kBuffers - 1;
      if (next < st1)
        issue_stage(s, g_stage + ((next - st0) % kBuffers) * buf_words, swp,
                    next, ncols + np, src);
      cp_async_commit();
      base = ((st - st0) % kBuffers) * buf_words;
    } else {
      cols.base = s.cols;
      base = (long long)st * s.sw;
    }
    if (!busy) continue;
    // the group's planes live in this stage, one bit per slot
    const uint32_t lv = lv_next;
    if (mycode >= 0 && st + 1 < st1) lv_next = __ldg(lrow + st + 1);
    const uint32_t smask =
        __ballot_sync(0xffffffffu, mycode >= 0 && ((lv >> (mycode & 31)) & 1u));
    if (smask == 0) continue;
    for (int q = 0; q < s.sw; q += 16) {
      const Off at = base + q + 4 * t;
      // B: this thread's plane column of each n8 tile; dead and pad planes
      // are zero (a dead plane's words are zero too)
      uint4 b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt] = (smask >> (8 * nt + g)) & 1u ? cols.at(at + boff[nt])
                                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A: the AND words of rows g and g + 8 (the general loop: an
        // invalid target is all ones)
        const uint4 lo = contained<S, STAGED>(
            cols, at, off[2 * mt], stride, p.tgt + tg.kk(2 * mt) * p.nw,
            tg.valid(2 * mt) ? p.nw : 0);
        const uint4 hi = contained<S, STAGED>(
            cols, at, off[2 * mt + 1], stride, p.tgt + tg.kk(2 * mt + 1) * p.nw,
            tg.valid(2 * mt + 1) ? p.nw : 0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (((smask >> (8 * nt)) & 0xffu) == 0) continue;
          mma_b1(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, b[nt].x, b[nt].y);
          mma_b1(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, b[nt].z, b[nt].w);
        }
      }
    }
  }
  if constexpr (STAGED) {
    cp_async_wait<0>();
    __syncthreads();  // the buffers are free for the next sweep
  }
  if (!busy) return;
  // the fold: D element (row, column 2t + j) is acc[mt][nt][2 * half + j]
  int code[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = 8 * nt + 2 * t + j;
      code[nt][j] = slot < np ? s_plane[slot] : -1;
    }
  for (int c = clo; c <= chi; ++c) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (code[nt][j] < 0 || (code[nt][j] >> 5) != c) continue;
        const int b = code[nt][j] & 31;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            v[2 * mt + half] += (uint32_t)acc[mt][nt][2 * half + j] << b;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
      if (t == 0 && tg.valid(i) && v[i] != 0u)
        atomicAdd(reinterpret_cast<unsigned int*>(p.out) + tg.kk(i) * p.nc + c,
                  v[i]);
    }
  }
}

template <int S, bool STAGED>
__device__ __forceinline__ void sweep_nt(const Problem& p, const Sliced& s, int swp,
                         const Targets& tg, bool busy, int st0, int st1,
                         int np, const int* s_plane, int clo, int chi) {
  if (np <= 8)
    sweep<S, 1, STAGED>(p, s, swp, tg, busy, st0, st1, np, s_plane, clo, chi);
  else
    sweep<S, 2, STAGED>(p, s, swp, tg, busy, st0, st1, np, s_plane, clo, chi);
}

// Warp 0 writes the group-th group of up to kPlaneGroup live planes,
// bit-major: lane b counts the live planes of bit b over the classes, a scan
// over the lanes gives each bit's first index, and each lane writes its
// planes whose index falls in the group.
__device__ __forceinline__ void next_group(const uint32_t* whole, int nc,
                                           int group, int* s_plane, int* s_np,
                                           int* s_clo, int* s_chi) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int c = 0; c < nc; ++c) cnt += (__ldg(whole + c) >> lane) & 1u;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int lo = group * kPlaneGroup;
  int idx = incl - cnt, clo = nc, chi = -1;
  for (int c = 0; c < nc && idx < lo + kPlaneGroup; ++c) {
    if (!((__ldg(whole + c) >> lane) & 1u)) continue;
    if (idx >= lo) {
      s_plane[idx - lo] = 32 * c + lane;
      clo = min(clo, c);
      chi = max(chi, c);
    }
    ++idx;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    clo = min(clo, __shfl_xor_sync(0xffffffffu, clo, d));
    chi = max(chi, __shfl_xor_sync(0xffffffffu, chi, d));
  }
  if (lane == 0) {
    *s_np = max(0, min(kPlaneGroup, total - lo));
    *s_clo = clo;
    *s_chi = chi;
  }
}

// MAXT: the largest CTA the instantiation runs: 256 (three CTAs of 256 an
// SM, which caps it at 85 registers a thread: more warps hide the loads'
// latency), 512, or 1024 when it must (64 registers).
template <bool STAGED, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == 256 ? 3 : 1)
count_mxu_kernel(Problem p, Sliced s, int block_k, int stages_per_cta,
                 int swp) {
  __shared__ int s_max, s_np, s_clo, s_chi;
  __shared__ int s_plane[kPlaneGroup];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int warp = threadIdx.x >> 5;
  Targets tg;
  tg.k0 = (long long)blockIdx.x * block_k;
  tg.local0 = kTargetsPerWarp * warp + g;
  tg.block_k = block_k;
  tg.k = p.k;
  int size = 0;
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!tg.valid(i)) continue;
    size = max(size, target_size(p.tgt + tg.kk(i) * p.nw, p.nw));
    any = true;
  }
  const bool busy = __any_sync(0xffffffffu, any);
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  if (size > 0) atomicMax(&s_max, size);
  const int st0 = blockIdx.y * stages_per_cta;
  const int st1 = min(s.nst, st0 + stages_per_cta);
  for (int group = 0;; ++group) {
    if (warp == 0) next_group(s.whole, p.nc, group, s_plane, &s_np, &s_clo,
                              &s_chi);
    __syncthreads();
    const int np = s_np;
    if (np == 0) break;
    const int smax = s_max, clo = s_clo, chi = s_chi;
    if (smax <= 2)
      sweep_nt<2, STAGED>(p, s, swp, tg, busy, st0, st1, np, s_plane, clo, chi);
    else if (smax == 3)
      sweep_nt<3, STAGED>(p, s, swp, tg, busy, st0, st1, np, s_plane, clo, chi);
    else
      sweep_nt<0, STAGED>(p, s, swp, tg, busy, st0, st1, np, s_plane, clo, chi);
    __syncthreads();   // s_plane is rewritten for the next group
  }
}

template <bool STAGED>
cudaError_t launch_count(const Problem& p, const Sliced& s, const Geometry& g,
                         int block_k, cudaStream_t stream) {
  const int threads = (int)cdiv(block_k, kTargetsPerWarp) * 32;
  auto kernel = threads <= 256   ? count_mxu_kernel<STAGED, 256>
                : threads <= 512 ? count_mxu_kernel<STAGED, 512>
                                 : count_mxu_kernel<STAGED, 1024>;
  const long long grid_x = cdiv(p.k, block_k);
  int per_cta = 0;
  cudaError_t e = prepare_count(kernel, threads, g.smem, grid_x, g.nst,
                                &per_cta);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)grid_x, (unsigned)cdiv(g.nst, per_cta));
  kernel<<<grid, threads, g.smem, stream>>>(p, s, block_k, per_cta, g.swp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout of n rows for block_n on route (0: K1, 1: K2): geometry_report
// of bitslice.cuh.
int itemset_count_geometry(long long n, int nw, int nc, int block_n, int route,
                           long long* out) {
  return geometry_report(n, nw, nc, block_n, route, out);
}

// K2's layout pass alone: writes its columns, live masks and whole-launch
// masks into `scratch` (out[3] of itemset_count_geometry with route 1) on
// `stream`; returns the cudaError_t.
int itemset_count_mxu_layout(const void* tx, const void* wts, void* scratch,
                             long long scratch_len, long long n, int nw,
                             int nc, int block_n, void* stream_ptr) {
  return layout_only<kRouteMxu>(tx, wts, scratch, scratch_len, n, nw, nc,
                                block_n, stream_ptr);
}

// One count: the layout pass, then the count kernel, on `stream`; the
// argument list is itemset_count_launch's.  With accumulate = 0 `out` is
// zeroed first; with 1 the counts are added into it.  Returns the
// cudaError_t of the first failing step (0 = success).
int itemset_count_mxu_launch(const void* tx, const void* tgt, const void* wts,
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
  const Geometry g = geometry(n, nw, nc, block_n, kRouteMxu);
  if (scratch_len < scratch_words(nw, nc, g, kRouteMxu))
    return (int)cudaErrorInvalidValue;
  Problem p = problem(tx, wts, n, nw, nc);
  p.tgt = static_cast<const uint32_t*>(tgt);
  p.out = static_cast<int32_t*>(out);
  p.k = k;
  const Sliced s =
      sliced_view(static_cast<uint32_t*>(scratch), nw, nc, g, kRouteMxu);
  cudaError_t e = launch_layout<kRouteMxu>(p, s, stream);
  if (e != cudaSuccess) return (int)e;
  e = g.staged ? launch_count<true>(p, s, g, block_k, stream)
               : launch_count<false>(p, s, g, block_k, stream);
  return (int)e;
}

}  // extern "C"
