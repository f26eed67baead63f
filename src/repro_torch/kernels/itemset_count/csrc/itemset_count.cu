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
// Layout of the scratch (uint32 words, allocated by the caller):
//   cols   [32*W + 2 + C][nwp]   item columns, the all-ones column, the heavy
//                                column, the C odd planes
//   live   [C][nst]              live planes per stage
// with sw row-words (32 rows each) per stage, nst = ceil(ceil(N/32) / sw)
// stages and nwp = nst * sw; pad rows are zero in every column but the
// all-ones one.  This file alone owns the layout and the stage geometry:
// itemset_count_geometry gives the wrapper the sizes and offsets.
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
// (128 rows), no more than the rows need, and halved (rounded up to a
// multiple of 4) until the four stage buffers fit in 227 KB.
//
// Left for later: sharing the AND of a common prefix of items across
// targets (lexicographic candidates share all but their last item), copying
// only the columns a CTA's targets use, TMA multicast of the stage to the
// CTAs of a cluster, a carry-save (Harley-Seal) reduction that pays fewer
// POPCs for several classes, and the b1 tensor-core product
// (mma.sync ... b1.and.popc) for the popcounts.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kClassGroup = 4;   // classes per sweep when C > 2
constexpr int kBuffers = 2;      // stage buffers: one counted, one copying
constexpr int kMinWaves = 4;     // waves of resident CTAs a count splits into

struct Problem {
  const uint32_t* tx;   // (n, nw)
  const int32_t* wts;   // (n, nc)
  const uint32_t* tgt;  // (k, nw)
  int32_t* out;         // (k, nc)
  long long n, k;
  int nw, nc;
};

struct Sliced {
  uint32_t* cols;       // (ncols + 1 + nc, nwp): items, all-ones, heavy, odd
  uint32_t* live;       // (nc, nst)
  long long nwp;        // row-words, padded to whole stages
  int nst;              // stages
  int sw;               // row-words per stage, a multiple of 4
  int ncols;            // item columns and the all-ones one: 32 * nw + 1
};

struct Geometry {
  int sw, nst, cg, swp;
  long long nwp;
  bool staged;
  size_t smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Words between two staged columns: >= sw and 4 mod 8.
int padded_stride(int sw) { return (sw / 4) % 2 == 0 ? sw + 4 : sw; }

int class_group(int nc) { return nc <= 2 ? nc : kClassGroup; }

// The stage buffers: the item columns, the all-ones and heavy columns and
// the odd planes of a class group.
size_t stage_smem(int nw, int cg, int sw) {
  return (size_t)kBuffers * (32 * nw + 2 + cg) * padded_stride(sw) * 4;
}

Geometry geometry(long long n, int nw, int nc, int block_n) {
  Geometry g;
  g.cg = class_group(nc);
  long long words = cdiv(n, 32);
  long long sw = cdiv(cdiv(block_n, 32), 4) * 4;
  const long long need = cdiv(words, 4) * 4;
  if (sw > need) sw = need;
  if (sw < 4) sw = 4;
  while (sw > 4 && stage_smem(nw, g.cg, (int)sw) > (size_t)kMaxSmemBytes)
    sw = cdiv(sw / 2, 4) * 4;
  g.sw = (int)sw;
  g.swp = padded_stride(g.sw);
  g.nst = (int)cdiv(words, sw);
  g.nwp = (long long)g.nst * sw;
  g.smem = stage_smem(nw, g.cg, g.sw);
  g.staged = g.smem <= (size_t)kMaxSmemBytes;
  if (!g.staged) g.smem = 0;
  return g;
}

long long scratch_words(long long n, int nw, int nc, const Geometry& g) {
  return (long long)(32 * nw + 2 + nc) * g.nwp + (long long)nc * g.nst;
}

Sliced sliced_view(uint32_t* scratch, int nw, int nc, const Geometry& g) {
  Sliced s;
  s.ncols = 32 * nw + 1;
  s.nwp = g.nwp;
  s.nst = g.nst;
  s.sw = g.sw;
  s.cols = scratch;
  s.live = scratch + (long long)(s.ncols + 1 + nc) * g.nwp;
  return s;
}

// ---- layout pass --------------------------------------------------------

// One CTA of 32 warps turns 32 row-words (1024 rows) into column words: warp
// w ballots the bits of rows 32*(j0 + w) + lane, and a 32 x 32 tile in
// shared memory turns the ballots around so that the stores are coalesced.
__global__ void __launch_bounds__(1024) layout_kernel(Problem p, Sliced s) {
  __shared__ uint32_t tile[32][33];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long j0 = (long long)blockIdx.x * 32;
  const long long j = j0 + wid;             // this warp's row-word
  const long long r = j * 32 + lane;        // this thread's row
  const bool in = r < p.n;
  const long long jo = j0 + lane;           // this thread's stored word
  const bool out_ok = jo < s.nwp;
  for (int i = 0; i < p.nw; ++i) {
    const uint32_t x = in ? __ldg(p.tx + r * p.nw + i) : 0u;
    uint32_t mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t v = __ballot_sync(0xffffffffu, (x >> b) & 1u);
      if (lane == b) mine = v;
    }
    tile[lane][wid] = mine;                 // column 32i + lane, word j
    __syncthreads();
    if (out_ok) s.cols[(32LL * i + wid) * s.nwp + jo] = tile[wid][lane];
    __syncthreads();
  }
  if (wid == 0 && out_ok) s.cols[(32LL * p.nw) * s.nwp + jo] = 0xffffffffu;
  // the weights: odd planes, the heavy column, live masks; one word per
  // warp, stored by its lane 0
  uint32_t heavy = 0;
  for (int c = 0; c < p.nc; ++c) {
    const uint32_t x = in ? (uint32_t)__ldg(p.wts + r * p.nc + c) : 0u;
    const uint32_t odd = __ballot_sync(0xffffffffu, x & 1u);
    heavy |= __ballot_sync(0xffffffffu, (x & ~1u) != 0u);
    const uint32_t any = __reduce_or_sync(0xffffffffu, x);
    if (lane == 0 && j < s.nwp) {
      s.cols[(s.ncols + 1LL + c) * s.nwp + j] = odd;
      if (any != 0) atomicOr(s.live + (long long)c * s.nst + j / s.sw, any);
    }
  }
  if (lane == 0 && j < s.nwp) s.cols[(long long)s.ncols * s.nwp + j] = heavy;
}

// ---- count kernel -------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of the most recent copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The count kernel's stage buffers.  Indexed by word offsets (not generic
// pointers), so that its loads compile to LDS with 32-bit addresses.
extern __shared__ __align__(16) uint32_t g_stage[];

// Where a stage's columns are read: the stage buffers in shared memory
// (offsets in words from g_stage) or device memory (offsets in words from
// the scratch's column 0).
template <bool STAGED>
struct Cols;

template <>
struct Cols<true> {
  using Off = int;
  __device__ __forceinline__ uint4 at(int off) const {
    return *reinterpret_cast<const uint4*>(g_stage + off);
  }
};

template <>
struct Cols<false> {
  using Off = long long;
  const uint32_t* base;
  __device__ __forceinline__ uint4 at(long long off) const {
    return ld4(base + off);
  }
};

__device__ __forceinline__ void and4(uint4& h, const uint4& v) {
  h.x &= v.x;
  h.y &= v.y;
  h.z &= v.z;
  h.w &= v.w;
}

// Copy stage `st` into the buffer `buf`: the item, all-ones and heavy
// columns, then the odd planes of classes [c0, c0 + gn).
__device__ void issue_stage(const Sliced& s, uint32_t* buf, int swp, int st,
                            int c0, int gn) {
  const int q4 = s.sw / 4;
  const long long g0 = (long long)st * s.sw;
  const int lead = s.ncols + 1;
  for (int i = threadIdx.x; i < (lead + gn) * q4; i += blockDim.x) {
    const int col = i / q4;
    const int q = i - col * q4;
    const long long src = col < lead ? col : col + c0;
    cp_async16(buf + col * swp + 4 * q, s.cols + src * s.nwp + g0 + 4 * q);
  }
}

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

// The AND word of a target of up to S items whose column offsets (from the
// row-word group's) are off[] (missing items read the all-ones column), or,
// for S == 0, of any target, walking its words (the general loop).
template <int S, bool STAGED>
__device__ __forceinline__ uint4 contained(
    const Cols<STAGED>& cols, typename Cols<STAGED>::Off q,
    const typename Cols<STAGED>::Off (&off)[S > 0 ? S : 1],
    typename Cols<STAGED>::Off stride, const uint32_t* trow, int nw) {
  if constexpr (S > 0) {
    uint4 h = cols.at(q + off[0]);
#pragma unroll
    for (int i = 1; i < S; ++i) and4(h, cols.at(q + off[i]));
    return h;
  } else {
    uint4 h = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (int i = 0; i < nw; ++i) {
      uint32_t m = __ldg(trow + i);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        and4(h, cols.at(q + (32 * i + b) * stride));
      }
    }
    return h;
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
    int wi = valid ? 0 : p.nw;
    uint32_t m = valid ? __ldg(trow) : 0u;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      while (m == 0 && wi + 1 < p.nw) m = __ldg(trow + ++wi);
      int col = s.ncols - 1;               // the all-ones column
      if (m) {
        col = 32 * wi + __ffs(m) - 1;
        m &= m - 1;
      }
      off[q] = col * stride;
    }
  } else {
    off[0] = 0;
  }
  if (st0 >= st1) return;
  const int buf_words = (s.ncols + 1 + CG) * swp;
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < kBuffers - 1; ++i) {
      if (st0 + i < st1)
        issue_stage(s, g_stage + i * buf_words, swp, st0 + i, c0, gn);
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
                    next, c0, gn);
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
  int size = 0;
  if (valid)
    for (int i = 0; i < p.nw; ++i) size += __popc(__ldg(trow + i));
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

cudaError_t launch_layout(const Problem& p, const Sliced& s,
                          cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(s.live, 0, (size_t)p.nc * s.nst * 4, stream);
  if (e != cudaSuccess) return e;
  layout_kernel<<<(unsigned)cdiv(s.nwp, 32), 1024, 0, stream>>>(p, s);
  return cudaGetLastError();
}

// The host work of a count launch that depends only on the launch's shape,
// done once per shape: the kernel's shared-memory attribute (raised, never
// lowered, per device) and the split of the stages over gridDim.y.
std::mutex g_mu;
std::map<std::pair<int, const void*>, size_t> g_smem_set;
std::map<std::tuple<int, const void*, int, size_t, long long, int>, int>
    g_per_cta;

// Split the stages over gridDim.y into at least kMinWaves waves of resident
// CTAs (CTAs take unequal times: heavy rows and hits cluster), the fewest
// splits whose last wave is at least 90 % full, else the fullest (each CTA
// ends with block_k * C atomics).  Returns the stages per CTA.
int stages_per_cta(long long wave, long long grid_x, int nst) {
  long long most = 4 * cdiv(kMinWaves * wave, grid_x);
  if (most > nst) most = nst;
  if (most > 65535) most = 65535;
  int per_cta = nst;
  double best = -1.0;
  for (long long splits = 1; splits <= most; ++splits) {
    const int pc = (int)cdiv(nst, splits);
    const long long ctas = grid_x * cdiv(nst, pc);
    const double fill = (double)ctas / (double)(cdiv(ctas, wave) * wave);
    const bool enough = ctas > (kMinWaves - 1) * wave;
    const double score = fill + (enough ? 1.0 : 0.0) + (fill >= 0.9 ? 1.0 : 0.0);
    if (score > best + 1e-9) {
      best = score;
      per_cta = pc;
      if (enough && fill >= 0.9) break;
    }
  }
  return per_cta;
}

template <typename Kernel>
cudaError_t prepare_count(Kernel kernel, int threads, size_t smem,
                          long long grid_x, int nst, int* per_cta) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_mu);
  const auto key = std::make_tuple(dev, fn, threads, smem, grid_x, nst);
  const auto hit = g_per_cta.find(key);
  if (hit != g_per_cta.end()) {
    *per_cta = hit->second;
    return cudaSuccess;
  }
  size_t& set = g_smem_set[{dev, fn}];
  if (smem > 48 * 1024 && smem > set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long wave = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  *per_cta = stages_per_cta(wave, grid_x, nst);
  if (g_per_cta.size() >= 4096) g_per_cta.clear();   // stays small
  g_per_cta[key] = *per_cta;
  return cudaSuccess;
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

Problem problem(const void* tx, const void* wts, long long n, int nw, int nc) {
  Problem p{};
  p.tx = static_cast<const uint32_t*>(tx);
  p.wts = static_cast<const int32_t*>(wts);
  p.n = n;
  p.nw = nw;
  p.nc = nc;
  return p;
}

}  // namespace

extern "C" {

// K1's layout of n rows for block_n, in uint32 words: out[0] row-words per
// stage (sw), out[1] stages (nst), out[2] row-words padded to whole stages
// (nwp), out[3] the scratch's length, out[4..6] the offsets of the heavy
// column, the first odd plane and the live masks (the 32 * nw + 1 item and
// all-ones columns start at 0).  Returns the cudaError_t.
int itemset_count_geometry(long long n, int nw, int nc, int block_n,
                           long long* out) {
  if (n < 1 || nw < 1 || nc < 1 || block_n < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, nw, nc, block_n);
  const long long ncols = 32LL * nw + 1;
  out[0] = g.sw;
  out[1] = g.nst;
  out[2] = g.nwp;
  out[3] = scratch_words(n, nw, nc, g);
  out[4] = ncols * g.nwp;
  out[5] = (ncols + 1) * g.nwp;
  out[6] = (ncols + 1 + nc) * g.nwp;
  return (int)cudaSuccess;
}

// The layout pass alone: writes cols and live into `scratch`
// (scratch_words of them) on `stream`; returns the cudaError_t.
int itemset_count_layout(const void* tx, const void* wts, void* scratch,
                         long long scratch_len, long long n, int nw, int nc,
                         int block_n, void* stream_ptr) {
  if (n < 1 || nw < 1 || nc < 1 || block_n < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, nw, nc, block_n);
  if (scratch_len < scratch_words(n, nw, nc, g)) return (int)cudaErrorInvalidValue;
  const Problem p = problem(tx, wts, n, nw, nc);
  const Sliced s = sliced_view(static_cast<uint32_t*>(scratch), nw, nc, g);
  return (int)launch_layout(p, s, static_cast<cudaStream_t>(stream_ptr));
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
  const Geometry g = geometry(n, nw, nc, block_n);
  if (scratch_len < scratch_words(n, nw, nc, g)) return (int)cudaErrorInvalidValue;
  Problem p = problem(tx, wts, n, nw, nc);
  p.tgt = static_cast<const uint32_t*>(tgt);
  p.out = static_cast<int32_t*>(out);
  p.k = k;
  const Sliced s = sliced_view(static_cast<uint32_t*>(scratch), nw, nc, g);
  cudaError_t e = launch_layout(p, s, stream);
  if (e != cudaSuccess) return (int)e;
  if (g.cg == 1) e = launch_count_cg<1>(p, s, g, block_k, stream);
  else if (g.cg == 2) e = launch_count_cg<2>(p, s, g, block_k, stream);
  else e = launch_count_cg<kClassGroup>(p, s, g, block_k, stream);
  return (int)e;
}

}  // extern "C"
