// The bit-sliced layout of the itemset-count kernels (sm_90a): the one owner
// of the layout's geometry, its scratch, the layout pass, the stage copy,
// the target decode and the split of the stages over the grid.  Included by
// itemset_count.cu (K1, route kRouteVpu) and itemset_count_mxu.cu (K2,
// route kRouteMxu); each builds into its own library, so everything here
// lives in an unnamed namespace.
//
// The layout pass (layout_kernel) turns the rows into item columns: column
// i holds bit i of 32 consecutive rows in one word (a bit transpose over a
// warp of 32 rows), so the test of a target of s items over
// 32 rows is the AND of its s column words.  A last all-ones column stands
// for the empty itemset.  The weights are sliced the same way, per route:
//
//   K1: cols [32*W + 2 + C][nwp]  item columns, the all-ones column, one
//                                 heavy column (rows whose weight is neither
//                                 0 nor 1 in some class), each class's odd
//                                 plane (bit 0 of its weights)
//       live [C][nst]             per stage, the OR of each class's weights
//   K2: cols [32*W + 1 + 32*C][nwp] item columns, the all-ones column, the
//                                 32 two's-complement bit planes of each
//                                 class (plane b of class c at column
//                                 32*W + 1 + 32*c + b)
//       live [C][nst]             as K1's
//       whole [C]                 the OR of all of each class's weights
//
// with sw row-words (32 rows each) per stage, nst = ceil(ceil(N/32) / sw)
// stages and nwp = nst * sw; pad rows are zero in every column but the
// all-ones one.  geometry_report below (exported by each library as
// itemset_count_geometry) gives the wrapper the sizes and offsets.
//
// The stage: K1 counts four row-words at a time (16-byte loads), so its stage
// is a multiple of 4 row-words (128 rows); K2's tensor-core step takes 16
// row-words (two k256 products), and its stage is a multiple of 32 (1024 rows,
// two steps: stages of one step cost more in waits and copies than they
// counted). block_n >= 1 sets it: ceil(block_n / 32) row-words rounded up to
// the route's multiple, no more than the rows need, and halved (rounded up to
// the multiple) until the stage buffers fit in shared memory; when not even the
// smallest stage fits (W above about 200 for K1, about 50 for K2) the count
// kernel reads the columns from device memory instead.

#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kRouteVpu = 0;          // K1: popcounts on the CUDA cores
constexpr int kRouteMxu = 1;          // K2: b1 products on the tensor cores
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kClassGroup = 4;        // K1: classes per sweep when C > 2
constexpr int kPlaneGroup = 16;       // K2: live planes per sweep
constexpr int kBuffers = 2;           // stage buffers: one counted, one copying
constexpr int kMinWaves = 4;          // waves of resident CTAs a count splits into

struct Problem {
  const uint32_t* tx;   // (n, nw)
  const int32_t* wts;   // (n, nc)
  const uint32_t* tgt;  // (k, nw)
  int32_t* out;         // (k, nc)
  long long n, k;
  int nw, nc;
};

struct Sliced {
  uint32_t* cols;       // the columns (see above)
  uint32_t* live;       // (nc, nst)
  uint32_t* whole;      // (nc,), K2 only
  long long nwp;        // row-words, padded to whole stages
  int nst;              // stages
  int sw;               // row-words per stage
  int ncols;            // item columns and the all-ones one: 32 * nw + 1
};

struct Geometry {
  int sw, nst, cg, swp;
  long long nwp;
  bool staged;
  size_t smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Row-words a stage is a multiple of.
int quantum(int route) { return route == kRouteMxu ? 32 : 4; }

// Words between two staged columns.  K1 (one target a thread, four
// row-words a load): >= sw and 4 mod 8, so eight consecutive items hit eight
// distinct bank groups.  K2 (a quarter warp loads 16 row-words of two
// targets' columns): 16 mod 32 (sw is a multiple of 32), so two
// neighbouring columns fill all 32 banks.
int padded_stride(int route, int sw) {
  if (route == kRouteMxu) return sw + 16;
  return (sw / 4) % 2 == 0 ? sw + 4 : sw;
}

int class_group(int nc) { return nc <= 2 ? nc : kClassGroup; }

// Columns in one stage buffer: K1's item, all-ones and heavy columns and
// the odd planes of a class group; K2's item and all-ones columns and the
// planes of a plane group.
int stage_cols(int route, int nw, int cg) {
  return route == kRouteMxu ? 32 * nw + 1 + kPlaneGroup : 32 * nw + 2 + cg;
}

size_t stage_smem(int route, int nw, int cg, int sw) {
  return (size_t)kBuffers * stage_cols(route, nw, cg) *
         padded_stride(route, sw) * 4;
}

// K2's count kernel keeps a little static shared memory beside the stage.
size_t smem_budget(int route) {
  return route == kRouteMxu ? kMaxSmemBytes - 1024 : kMaxSmemBytes;
}

Geometry geometry(long long n, int nw, int nc, int block_n, int route) {
  Geometry g;
  g.cg = class_group(nc);
  const int qw = quantum(route);
  const size_t budget = smem_budget(route);
  long long words = cdiv(n, 32);
  long long sw = cdiv(cdiv(block_n, 32), qw) * qw;
  const long long need = cdiv(words, qw) * qw;
  if (sw > need) sw = need;
  if (sw < qw) sw = qw;
  while (sw > qw && stage_smem(route, nw, g.cg, (int)sw) > budget)
    sw = cdiv(sw / 2, qw) * qw;
  g.sw = (int)sw;
  g.swp = padded_stride(route, g.sw);
  g.nst = (int)cdiv(words, sw);
  g.nwp = (long long)g.nst * sw;
  g.smem = stage_smem(route, nw, g.cg, g.sw);
  g.staged = g.smem <= budget;
  if (!g.staged) g.smem = 0;
  return g;
}

// Columns before the live masks: items and all-ones, then the weights'.
long long weight_cols(int nw, int nc, int route) {
  return route == kRouteMxu ? 32LL * nw + 1 + 32LL * nc : 32LL * nw + 2 + nc;
}

long long scratch_words(int nw, int nc, const Geometry& g, int route) {
  return weight_cols(nw, nc, route) * g.nwp +
         (long long)nc * (g.nst + (route == kRouteMxu ? 1 : 0));
}

Sliced sliced_view(uint32_t* scratch, int nw, int nc, const Geometry& g,
                   int route) {
  Sliced s;
  s.ncols = 32 * nw + 1;
  s.nwp = g.nwp;
  s.nst = g.nst;
  s.sw = g.sw;
  s.cols = scratch;
  s.live = scratch + weight_cols(nw, nc, route) * g.nwp;
  s.whole = route == kRouteMxu ? s.live + (long long)nc * g.nst : nullptr;
  return s;
}

// ---- layout pass --------------------------------------------------------

// The 32 x 32 bit transpose across a warp: lane l holds row l; returns to
// lane b the word whose bit l is bit b of row l.  Five butterfly steps, each
// swapping the off-diagonal blocks of a 2 x 2 block transpose between lanes
// j apart.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kMasks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                  0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t m = kMasks[i];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

// One CTA of 32 warps turns 32 row-words (1024 rows) into column words: warp
// w transposes the bits of rows 32*(j0 + w) + lane (transpose32), and a
// 32 x 32 tile in shared memory turns the words around so that the stores
// are coalesced.
// K2's weight planes are the same transposition of each class's weights.
template <int ROUTE>
__global__ void __launch_bounds__(1024) layout_kernel(Problem p, Sliced s) {
  __shared__ uint32_t tile[32][33];
  __shared__ uint32_t s_or;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long j0 = (long long)blockIdx.x * 32;
  const long long j = j0 + wid;             // this warp's row-word
  const long long r = j * 32 + lane;        // this thread's row
  const bool in = r < p.n;
  const long long jo = j0 + lane;           // this thread's stored word
  const bool out_ok = jo < s.nwp;
  if (threadIdx.x == 0) s_or = 0;
  // column `col` of words j0 .. j0 + 31 from the 32 bits of x in each row
  auto transpose_store = [&](uint32_t x, long long col) {
    tile[lane][wid] = transpose32(x, lane);   // column col + lane, word j
    __syncthreads();
    if (out_ok) s.cols[(col + wid) * s.nwp + jo] = tile[wid][lane];
  };
  // the fields of a row: its nw words, then (K2) its nc weights; each
  // field's load is issued one field ahead, under the last one's transpose
  const int nf = p.nw + (ROUTE == kRouteMxu ? p.nc : 0);
  auto field = [&](int f) -> uint32_t {
    if (!in) return 0u;
    return f < p.nw ? __ldg(p.tx + r * p.nw + f)
                    : (uint32_t)__ldg(p.wts + r * p.nc + (f - p.nw));
  };
  uint32_t next = field(0);
  for (int f = 0; f < nf; ++f) {
    const uint32_t x = next;
    if (f + 1 < nf) next = field(f + 1);
    if (f < p.nw) {
      transpose_store(x, 32LL * f);
      __syncthreads();
      continue;
    }
    // K2: all 32 planes of class c, its live masks per stage and whole
    const int c = f - p.nw;
    const uint32_t any = __reduce_or_sync(0xffffffffu, x);
    if (lane == 0 && any != 0 && j < s.nwp) {
      atomicOr(s.live + (long long)c * s.nst + j / s.sw, any);
      atomicOr(&s_or, any);
    }
    transpose_store(x, s.ncols + 32LL * c);
    if (threadIdx.x == 0) {
      if (s_or != 0) atomicOr(s.whole + c, s_or);
      s_or = 0;
    }
    __syncthreads();
  }
  if (wid == 0 && out_ok) s.cols[(32LL * p.nw) * s.nwp + jo] = 0xffffffffu;
  if constexpr (ROUTE == kRouteVpu) {
    // the odd planes, the heavy column, live masks; one word per warp,
    // stored by its lane 0
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
}

// Zero the live masks (and K2's whole-launch masks), then run the pass.
template <int ROUTE>
cudaError_t launch_layout(const Problem& p, const Sliced& s,
                          cudaStream_t stream) {
  const size_t masks = (size_t)p.nc * (s.nst + (ROUTE == kRouteMxu ? 1 : 0));
  cudaError_t e = cudaMemsetAsync(s.live, 0, masks * 4, stream);
  if (e != cudaSuccess) return e;
  layout_kernel<ROUTE><<<(unsigned)cdiv(s.nwp, 32), 1024, 0, stream>>>(p, s);
  return cudaGetLastError();
}

// ---- shared pieces of the count kernels -----------------------------------

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

// The count kernels' stage buffers.  Indexed by word offsets (not generic
// pointers), so that their loads compile to LDS with 32-bit addresses.
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

// Copy stage `st` into the buffer `buf`: ncopy columns, column i of the
// buffer from scratch column src(i), 16 bytes a copy.
template <typename Src>
__device__ void issue_stage(const Sliced& s, uint32_t* buf, int swp, int st,
                            int ncopy, Src src) {
  const int q4 = s.sw / 4;
  const long long g0 = (long long)st * s.sw;
  for (int i = threadIdx.x; i < ncopy * q4; i += blockDim.x) {
    const int col = i / q4;
    const int q = i - col * q4;
    cp_async16(buf + col * swp + 4 * q, s.cols + src(col) * s.nwp + g0 + 4 * q);
  }
}

// The column offsets of a target's first S items (stride words apart; the
// all-ones column, ncols - 1, for missing items), for the unrolled loops.
template <int S, typename Off>
__device__ __forceinline__ void decode_target(const uint32_t* trow, bool valid,
                                              int nw, int ncols, Off stride,
                                              Off (&off)[S]) {
  int wi = valid ? 0 : nw;
  uint32_t m = valid ? __ldg(trow) : 0u;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    while (m == 0 && wi + 1 < nw) m = __ldg(trow + ++wi);
    int col = ncols - 1;
    if (m) {
      col = 32 * wi + __ffs(m) - 1;
      m &= m - 1;
    }
    off[q] = col * stride;
  }
}

// The AND word of a target of up to S items whose column offsets (from the
// row-word group's) are off[] (missing items read the all-ones column), or,
// for S == 0, of any target, walking its nw words (the general loop).
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

// Items of a (valid) target.
__device__ __forceinline__ int target_size(const uint32_t* trow, int nw) {
  int size = 0;
  for (int i = 0; i < nw; ++i) size += __popc(__ldg(trow + i));
  return size;
}

// ---- the split of the stages over the grid -----------------------------

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
// ends with a few atomics per target).  Returns the stages per CTA.
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

Problem problem(const void* tx, const void* wts, long long n, int nw, int nc) {
  Problem p{};
  p.tx = static_cast<const uint32_t*>(tx);
  p.wts = static_cast<const int32_t*>(wts);
  p.n = n;
  p.nw = nw;
  p.nc = nc;
  return p;
}

bool bad_shape(long long n, int nw, int nc, int block_n) {
  return n < 1 || nw < 1 || nc < 1 || block_n < 1;
}

// The layout pass alone into `scratch` (scratch_words of the route).
template <int ROUTE>
int layout_only(const void* tx, const void* wts, void* scratch,
                long long scratch_len, long long n, int nw, int nc,
                int block_n, void* stream_ptr) {
  if (bad_shape(n, nw, nc, block_n)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, nw, nc, block_n, ROUTE);
  if (scratch_len < scratch_words(nw, nc, g, ROUTE))
    return (int)cudaErrorInvalidValue;
  const Problem p = problem(tx, wts, n, nw, nc);
  const Sliced s =
      sliced_view(static_cast<uint32_t*>(scratch), nw, nc, g, ROUTE);
  return (int)launch_layout<ROUTE>(p, s, static_cast<cudaStream_t>(stream_ptr));
}

// The layout of n rows for block_n on route (0: K1, 1: K2), in uint32
// words: out[0] row-words per stage (sw), out[1] stages (nst), out[2]
// row-words padded to whole stages (nwp), out[3] the scratch's length, and
// the offsets of out[4] K1's heavy column, out[5] K1's first odd plane,
// out[6] the live masks, out[7] K2's first weight plane, out[8] K2's
// whole-launch masks (-1 where the route has none; the 32 * nw + 1 item and
// all-ones columns start at 0).  Returns the cudaError_t.
int geometry_report(long long n, int nw, int nc, int block_n, int route,
                    long long* out) {
  if (bad_shape(n, nw, nc, block_n) || (route != kRouteVpu && route != kRouteMxu))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, nw, nc, block_n, route);
  const long long ncols = 32LL * nw + 1;
  const bool mxu = route == kRouteMxu;
  out[0] = g.sw;
  out[1] = g.nst;
  out[2] = g.nwp;
  out[3] = scratch_words(nw, nc, g, route);
  out[4] = mxu ? -1 : ncols * g.nwp;
  out[5] = mxu ? -1 : (ncols + 1) * g.nwp;
  out[6] = weight_cols(nw, nc, route) * g.nwp;
  out[7] = mxu ? ncols * g.nwp : -1;
  out[8] = mxu ? out[6] + (long long)nc * g.nst : -1;
  return (int)cudaSuccess;
}

}  // namespace
