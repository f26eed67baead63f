// The b1 tensor-core instruction of K2 alone (sm_90a): a one-tile check of
// mma.sync.m16n8k256 .b1 .and.popc against popc, and a rate loop that
// times it beside the u8 m16n8k32 product of the same shape in bytes.  Not
// part of either kernel library: the kernel tests and chip_smoke.py build
// it (b1_probe.py) to check the instruction and to measure the rate that
// roofline/kernel_model.py ties K2's bound to.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_b1.cuh"

namespace {

constexpr int kChains = 8;   // independent products per warp and iteration

__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp, one m16n8k256 product: a (16, 8) words (row r, k-word j holds
// k = 32j .. 32j + 31), b (8, 8) words (column n, k-word j), d (16, 8).
__global__ void b1_tile_kernel(const uint32_t* a, const uint32_t* b, int* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  int acc[4] = {0, 0, 0, 0};
  mma_b1(acc, a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + 4 + t],
         a[(g + 8) * 8 + 4 + t], b[g * 8 + t], b[g * 8 + 4 + t]);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// Every warp runs iters x kChains independent products on constant
// operands.
template <bool B1>
__global__ void __launch_bounds__(256) mma_rate_kernel(int iters, int* sink) {
  int d[kChains][4];
#pragma unroll
  for (int j = 0; j < kChains; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
  const uint32_t a0 = threadIdx.x * 0x9E3779B9u, a1 = a0 ^ 0x55555555u,
                 a2 = ~a0, a3 = a0 + 7u, b0 = a0 * 3u, b1 = a1 + 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if constexpr (B1) mma_b1(d[j], a0, a1, a2, a3, b0, b1);
      else mma_u8(d[j], a0, a1, a2, a3, b0, b1);
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (sum == 0x7fffffff) sink[0] = sum;   // keeps the products
}

}  // namespace

extern "C" {

// The one-tile check (b1_tile_kernel) on `stream`; returns the cudaError_t.
int b1_probe_tile(const void* a, const void* b, void* d, void* stream_ptr) {
  b1_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int*>(d));
  return (int)cudaGetLastError();
}

// The rate loop: `blocks` CTAs of 8 warps, each warp iters x kChains
// products, b1 (b1 = 1) or u8 (b1 = 0); `sink` is one int of device memory.
int b1_probe_rate(int b1, int iters, int blocks, void* sink, void* stream_ptr) {
  if (iters < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* out = static_cast<int*>(sink);
  if (b1) mma_rate_kernel<true><<<blocks, 256, 0, stream>>>(iters, out);
  else mma_rate_kernel<false><<<blocks, 256, 0, stream>>>(iters, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
