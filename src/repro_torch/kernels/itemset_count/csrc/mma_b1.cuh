// The b1 tensor-core product of K2 (itemset_count_mxu.cu), in a header of
// its own so that b1_probe.cu checks and times the same instruction.
//
// Fragments (PTX ISA, mma.m16n8k256 with .b1; CUTLASS's
// SM80_16x8x256_S32U1U1S32_TN_ANDPOPC): lane = 4g + t holds A rows g and
// g + 8 at k-words t and 4 + t (a0 = row g word t, a1 = row g + 8 word t,
// a2 = row g word 4 + t, a3 = row g + 8 word 4 + t), B column g at k-words t
// and 4 + t (b0, b1), and D rows g and g + 8 at columns 2t and 2t + 1.

#pragma once

#include <cstdint>

namespace {

// d += popc(a & b) over k = 256: A 16 x 256 bits (row), B 256 x 8 bits (col).
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace
