// What the kernel lab's tensor-core sweeps share (sweep_mma.cu: v2,
// sweep_mma_v3.cu: v3): the tile and band geometry, the fused table's
// transposed copy in shared memory, and the int8 mma.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psa_mma {

constexpr int kTile = 256;                        // offsets per block
constexpr int kThreads = 256;                     // one offset per thread in the decode
constexpr int kChunk = 64;                        // Seq2 positions per band
constexpr int kWarps = kThreads / 32;
constexpr int kMTiles = kChunk / 16;              // mma rows: 16 positions each
constexpr int kNTiles = kTile / 8 + 2;            // mma columns of one row tile: 8 Seq1 codes each
constexpr int kRowPad = 16;                       // band rows for offsets -16 .. -1
constexpr int kBandRows = kTile + 2 * kRowPad;    // offsets -16 .. kTile + 15
constexpr int kRowWords = kChunk / 4 + 1;         // odd stride: the decode's reads
constexpr int kRowBytes = 4 * kRowWords;          // hit 32 distinct banks
constexpr uint32_t kB1 = 0x01010101u;            // one in each byte lane

static_assert(kThreads == kTile, "the decode gives each thread one offset");

// D = A B + 0 on the int8 tensor cores.  Fragments (PTX ISA, mma.m16n8k32
// with .s8): lane = 4 g + t; a[0] = A[g][4t .. 4t+3], a[1] = A[g+8][4t ..],
// a[2] = A[g][16+4t ..], a[3] = A[g+8][16+4t ..]; b0 = B[4t .. 4t+3][g],
// b1 = B[16+4t .. 16+4t+3][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].  The lowest byte of a register holds the lowest index.
__device__ __forceinline__ void mma_s8(const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, int (&d)[4]) {
  const int z = 0;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(z));
}

// tab[c2 * 8 + q] = code[4q .. 4q+3][c2]: the rows of A as 4-byte words.
// Every thread of the block takes part; the caller synchronises after it.
__device__ __forceinline__ void load_table(const int8_t* __restrict__ code,
                                           uint32_t* tab) {
  for (int e = threadIdx.x; e < 32 * 8; e += kThreads) {
    const int b = e >> 3;                         // Seq2 code
    const int q = e & 7;                          // Seq1 codes 4q .. 4q+3
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w |= static_cast<uint32_t>(static_cast<uint8_t>(code[(4 * q + k) * 32 + b])) << (8 * k);
    }
    tab[e] = w;
  }
}

// The one-hot B fragment (b0, b1) of Seq1 code s for lane quarter t.
__device__ __forceinline__ void one_hot_b(uint32_t s, int t, uint32_t& b0, uint32_t& b1) {
  const uint32_t bit = 1u << (8 * (s & 3));
  b0 = (s >> 2) == static_cast<uint32_t>(t) ? bit : 0u;
  b1 = (s >> 2) == static_cast<uint32_t>(t + 4) ? bit : 0u;
}

}  // namespace psa_mma
