// The per-block body of the single-query offset sweep (sweep.cu): the
// expanded code table, the staging of a Seq1 window and a Seq2 segment in
// shared memory, the per-pair loop and the write of one tile's statistics.
// The batched sweeps (sweep_batched.cu) share its constants, the expanded
// table and its layout, and have a warp-level loop of their own.
//
// Contract of a tile (the TPU kernels' layout): for offset o of the tile and
// the positions i of this block's Seq2 segment, with v = code[c1[o+i]][c2[i]],
// rows 0-3 of `out` count the i with v > 0 and (v - 1) & 3 == k, row 4 is
// max(v) (0 if none) and rows 5-7 are 0.  Every value is an exact integer, so
// the order of summation (and of the atomics) cannot change a bit.
//
// Per-pair work is one 32-bit shared load and three integer ops:
//   * the table is expanded into 32-bit entries
//       e = (v << 24) | (1 << (6 * ((v - 1) & 3)))   (0 for v == 0)
//     so one add counts the class in a 6-bit field and one unsigned max keeps
//     max(v) in the top byte; the fields drain into counters every kFlush
//     (< 64) positions;
//   * the table is stored transposed, tab[c2][c1]: a warp reads one Seq2
//     position against 32 Seq1 codes, i.e. words of one 32-word row, 32
//     distinct banks;
//   * each thread owns kOffsetsPerThread consecutive offsets and slides a
//     register window along Seq1, one shared load of Seq1 per
//     kOffsetsPerThread pairs.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psa {

constexpr int kThreads = 128;
constexpr int kOffsetsPerThread = 8;
constexpr int kTile = kThreads * kOffsetsPerThread;   // offsets per block
constexpr int kSeg = 1024;                            // Seq2 positions per block
constexpr int kFlush = 32;                            // 6-bit fields hold 63
constexpr uint8_t kPadCode = 28;

// tab[c2 * 32 + c1] = the expanded entry of code[c1][c2].
__device__ __forceinline__ void expand_table(uint32_t* tab,
                                             const int8_t* __restrict__ code) {
  for (int e = threadIdx.x; e < 32 * 32; e += kThreads) {
    const int a = e & 31;                    // Seq1 code
    const int b = e >> 5;                    // Seq2 code
    const uint32_t v = static_cast<uint8_t>(code[a * 32 + b]);
    tab[e] = v ? ((v << 24) | (1u << (6 * ((v - 1) & 3)))) : 0u;
  }
}

// s[i] = c[start + i] for i < n, PAD_CODE past `len`.  Codes are masked to
// the table's 32 rows: a stray byte can never read outside it.
__device__ __forceinline__ void stage_codes(uint8_t* s,
                                            const uint8_t* __restrict__ c,
                                            long len, long start, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long g = start + i;
    s[i] = (g < len ? c[g] : kPadCode) & 31;
  }
}

// One tile: kTile offsets from o0 against the `seg` staged Seq2 positions
// (a multiple of kFlush).  s1 holds the kTile + seg Seq1 codes the tile's
// windows cover.  Rows 0-4 are added into an output zeroed beforehand,
// since other blocks may sweep other segments of Seq2 for these offsets.
__device__ __forceinline__ void sweep_tile(const uint32_t* tab,
                                           const uint8_t* s1,
                                           const uint8_t* s2, int seg,
                                           int32_t* __restrict__ out,
                                           int noff_pad, int o0) {
  const int base = threadIdx.x * kOffsetsPerThread;
  uint32_t w[kOffsetsPerThread];             // w[j] = s1[base + i + j]
  uint32_t mx[kOffsetsPerThread];
  int cnt[kOffsetsPerThread][4];
#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) {
    w[j] = s1[base + j];
    mx[j] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) cnt[j][k] = 0;
  }

  for (int i0 = 0; i0 < seg; i0 += kFlush) {
    uint32_t acc[kOffsetsPerThread];
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) acc[j] = 0;
#pragma unroll
    for (int ii = 0; ii < kFlush; ++ii) {
      const uint32_t* row = tab + (static_cast<uint32_t>(s2[i0 + ii]) << 5);
#pragma unroll
      for (int j = 0; j < kOffsetsPerThread; ++j) {
        const uint32_t e = row[w[j]];
        acc[j] += e;
        mx[j] = max(mx[j], e);
      }
#pragma unroll
      for (int j = 0; j + 1 < kOffsetsPerThread; ++j) w[j] = w[j + 1];
      // the last index read is base + seg - 1 + kOffsetsPerThread
      // <= kTile + seg - 1, inside s1
      w[kOffsetsPerThread - 1] = s1[base + i0 + ii + kOffsetsPerThread];
    }
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt[j][k] += (acc[j] >> (6 * k)) & 63;
    }
  }

#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) {
    const long o = static_cast<long>(o0) + base + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cnt[j][k]) atomicAdd(out + k * static_cast<long>(noff_pad) + o, cnt[j][k]);
    }
    if (mx[j]) atomicMax(out + 4L * noff_pad + o, static_cast<int>(mx[j] >> 24));
  }
}

}  // namespace psa
