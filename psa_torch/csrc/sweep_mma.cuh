// What the kernel lab's tensor-core sweeps share (sweep_mma.cu: v2,
// sweep_mma_v3.cu: v3): the tile and band geometry, the fused table's
// transposed copy in shared memory, the int8 mma, and the launch that splits
// Seq2 into segments so that the grid fills the card.

#pragma once

#include <algorithm>
#include <climits>
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

// The split of a launch over (tile, Seq2 segment) blocks.  Block (x, y)
// sweeps tile x's kTile offsets over segment y of Seq2's whole chunks; the
// chunks are split evenly over the segments (lengths differ by at most one).
// Segments meet in atomics on an output the launch zeroes first: atomicAdd
// for the class counts, atomicMax for the max; with one segment a block
// stores all 8 rows and nothing is zeroed.  The kernels take
// (c1, c2, chunks, code, out, noff_pad); their segment is blockIdx.y of
// gridDim.y.
using LabKernel = void (*)(const uint8_t*, const uint8_t*, int, const int8_t*,
                           int32_t*, int);

constexpr int kNoLaneCap = INT_MAX;               // a kernel that folds every chunk

// Segments of Seq2 per tile for `tiles` tiles of `chunks` chunks on a card
// of `slots` resident block slots: the least count that gives every slot
// `per_slot` blocks and keeps a segment within `lane_chunks` chunks, capped
// at one chunk per segment (ops/_sweep_v2.segment_plan is its model).
inline int segments(long tiles, int chunks, long slots, int per_slot, int lane_chunks) {
  const long lanes = (static_cast<long>(chunks) + lane_chunks - 1) / lane_chunks;
  const long fill = (per_slot * slots + tiles - 1) / tiles;
  return static_cast<int>(std::min(static_cast<long>(chunks), std::max(lanes, fill)));
}

struct Plan {
  int per_sm, slots, tiles, chunks, segs;
};

inline bool bad_shapes(int l2p, int noff_pad) {
  return noff_pad <= 0 || noff_pad % kTile != 0 || l2p <= 0 || l2p % kChunk != 0 ||
         l2p > INT_MAX - noff_pad;
}

inline cudaError_t plan_launch(LabKernel kernel, int per_slot, int lane_chunks, int l2p,
                               int noff_pad, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, kernel, kThreads, 0)) !=
          cudaSuccess) {
    return err;
  }
  if (p->per_sm < 1) return cudaErrorInvalidConfiguration;
  p->slots = p->per_sm * sms;
  p->tiles = noff_pad / kTile;
  p->chunks = l2p / kChunk;
  p->segs = segments(p->tiles, p->chunks, p->slots, per_slot, lane_chunks);
  return cudaSuccess;
}

// Launch `kernel` on its split: (8, noff_pad) into `out` on `stream`, zeroed
// first when segments meet in atomics.  Returns the first CUDA error.
inline int launch_split(LabKernel kernel, int per_slot, int lane_chunks, const void* c1,
                        int l1k, const void* c2, int l2p, const void* code, void* out,
                        int noff_pad, void* stream) {
  if (bad_shapes(l2p, noff_pad) || l1k != noff_pad + l2p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  cudaError_t err = plan_launch(kernel, per_slot, lane_chunks, l2p, noff_pad, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.segs > 1 &&
      (err = cudaMemsetAsync(out, 0, sizeof(int32_t) * 8 * static_cast<size_t>(noff_pad), s)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<dim3(p.tiles, p.segs), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(c1), static_cast<const uint8_t*>(c2), p.chunks,
      static_cast<const int8_t*>(code), static_cast<int32_t*>(out), noff_pad);
  return static_cast<int>(cudaGetLastError());
}

// The split a launch of these shapes takes on the current device:
// plan[0..6] = resident blocks per SM, resident block slots, tiles, chunks,
// segments per tile, blocks, the most chunks one segment holds.
inline int write_plan(LabKernel kernel, int per_slot, int lane_chunks, int l2p, int noff_pad,
                      long long* plan) {
  if (bad_shapes(l2p, noff_pad)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_launch(kernel, per_slot, lane_chunks, l2p, noff_pad, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[7] = {p.per_sm, p.slots, p.tiles, p.chunks, p.segs,
                          static_cast<long long>(p.tiles) * p.segs,
                          (p.chunks + p.segs - 1) / p.segs};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

}  // namespace psa_mma
