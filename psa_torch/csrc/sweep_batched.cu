// Batched offset sweeps on Hopper (sm_90a): the single-query sweep's
// statistics for B queries in one launch.
//
// Replaces two TPU kernels of psa_tpu/ops/pallas_sweep.py:
//   * sweep_batched_kernel<false> replaces _sweep_kernel_batched (launched by
//     _sweep_pallas_batched): every query has its own Seq1 row;
//   * sweep_batched_kernel<true> replaces _sweep_kernel_batched_shared
//     (launched by _sweep_pallas_batched_shared): the B queries share ONE
//     Seq1 row, which a block stages once for all the queries it sweeps.
//
// Contract (the TPU kernels' layout):
//   in   c1   (B, l1k) uint8 Seq1 codes, or one (l1k,) row when shared;
//             l1k = noff_pad + l2p, PAD_CODE (28) past each sequence
//        c2   (B, l2p) uint8 Seq2 codes, PAD_CODE past each sequence
//        code (32, 32) int8 fused table, code[c1][c2]
//   out  (B, 8, noff_pad) int32.  For query q and offset o, over i < l2p
//        with v = code[c1_q[o + i]][c2_q[i]]: rows 0-3 count the i with
//        v > 0 and (v - 1) & 3 == k, row 4 is max(v) (0 if none), rows 5-7
//        are 0.  Exact integers: any order of the atomics gives the same bits.
//
// What bounds it on this card: the same as the single-query sweep — one
// shared-memory table read and three integer ops per (offset, position)
// pair, while a code byte from device memory serves a whole tile, so the
// INT32 issue rate bounds it (1024 queries of 2048 x 512: 8.1e8 pairs,
// ~0.14 ms), not HBM (~70 MB in and out, ~0.02 ms).  The per-pair loop is
// sweep_core.cuh's.  What the batch adds:
//   * grid (offset tiles, Seq2 segments, query groups).  A block expands the
//     code table once and then sweeps a GROUP of queries in turn, staging
//     only what changes: each query's Seq1 window and Seq2 segment, or, in
//     the shared kernel, only the Seq2 segment (the Seq1 window is staged
//     once per block — the TPU kernel's once-per-tile window load).
//   * The group size is chosen by the entry point so that the grid is one
//     wave of resident blocks: at B = 1024 of 2048 x 512 (2 offset tiles) a
//     block per (tile, query) would give 2048 blocks, more than the card
//     holds at once, and a block per tile would share everything but use 2
//     SMs of 132.  Folding the queries into groups also keeps grid.z under
//     its 65,535 cap at any B.
//   * Row offsets are 64-bit: B * l1k passes 2^31 at B = 8192, l1k = 262,144.
//   * When Seq2 fits one segment (l2p <= kSeg) a block is the only writer of
//     its offsets and stores all 8 rows, so the output needs no memset and no
//     atomics; longer Seq2 is split over grid.y and meets in atomics on an
//     output the entry point zeroes first.

#include "sweep_core.cuh"

using namespace psa;

namespace {

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sweep_batched_kernel(const uint8_t* __restrict__ c1, int l1k,
                     const uint8_t* __restrict__ c2, int l2p,
                     const int8_t* __restrict__ code,
                     int32_t* __restrict__ out, int noff_pad, int b,
                     int group) {
  __shared__ uint32_t tab[32 * 32];          // tab[c2 * 32 + c1]
  __shared__ uint8_t s1[kTile + kSeg];
  __shared__ uint8_t s2[kSeg];

  const int o0 = blockIdx.x * kTile;
  const int p0 = blockIdx.y * kSeg;
  const int seg = min(kSeg, l2p - p0);       // a multiple of kFlush
  const bool exclusive = gridDim.y == 1;
  const long start1 = static_cast<long>(o0) + p0;
  const int q0 = blockIdx.z * group;
  const int q1 = min(b, q0 + group);

  expand_table(tab, code);
  if (kShared) stage_codes(s1, c1, l1k, start1, kTile + seg);
  for (int q = q0; q < q1; ++q) {
    if (q > q0) __syncthreads();             // the last query's reads are done
    if (!kShared) {
      stage_codes(s1, c1 + static_cast<long>(q) * l1k, l1k, start1, kTile + seg);
    }
    stage_codes(s2, c2 + static_cast<long>(q) * l2p, l2p, p0, seg);
    __syncthreads();
    sweep_tile(tab, s1, s2, seg, out + static_cast<long>(q) * 8 * noff_pad,
               noff_pad, o0, exclusive);
  }
}

template <bool kShared>
int launch(const void* c1, int l1k, const void* c2, int l2p, const void* code,
           void* out, int noff_pad, int b, void* stream) {
  if (b <= 0 || noff_pad <= 0 || noff_pad % kTile != 0 || l2p <= 0 ||
      l2p % kFlush != 0 || l1k != noff_pad + l2p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = noff_pad / kTile;
  const int nseg = (l2p + kSeg - 1) / kSeg;
  cudaError_t err;
  if (nseg > 1) {
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * 8 * static_cast<size_t>(noff_pad) * b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // One wave: as many query groups as the card holds blocks beside the
  // (tile, segment) grid, and never more than grid.z allows.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sweep_batched_kernel<kShared>, kThreads, 0)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long slots = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long groups = slots / (static_cast<long>(ntiles) * nseg);
  long group = (b + (groups > 0 ? groups : 1) - 1) / (groups > 0 ? groups : 1);
  group = group > (b + 65534L) / 65535L ? group : (b + 65534L) / 65535L;
  const dim3 grid(ntiles, nseg, static_cast<unsigned>((b + group - 1) / group));
  sweep_batched_kernel<kShared><<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(c1), l1k, static_cast<const uint8_t*>(c2), l2p,
      static_cast<const int8_t*>(code), static_cast<int32_t*>(out), noff_pad, b,
      static_cast<int>(group));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (B, 8, noff_pad) statistics of B queries, each with its own Seq1 row of
// c1 (B, l1k).  Launches on `stream`; returns cudaGetLastError().
int psa_sweep_batched_launch(const void* c1, int l1k, const void* c2, int l2p,
                             const void* code, void* out, int noff_pad, int b,
                             void* stream) {
  return launch<false>(c1, l1k, c2, l2p, code, out, noff_pad, b, stream);
}

// The same for B queries sharing the one Seq1 row c1 (l1k,).
int psa_sweep_batched_shared_launch(const void* c1, int l1k, const void* c2,
                                    int l2p, const void* code, void* out,
                                    int noff_pad, int b, void* stream) {
  return launch<true>(c1, l1k, c2, l2p, code, out, noff_pad, b, stream);
}

}  // extern "C"
