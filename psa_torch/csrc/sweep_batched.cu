// Batched offset sweeps on Hopper (sm_90a): the per-offset statistics of B
// queries in one launch, written as the batch epilogue's stats5.
//
// Replaces two TPU kernels of psa_tpu/ops/pallas_sweep.py, each with the
// maxrank conversion that follows it (psa_tpu/models/batch.py
// _fused_stats5_from_codes[_shared]):
//   * sweep_batched_kernel<false> replaces _sweep_kernel_batched (:365,
//     launched by _sweep_pallas_batched): every query has its own Seq1 row;
//   * sweep_batched_kernel<true> replaces _sweep_kernel_batched_shared
//     (:492, launched by _sweep_pallas_batched_shared): the B queries share
//     ONE Seq1 row.
//
// Contract:
//   in   c1   (B, l1k) uint8 Seq1 codes, or one (l1k,) row when shared;
//             l1k = noff_pad + l2p, PAD_CODE (28) past each sequence
//        c2   (B, l2p) uint8 Seq2 codes, PAD_CODE past each sequence
//        code (32, 32) int8 fused table, code[c1][c2]
//   out  (B, 5, noff_pad) int32.  For query q and offset o, over i < l2p
//        with v = code[c1_q[o + i] & 31][c2_q[i] & 31]: rows 0-3 count the i
//        with v > 0 and (v - 1) & 3 == k; row 4 is the maxrank
//        max(((max v - 1) >> 2) - 1, -1).  Exact integers: any order of the
//        sums (and of the atomics) gives the same bits.
//   noff_pad is a multiple of kPad (256), l2p of kFlush; c1, c2 and out are
//   16-byte aligned (the copies below are 16-byte bulk copies).
//
// What bounds it on this card: as sweep.cu's, the INT32 lanes and the
// shared-memory wavefronts of the bit-sliced pair loop (sweep_core.cuh):
// ~0.54 INT32 lane ops and 1/128 of a wavefront a pair, while a code byte
// from device memory serves a whole warp tile: B = 4 of 600,000 x 250,000
// hold 3.5e11 real pairs, 11.3 ms at the INT32 rate, against ~3.4 MB of
// codes in and 28 MB of stats out (~0.009 ms of HBM).
// What the design does about it:
//   * Offset tiles of one warp (kGranule = 32 lanes x a 32-bit word); a
//     bucket's offsets still pad to its longest query in 256s (kPad), and
//     a row's last tile past noff_pad copies its window up to the end of
//     the row and neither votes nor writes the lanes beyond.
//   * An even ("Stream-K") split over a persistent grid, as sweep.cu's.
//     The grid holds as many blocks as the card has resident slots, and
//     each block (two warps on one tile) is an independent worker.  An item
//     is one (tile, query), items run query-fastest within a tile, and an
//     item is `upi` units of Seq2 positions, contiguous: the whole of Seq2
//     where it fits one step (l2p <= kSegB), else 32 positions.  Worker w of
//     W takes the units [w U / W, (w + 1) U / W) of the U in the launch, so
//     no worker has more than one unit above the average, however few and
//     long the items are.  Where an item is one step the units are the
//     items, and a worker's range is a (tile, group of queries) whose one
//     Seq1 window serves the whole group in the shared kernel, whose bit
//     vectors the group's steps build once.  At most kBlocksPerSm blocks an
//     SM, two warps a scheduler; a block's barriers span only its own two
//     warps, so a block that waits on its copy holds up no other.
//   * Staging that overlaps the sweep.  Thread 0 of a block copies the next
//     step's Seq1 window and Seq2 segment into the other stage of a
//     two-stage ring in shared memory with cp.async.bulk (Hopper's 1-D
//     TMA), completing on that stage's mbarrier, while the block sweeps the
//     current step.  No thread spends an instruction per byte on staging.
//     Codes are masked to the table's 32 rows where they are read, so a
//     stray byte never reads outside the table.
//   * A compact write.  A lane's 32 consecutive offsets of a row are 128
//     contiguous bytes: a worker that owns every unit of an item stores
//     rows 0-4 as eight 16-byte stores each, turned from bit planes into
//     ints in registers, and adds into them on its later steps of the item
//     (no memset, no atomics); no pass over the output follows the kernel
//     and no row of zeros is written.
//   * Long Seq2.  A worker walks its range in steps of at most kSegB
//     positions within one item, through the same ring.  Where a range
//     starts or ends inside an item, the workers that share it add their
//     counts with atomicAdd and their maxranks with atomicMax (the
//     conversion is monotone), through a row of shared memory so that a
//     warp's atomics fall on 32 consecutive ints, into an output that the
//     entry point sets to 0 and -1 first, when some item is shared.
//   * The pair loop is sweep_core.cuh's bit-sliced main_pass, shared with
//     sweep.cu; a step that continues the last one in its item keeps the
//     bit vectors' last 32 columns.  Given a `counters` buffer, each worker
//     adds its threshold passes and its steps to it once, at its end.

#include <climits>

#include "sweep_core.cuh"

using namespace psa;

namespace {

// One launch's work (see the note at the head of the file).  Item i is
// query i % b of tile i / b, and unit u is unit u % upi of item u / upi, so
// a run of consecutive items sweeps one Seq1 window of the shared kernel.
struct Work {
  const uint8_t* c1;        // Seq1 rows (one row when shared)
  const uint8_t* c2;        // Seq2 rows
  int32_t* out;
  unsigned long long* counters;   // [passes, steps] added once a worker, or null
  long l1k;
  int l2p, noff_pad, b;
  int upi;                  // units per item: 1 where l2p <= kSegB, else l2p / kFlush
  int unit;                 // Seq2 positions per unit: l2p / upi
  int seg_max;              // min(l2p, kSegB): a ring stage's Seq2 bytes
  long units;               // ceil(noff_pad / kGranule) * b * upi
};

// A worker's place in its range of units: the step's item (query q of tile
// t), its first unit k within the item and its n units, and the units left
// in the range.  Walked without a division past the start.  Every lane
// keeps the same cursor.
struct Cursor {
  int t, q, k, n, left;
  bool fresh;       // the worker's first step
  bool whole;       // the worker owns every unit of the item

  __device__ void start(const Work& wk, long worker, long workers) {
    const long begin = worker * wk.units / workers;
    const long item = begin / wk.upi;
    t = static_cast<int>(item / wk.b);
    q = static_cast<int>(item % wk.b);
    k = static_cast<int>(begin - item * wk.upi);
    left = static_cast<int>((worker + 1) * wk.units / workers - begin);
    fresh = true;
    whole = k == 0 && left >= wk.upi;
    size(wk);
  }
  __device__ void size(const Work& wk) {
    n = min(min(left, wk.upi - k), kSegB / wk.unit);
  }
  __device__ void next(const Work& wk) {
    left -= n;
    k += n;
    fresh = false;
    if (k == wk.upi) {
      k = 0;
      if (++q == wk.b) {
        q = 0;
        ++t;
      }
      whole = left >= wk.upi;
    }
    size(wk);
  }
  __device__ bool done() const { return left <= 0; }
  __device__ int p0(const Work& wk) const { return k * wk.unit; }
  __device__ int seg(const Work& wk) const { return n * wk.unit; }
  __device__ bool first() const { return fresh || k == 0; }   // in the item
  // The step needs its own Seq1 window unless it sweeps the window of the
  // step before it: the next query of a shared-Seq1 run of one-step items.
  template <bool kShared>
  __device__ bool new_window(const Work& wk) const {
    return !kShared || wk.upi > 1 || fresh || q == 0;
  }
};

// Lane 0: start the copies of step `c` into a ring stage's Seq2 buffer `s2`
// and, unless `win` is null (the step keeps the current window), into the
// window buffer `win`; both complete on the stage's mbarrier `bar`.
template <bool kShared>
__device__ __forceinline__ void issue(const Work& wk, const Cursor& c,
                                      uint8_t* win, uint8_t* s2,
                                      uint64_t* bar) {
  const int p0 = c.p0(wk);
  const uint32_t seg = c.seg(wk);
  // a last tile past noff_pad copies the window up to the end of the row
  const long at = static_cast<long>(c.t) * kGranule + p0;
  const uint32_t wb = static_cast<uint32_t>(min(static_cast<long>(kGranule + seg),
                                                wk.l1k - at));
  fence_proxy_async();
  mbar_expect(bar, seg + (win ? wb : 0));
  bulk_copy(s2, wk.c2 + static_cast<long>(c.q) * wk.l2p + p0, seg, bar);
  if (win) {
    const uint8_t* row = kShared ? wk.c1 : wk.c1 + static_cast<long>(c.q) * wk.l1k;
    bulk_copy(win, row + at, wb, bar);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sweep_batched_kernel(const Work wk, const int8_t* __restrict__ code) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int win_bytes = kGranule + wk.seg_max;
  const Smem m(smem, wk.seg_max);

  TableRow row;
  row.load(code);
  Masks masks;
  masks.make(row);
  if (warp == 0) masks.put(m.rt);
  if (threadIdx.x == 0) {
    mbar_init(m.bar);
    mbar_init(m.bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Cursor cur, nxt;
  cur.start(wk, blockIdx.x, gridDim.x);
  nxt = cur;
  // The producer (thread 0) runs one step ahead of the sweep.  Step n uses
  // ring stage n & 1, whose mbarrier completes once per use: its phase
  // parity at step n is (n >> 1) & 1.  A Seq1 window goes to buffer
  // (windows copied so far) & 1, which the steps two windows back have
  // finished reading.
  int windows_issued = 0, windows_swept = 0;
  auto produce = [&](int stage) {
    const bool nw = nxt.new_window<kShared>(wk);
    if (threadIdx.x == 0) {
      issue<kShared>(wk, nxt, nw ? m.win + (windows_issued & 1) * win_bytes : nullptr,
                     m.s2 + stage * wk.seg_max, m.bar + stage);
    }
    windows_issued += nw;
    nxt.next(wk);
  };
  if (!nxt.done()) produce(0);

  // A step keeps the last one's bit vectors where it sweeps the same window
  // (a shared-Seq1 run) and continues them where that one swept a full kSegB
  // of the same item, if that step made one pass (clean).
  Tally tally;
  bool clean = false, full = false;
  for (int k = 0; !cur.done(); ++k) {
    const int stage = k & 1;
    if (!nxt.done()) produce(stage ^ 1);
    const bool nw = cur.new_window<kShared>(wk);
    windows_swept += nw;
    const int seg = cur.seg(wk);
    const Vectors vectors = !cur.first() && clean && full ? Vectors::kCarry
                            : nw || !clean                ? Vectors::kBuild
                                                          : Vectors::kKeep;
    mbar_wait(m.bar + stage, static_cast<uint32_t>(k >> 1) & 1);
    clean = block_step(m, row, masks, m.win + ((windows_swept - 1) & 1) * win_bytes,
                       m.s2 + stage * wk.seg_max, seg, vectors,
                       wk.out + static_cast<long>(cur.q) * 5 * wk.noff_pad, wk.noff_pad,
                       cur.t, cur.whole, cur.first(), tally);
    full = seg == kSegB;
    cur.next(wk);
  }
  tally.add_to(wk.counters);
}

// The even split of a launch of these shapes: the work, the grid (a block a
// worker, no more workers than units), the dynamic shared bytes per block
// and the resident blocks per SM.
template <bool kShared>
cudaError_t plan_work(int l2p, int noff_pad, int b, Work* wk, int* blocks,
                      size_t* smem, int* per_sm) {
  wk->l2p = l2p;
  wk->noff_pad = noff_pad;
  wk->b = b;
  wk->upi = l2p <= kSegB ? 1 : l2p / kFlush;
  wk->unit = l2p / wk->upi;
  wk->seg_max = min(l2p, kSegB);
  wk->units = static_cast<long>((noff_pad + kGranule - 1) / kGranule) * b * wk->upi;
  *smem = block_bytes(wk->seg_max);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(sweep_batched_kernel<kShared>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  block_bytes(kSegB))) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, sweep_batched_kernel<kShared>, kThreads, *smem)) != cudaSuccess) {
    return err;
  }
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *per_sm = min(*per_sm, kBlocksPerSm);
  *blocks = static_cast<int>(min(static_cast<long>(sms) * *per_sm, wk->units));
  const long workers = *blocks;
  // a worker counts its units in an int
  if ((wk->units + workers - 1) / workers > INT_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Items shared between workers: those with a worker boundary strictly
// inside them.  With `any`, stops at the first.
long split_items(const Work& wk, long workers, bool any) {
  long count = 0, last = -1;
  for (long w = 1; w < workers; ++w) {
    const long b = w * wk.units / workers;
    if (b % wk.upi == 0 || b / wk.upi == last) continue;
    last = b / wk.upi;
    ++count;
    if (any) break;
  }
  return count;
}

template <bool kShared>
int launch(const void* c1, int l1k, const void* c2, int l2p, const void* code,
           void* out, int noff_pad, int b, void* counters, void* stream) {
  if (b <= 0 || noff_pad <= 0 || noff_pad % kPad != 0 || l2p <= 0 ||
      l2p % kFlush != 0 || l1k != noff_pad + l2p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Work wk;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
  cudaError_t err = plan_work<kShared>(l2p, noff_pad, b, &wk, &blocks, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  wk.c1 = static_cast<const uint8_t*>(c1);
  wk.c2 = static_cast<const uint8_t*>(c2);
  wk.out = static_cast<int32_t*>(out);
  wk.counters = static_cast<unsigned long long*>(counters);
  wk.l1k = l1k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_items(wk, blocks, true)) {
    // counts start at 0, maxranks at -1 (all bytes 0xff)
    const size_t row = sizeof(int32_t) * static_cast<size_t>(noff_pad);
    if ((err = cudaMemsetAsync(out, 0, 5 * row * b, s)) != cudaSuccess ||
        (err = cudaMemset2DAsync(static_cast<char*>(out) + 4 * row, 5 * row, 0xff,
                                 row, b, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  sweep_batched_kernel<kShared><<<blocks, kThreads, smem, s>>>(
      wk, static_cast<const int8_t*>(code));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (B, 5, noff_pad) stats5 of B queries, each with its own Seq1 row of
// c1 (B, l1k).  Launches on `stream`; returns cudaGetLastError().
int psa_sweep_batched_launch(const void* c1, int l1k, const void* c2, int l2p,
                             const void* code, void* out, int noff_pad, int b,
                             void* counters, void* stream) {
  return launch<false>(c1, l1k, c2, l2p, code, out, noff_pad, b, counters, stream);
}

// The same for B queries sharing the one Seq1 row c1 (l1k,).
int psa_sweep_batched_shared_launch(const void* c1, int l1k, const void* c2,
                                    int l2p, const void* code, void* out,
                                    int noff_pad, int b, void* counters,
                                    void* stream) {
  return launch<true>(c1, l1k, c2, l2p, code, out, noff_pad, b, counters, stream);
}

// The split a launch of these shapes takes on the current device:
// plan[0..7] = resident blocks per SM, blocks, workers (blocks), items, units,
// the most units one worker takes, items shared between workers, dynamic
// shared bytes per block.
int psa_sweep_batched_plan(int l2p, int noff_pad, int b, int shared,
                           long long* plan) {
  if (b <= 0 || noff_pad <= 0 || noff_pad % kPad != 0 || l2p <= 0 ||
      l2p % kFlush != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Work wk;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
  const cudaError_t err =
      shared ? plan_work<true>(l2p, noff_pad, b, &wk, &blocks, &smem, &per_sm)
             : plan_work<false>(l2p, noff_pad, b, &wk, &blocks, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long workers = blocks;
  const long long v[8] = {per_sm, blocks, workers, wk.units / wk.upi, wk.units,
                          (wk.units + workers - 1) / workers,
                          split_items(wk, workers, false), static_cast<long long>(smem)};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
