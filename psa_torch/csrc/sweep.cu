// Offset sweep on Hopper (sm_90a) for one query: per-offset sign-class
// counts and the maxrank, written as the epilogue's stats5.
//
// Replaces psa_tpu/ops/pallas_sweep.py::_sweep_kernel (:297, launched by
// _sweep_pallas) with the maxrank conversion that follows it
// (maxrank_from_maxcode), and, at B = 1, what _sweep_kernel_batched does for
// a Seq1 beyond the TPU's VMEM budget: codes are read from device memory, so
// Seq1 length has no on-chip cap.
//
// Contract:
//   in   c1   (l1k,) uint8 Seq1 codes, l1k = noff_pad + l2p, PAD_CODE (28)
//             past the sequence
//        c2   (l2p,) uint8 Seq2 codes, PAD_CODE past the sequence
//        code (32, 32) int8 fused table, code[c1][c2]: 0 = inert, else
//             1 + cls + 4 * (rank + 1), at most 126
//   out  (5, noff_pad) int32.  For offset o, over i < l2p with
//        v = code[c1[o + i] & 31][c2[i] & 31]: rows 0-3 count the i with
//        v > 0 and (v - 1) & 3 == k; row 4 is the maxrank
//        max(((max v - 1) >> 2) - 1, -1).  Exact integers: any order of the
//        sums (and of the atomics) gives the same bits.
//   noff_pad is a multiple of kPad (256), l2p of kFlush (32); c1, c2 and
//   out are 16-byte aligned (the copies below are 16-byte bulk copies).
//
// What bounds it on this card: the INT32 lanes and the shared-memory
// wavefronts of the bit-sliced pair loop (sweep_core.cuh).  A warp covers
// kGranule = 1024 offsets, one bit a pair; per Seq2 position it makes eight
// conflict-free 32-bit shared loads and ~17.4 warp instructions on the
// INT32 lanes (funnel shifts, carry-save adders), so a pair costs 1/128 of
// a wavefront and ~0.54 INT32 lane ops, against one table read a pair on
// the route before it; a code byte from device memory serves a whole warp
// tile.  600,000 x 250,000 holds 8.75e10 real pairs: 2.8 ms at the INT32
// rate (2.6 at the shared-memory rate), against ~0.85 MB of codes in and
// 7 MB of stats out (~0.002 ms of HBM).
// What the design does about it:
//   * The bit-sliced pair loop (sweep_core.cuh main_pass, shared with the
//     batched kernels): per position two loads and a funnel shift a kind
//     give 32 pairs' bits, carry-save adders count them, and the maxrank
//     is an OR at the table's top rank, swept again at lower thresholds
//     only where some offset of the tile met none.
//   * A warp tile of 32 lanes x one 32-bit word; offsets still pad to 256s
//     (kPad), and a last tile past noff_pad copies its window up to the end
//     of Seq1 and neither votes nor writes the lanes beyond.
//   * A worker is a block of two warps that share the step's bit vectors
//     and split its runs, at most kBlocksPerSm blocks an SM: two warps a
//     scheduler on one copy of the vectors each pair.
//   * An even ("Stream-K") split of one query over a persistent grid.  The
//     work is U = tiles x l2p / 32 units of (warp tile, 32 positions of
//     Seq2), tile-major.  The grid holds as many blocks as the card has
//     resident slots (no more blocks than units), each block is a worker,
//     and worker w of W takes the units [w U / W, (w + 1) U / W): no worker has
//     more than one unit above the average, however few tiles a long Seq2
//     leaves.  A range may start or end inside a tile and may cover several
//     tiles; the worker walks it in steps of at most kSegB positions within
//     one tile.
//   * Staging that overlaps the sweep.  Thread 0 of a block copies the next
//     step's Seq1 window and Seq2 segment into the other stage of a
//     two-stage ring in shared memory with cp.async.bulk (Hopper's 1-D TMA),
//     completing on that stage's mbarrier, while the block sweeps the
//     current step.  No thread spends an instruction per byte on staging.
//     Every copy is a multiple of 16 bytes: steps start at multiples of 32
//     positions, tiles at multiples of 1024 offsets, and Seq1 ends at a
//     multiple of 32.  A step that continues the last one in its tile keeps
//     the bit vectors' last 32 columns and builds only its new ones.
//   * stats5 written directly.  A worker that owns every unit of a tile
//     stores its 5 rows with 16-byte stores (a later step of the tile adds
//     into them).  Where a tile is shared between workers, each adds its
//     counts with atomicAdd and its maxrank with atomicMax (the conversion
//     is monotone), through a row of shared memory so that a warp's atomics
//     fall on 32 consecutive ints; the entry point then first sets counts
//     to 0 and maxranks to -1.  No row of zeros is written and no pass over
//     the output follows the kernel.
//   * Counters.  Given a `counters` buffer, each worker adds its threshold
//     passes and its steps to it once, at its end.

#include <climits>

#include "sweep_core.cuh"

using namespace psa;

namespace {

// One launch's work (see the note at the head of the file).
struct Span {
  const uint8_t* c1;
  const uint8_t* c2;
  int32_t* out;
  unsigned long long* counters;   // [passes, steps] added once a worker, or null
  int l2p, noff_pad;
  int upt;          // units per tile: l2p / kFlush
  int seg_max;      // min(l2p, kSegB): a ring stage's Seq2 bytes
  int units;        // ceil(noff_pad / kGranule) * upt
};

// A worker's place in its range [begin, end) of units, and the step at
// unit u: tile t, its positions [p0, p0 + seg).  Every lane keeps the same
// cursor.
struct Steps {
  int u, begin, end;
  int t, p0, seg;
  bool first;       // the worker's first step in tile t
  bool whole;       // the worker owns every unit of tile t

  __device__ void start(const Span& sp, long worker, long workers) {
    begin = static_cast<int>(worker * sp.units / workers);
    end = static_cast<int>((worker + 1) * sp.units / workers);
    set(sp, begin);
  }
  __device__ void set(const Span& sp, int v) {
    u = v;
    if (u >= end) return;
    t = u / sp.upt;
    const int t0 = t * sp.upt, t1 = t0 + sp.upt;
    p0 = (u - t0) * kFlush;
    seg = (min(min(end, t1), u + kSegB / kFlush) - u) * kFlush;
    first = u == begin || u == t0;
    whole = begin <= t0 && t1 <= end;
  }
  __device__ void next(const Span& sp) { set(sp, u + seg / kFlush); }
  __device__ bool done() const { return u >= end; }
};

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const Span sp, const int8_t* __restrict__ code) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int win_bytes = kGranule + sp.seg_max;
  const Smem m(smem, sp.seg_max);

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

  Steps cur, nxt;
  cur.start(sp, blockIdx.x, gridDim.x);
  nxt = cur;
  // The producer (thread 0) runs one step ahead of the sweep.  Step n uses
  // ring stage n & 1, whose mbarrier completes once per use: its phase
  // parity at step n is (n >> 1) & 1, whatever tiles the steps fall in.  A
  // last tile past noff_pad copies the window up to the end of Seq1; the
  // rest of the stage is left as it was and reaches only offsets past
  // noff_pad, which are neither voted on nor written.
  auto produce = [&](int stage) {
    if (threadIdx.x == 0) {
      const long at = static_cast<long>(nxt.t) * kGranule + nxt.p0;
      const uint32_t wb = static_cast<uint32_t>(
          min(static_cast<long>(kGranule + nxt.seg), sp.noff_pad + sp.l2p - at));
      fence_proxy_async();
      mbar_expect(m.bar + stage, wb + nxt.seg);
      bulk_copy(m.s2 + stage * sp.seg_max, sp.c2 + nxt.p0, nxt.seg, m.bar + stage);
      bulk_copy(m.win + stage * win_bytes, sp.c1 + at, wb, m.bar + stage);
    }
    nxt.next(sp);
  };
  if (!nxt.done()) produce(0);

  // A step continues the last one's bit vectors where that one swept a full
  // kSegB of the same tile in one pass (clean).
  Tally tally;
  bool clean = false, full = false;
  for (int k = 0; !cur.done(); ++k) {
    const int stage = k & 1;
    if (!nxt.done()) produce(stage ^ 1);
    mbar_wait(m.bar + stage, static_cast<uint32_t>(k >> 1) & 1);
    clean = block_step(m, row, masks, m.win + stage * win_bytes, m.s2 + stage * sp.seg_max,
                       cur.seg, !cur.first && clean && full ? Vectors::kCarry : Vectors::kBuild,
                       sp.out, sp.noff_pad, cur.t, cur.whole, cur.first, tally);
    full = cur.seg == kSegB;
    cur.next(sp);
  }
  tally.add_to(sp.counters);
}

int tiles(int noff_pad) { return (noff_pad + kGranule - 1) / kGranule; }

bool bad_shapes(int l2p, int noff_pad) {
  return noff_pad <= 0 || noff_pad % kPad != 0 || l2p <= 0 || l2p % kFlush != 0 ||
         static_cast<long>(tiles(noff_pad)) * (l2p / kFlush) > INT_MAX - kSegB;
}

// The even split of a launch of these shapes: the span, the grid (a block
// a worker, no more workers than units), the dynamic shared bytes per block
// and the resident blocks per SM.
cudaError_t plan_span(int l2p, int noff_pad, Span* sp, int* blocks, size_t* smem,
                      int* per_sm) {
  sp->l2p = l2p;
  sp->noff_pad = noff_pad;
  sp->upt = l2p / kFlush;
  sp->seg_max = min(l2p, kSegB);
  sp->units = tiles(noff_pad) * sp->upt;
  *smem = block_bytes(sp->seg_max);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  block_bytes(kSegB))) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, sweep_kernel, kThreads,
                                                           *smem)) != cudaSuccess) {
    return err;
  }
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *per_sm = min(*per_sm, kBlocksPerSm);
  *blocks = static_cast<int>(min(static_cast<long>(sms) * *per_sm,
                                 static_cast<long>(sp->units)));
  return cudaSuccess;
}

// Tiles shared between workers: those with a worker boundary strictly
// inside them.  With `any`, stops at the first.
long split_tiles(const Span& sp, long workers, bool any) {
  long count = 0, last = -1;
  for (long w = 1; w < workers; ++w) {
    const long b = w * sp.units / workers;
    if (b % sp.upt == 0 || b / sp.upt == last) continue;
    last = b / sp.upt;
    ++count;
    if (any) break;
  }
  return count;
}

}  // namespace

extern "C" {

int psa_sweep_tile() { return kPad; }

int psa_sweep_warp_tile() { return kGranule; }

int psa_sweep_align() { return kFlush; }

int psa_sweep_seg() { return kSegB; }

const char* psa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (5, noff_pad) stats5 of one query on `stream`; returns cudaGetLastError().
int psa_sweep_launch(const void* c1, int l1k, const void* c2, int l2p,
                     const void* code, void* out, int noff_pad, void* counters,
                     void* stream) {
  if (bad_shapes(l2p, noff_pad) || l1k != noff_pad + l2p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Span sp;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
  cudaError_t err = plan_span(l2p, noff_pad, &sp, &blocks, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  sp.c1 = static_cast<const uint8_t*>(c1);
  sp.c2 = static_cast<const uint8_t*>(c2);
  sp.out = static_cast<int32_t*>(out);
  sp.counters = static_cast<unsigned long long*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_tiles(sp, blocks, true)) {
    // counts start at 0, maxranks at -1 (all bytes 0xff)
    const size_t row = sizeof(int32_t) * static_cast<size_t>(noff_pad);
    if ((err = cudaMemsetAsync(out, 0, 4 * row, s)) != cudaSuccess ||
        (err = cudaMemsetAsync(static_cast<char*>(out) + 4 * row, 0xff, row, s)) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  sweep_kernel<<<blocks, kThreads, smem, s>>>(sp, static_cast<const int8_t*>(code));
  return static_cast<int>(cudaGetLastError());
}

// The split a launch of these shapes takes on the current device:
// plan[0..5] = resident blocks per SM, workers (blocks), units, the most units
// one worker takes, tiles shared between workers, dynamic shared bytes per
// block.
int psa_sweep_plan(int l2p, int noff_pad, long long* plan) {
  if (bad_shapes(l2p, noff_pad)) return static_cast<int>(cudaErrorInvalidValue);
  Span sp;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
  const cudaError_t err = plan_span(l2p, noff_pad, &sp, &blocks, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long workers = blocks;
  const long long v[6] = {per_sm, workers, sp.units, (sp.units + workers - 1) / workers,
                          split_tiles(sp, workers, false), static_cast<long long>(smem)};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
