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
//   noff_pad is a multiple of kGranule (256), l2p of kFlush (32); c1, c2 and
//   out are 16-byte aligned (the copies below are 16-byte bulk copies).
//
// What bounds it on this card: the shared-memory table reads, with the
// INT32 issue rate as close.  Per (offset, position) pair the work is one
// table read (32 lanes per SM per clock) and two integer ops (sweep_core.cuh's
// pair loop), while a code byte from device memory serves a whole warp tile:
// 100k x 10k holds 9.0e8 real pairs, 0.108 ms at the table-read rate,
// against ~0.1 MB of codes in and 1.8 MB of stats out (~0.001 ms of HBM).
// What the design does about it:
//   * The pair loop is the batched kernels' (sweep_core.cuh sweep_step):
//     32-bit shared addresses, a window premultiplied by 4, codes read four
//     to a word, two positions per IADD3 and per VIMNMX3.
//   * Warp tiles of kGranule = 32 lanes x 8 offsets, so a query's offsets
//     pad to 256s, not to 1024-offset blocks.
//   * An even ("Stream-K") split of one query over a persistent grid.  The
//     work is U = tiles x l2p / 32 units of (warp tile, 32 positions of
//     Seq2), tile-major.  The grid holds as many blocks as the card has
//     resident slots (no more warps than units), each warp is a worker, and
//     worker w of W takes the units [w U / W, (w + 1) U / W): no worker has
//     more than one unit above the average, however few tiles a long Seq2
//     leaves.  A range may start or end inside a tile and may cover several
//     tiles; the worker walks it in steps of at most kSegB positions within
//     one tile.
//   * Staging that overlaps the sweep.  Lane 0 of a warp copies the next
//     step's Seq1 window and Seq2 segment into the other stage of a
//     two-stage ring in shared memory with cp.async.bulk (Hopper's 1-D TMA),
//     completing on that stage's mbarrier, while the warp sweeps the
//     current step.  No thread spends an instruction per byte on staging,
//     and no block-wide barrier stops the sweep.  Every copy is a multiple
//     of 16 bytes: steps start at multiples of 32 positions, tiles at
//     multiples of 256 offsets.
//   * stats5 written directly.  A worker that owns every unit of a tile
//     stores its 5 rows with 16-byte stores (a later step of the tile adds
//     into them).  Where a tile is shared between workers, each adds its
//     counts with atomicAdd and its maxrank with atomicMax (the conversion
//     is monotone), through a row of shared memory so that a warp's atomics
//     fall on 32 consecutive ints; the entry point then first sets counts
//     to 0 and maxranks to -1.  No row of zeros is written and no pass over
//     the output follows the kernel.

#include <climits>

#include "sweep_core.cuh"

using namespace psa;

namespace {

// One launch's work (see the note at the head of the file).
struct Span {
  const uint8_t* c1;
  const uint8_t* c2;
  int32_t* out;
  int l2p, noff_pad;
  int upt;          // units per tile: l2p / kFlush
  int seg_max;      // min(l2p, kSegB): a ring stage's Seq2 bytes
  int units;        // noff_pad / kGranule * upt
};

__host__ __device__ constexpr int warp_bytes(int seg_max) {
  // two mbarriers, two Seq1 windows, two Seq2 segments, one row of a tile
  return 16 + 2 * (kGranule + seg_max) + 2 * seg_max + 4 * kGranule;
}

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
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);   // tab[c2 * 32 + c1]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int win_bytes = kGranule + sp.seg_max;
  uint8_t* mine = smem + kTableBytes + warp * warp_bytes(sp.seg_max);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mine);   // one per ring stage
  uint8_t* win = mine + 16;                            // [2][win_bytes]
  uint8_t* s2 = win + 2 * win_bytes;                   // [2][seg_max]
  int32_t* row = reinterpret_cast<int32_t*>(s2 + 2 * sp.seg_max);  // [kGranule]

  expand_table(tab, code);
  if (lane == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Steps cur, nxt;
  cur.start(sp, static_cast<long>(warp) * gridDim.x + blockIdx.x,
            static_cast<long>(gridDim.x) * kWarps);
  nxt = cur;
  // The producer (lane 0) runs one step ahead of the sweep.  Step n uses
  // ring stage n & 1, whose mbarrier completes once per use: its phase
  // parity at step n is (n >> 1) & 1, whatever tiles the steps fall in.
  auto produce = [&](int stage) {
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect(bar + stage, kGranule + 2 * nxt.seg);
      bulk_copy(s2 + stage * sp.seg_max, sp.c2 + nxt.p0, nxt.seg, bar + stage);
      bulk_copy(win + stage * win_bytes,
                sp.c1 + static_cast<long>(nxt.t) * kGranule + nxt.p0,
                kGranule + nxt.seg, bar + stage);
    }
    nxt.next(sp);
  };
  if (!nxt.done()) produce(0);

  const uint32_t tab_s = smem_u32(tab);
  uint32_t mx[kOffsetsPerThread], c02[kOffsetsPerThread], c13[kOffsetsPerThread];
  int v[5][kOffsetsPerThread];
  for (int n = 0; !cur.done(); ++n) {
    const int stage = n & 1;
    if (!nxt.done()) produce(stage ^ 1);
    mbar_wait(bar + stage, static_cast<uint32_t>(n >> 1) & 1);
    sweep_step(tab_s, win + stage * win_bytes, s2 + stage * sp.seg_max, cur.seg,
               mx, c02, c13);
    step_stats5(mx, c02, c13, v);
    int32_t* o = sp.out + static_cast<long>(cur.t) * kGranule;
    if (cur.whole) {
      store_stats5(o + lane * kOffsetsPerThread, sp.noff_pad, cur.first, v);
    } else {
      add_stats5(o, sp.noff_pad, row, v);
    }
    __syncwarp();                  // every lane is done with this stage
    cur.next(sp);
  }
}

bool bad_shapes(int l2p, int noff_pad) {
  return noff_pad <= 0 || noff_pad % kGranule != 0 || l2p <= 0 || l2p % kFlush != 0 ||
         static_cast<long>(noff_pad / kGranule) * (l2p / kFlush) > INT_MAX - kSegB;
}

// The even split of a launch of these shapes: the span, the grid (no more
// warps than units), the dynamic shared bytes per block and the resident
// blocks per SM.
cudaError_t plan_span(int l2p, int noff_pad, Span* sp, int* blocks, size_t* smem,
                      int* per_sm) {
  sp->l2p = l2p;
  sp->noff_pad = noff_pad;
  sp->upt = l2p / kFlush;
  sp->seg_max = min(l2p, kSegB);
  sp->units = noff_pad / kGranule * sp->upt;
  *smem = kTableBytes + kWarps * static_cast<size_t>(warp_bytes(sp->seg_max));
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, sweep_kernel, kThreads,
                                                           *smem)) != cudaSuccess) {
    return err;
  }
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<int>(min(static_cast<long>(sms) * *per_sm,
                                 (static_cast<long>(sp->units) + kWarps - 1) / kWarps));
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

int psa_sweep_tile() { return kGranule; }

int psa_sweep_align() { return kFlush; }

int psa_sweep_seg() { return kSegB; }

const char* psa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (5, noff_pad) stats5 of one query on `stream`; returns cudaGetLastError().
int psa_sweep_launch(const void* c1, int l1k, const void* c2, int l2p,
                     const void* code, void* out, int noff_pad, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_tiles(sp, static_cast<long>(blocks) * kWarps, true)) {
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
// plan[0..5] = resident blocks per SM, warp workers, units, the most units
// one worker takes, tiles shared between workers, dynamic shared bytes per
// block.
int psa_sweep_plan(int l2p, int noff_pad, long long* plan) {
  if (bad_shapes(l2p, noff_pad)) return static_cast<int>(cudaErrorInvalidValue);
  Span sp;
  int blocks = 0, per_sm = 0;
  size_t smem = 0;
  const cudaError_t err = plan_span(l2p, noff_pad, &sp, &blocks, &smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long workers = static_cast<long long>(blocks) * kWarps;
  const long long v[6] = {per_sm, workers, sp.units, (sp.units + workers - 1) / workers,
                          split_tiles(sp, workers, false), static_cast<long long>(smem)};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
