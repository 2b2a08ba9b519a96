// The kernel lab's v3 offset sweep on Hopper (sm_90a): v2's one-hot
// contraction on the int8 tensor cores (sweep_mma.cu) for clean inputs, with
// deferred counting, on a grid that splits Seq2 to fill the card.
//
// sweep_v3_kernel replaces psa_tpu/ops/_sweep_v3.py::_sweep_kernel_v3
// (launched by _sweep_pallas_v3, which only benchmarks/kernel_lab.py runs).
//
// Contract (the TPU kernel's layout):
//   in   c1   (l1k,) uint8 Seq1 codes, l1k = noff_pad + l2p, PAD_CODE (28)
//             past the sequence
//        c2   (l2p,) uint8 Seq2 codes, PAD_CODE past the sequence
//        code (32, 32) int8 fused table, code[c1][c2]: 0 = inert, else
//             1 + cls + 4 * (rank + 1), at most 126
//   out  (8, noff_pad) int32.  For offset o, over i < l2p with
//        v = code[c1[o + i]][c2[i]]: rows 0-2 count the i with v > 0 and
//        (v - 1) & 3 == k, row 4 is max(v) (0 if none), rows 3 and 5-7
//        are 0 (clean inputs: the caller rebuilds class 3 as n2 - the
//        rest).  Exact integers: any order of the sums and of the atomics
//        gives the same bits.
//
// The route is v2's (see sweep_mma.cu): per chunk of kChunk Seq2 positions
// the fused code of every (position, Seq1 column) pair of the band is one
// mma.sync.m16n8k32 s8 product of table rows A and one-hot Seq1 columns B,
// sheared through shared memory into one byte per (offset, position), so
// that a thread reads its offset's 4 consecutive pairs as one 32-bit word.
// v3's decode makes no valid count: per word the class slot bits go into
// byte-wise counters (lo = bit 0, hi = bit 1, both), folded with dp4a once
// per block, and the codes into a running max.
//
// What bounds it on this card: instructions on the CUDA cores, not the
// tensor cores (64 int8 ops per pair at 1,979 TOPS) nor HBM (each code byte
// serves a whole tile).  The route's own floor is the decode's ~2 INT32 ops
// per pair and the band's byte written and read in shared memory; building
// the band costs about as much again.
// What the design does about it:
//   * A grid that fills the card.  Block (tile, segment) sweeps one tile's
//     kTile offsets over one segment of whole chunks of Seq2; the chunks
//     are split evenly over the segments (lengths differ by at most one).
//     The segment count is the least that gives every resident block slot
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) two blocks and
//     keeps a segment within kLaneChunks chunks, capped at one chunk per
//     segment (psa_mma::segments in sweep_mma.cuh, shared with v2;
//     ops/_sweep_v3.v3_launch_plan is its model).  One
//     block per tile held 481 blocks on 132 SMs at 131072 x 8192, under one
//     wave; the split makes 9 x 481.
//   * Counters that hold a whole segment.  A byte lane gains at most
//     kChunk / 4 = 16 a chunk, so a segment of at most kLaneChunks = 15
//     chunks never carries out of a lane: the loop has no fold, and each
//     block folds its lanes once, at the end of its segment.
//   * Segments meet in atomics.  With more than one segment a block adds
//     rows 0-2 with atomicAdd and takes row 4 with atomicMax into an output
//     that the entry point zeroes on the same stream; with one segment the
//     block stores all 8 rows and nothing is zeroed (at 1M x 500 that ran
//     0.94-0.97x of the memset and atomics back to back, PERF.md).
//   * Each B fragment built once.  The band of a chunk spans kBandTiles = 40
//     column tiles of 8 Seq1 codes (row tile m needs tiles 2m .. 2m + 33);
//     each warp owns 5 of them, builds each one's one-hot fragment once
//     from its Seq1 byte, and issues the mma of every row tile that needs
//     it with that row tile's A fragment (all four loaded once a chunk).
//     The four warps of a row tile each built the same fragments before:
//     136 builds a chunk, now 40; the 136 mmas stay.
//   * A max the card runs natively.  Every code is <= 126, so each 16-bit
//     lane of a band word is a positive int16 that orders by its high
//     byte: a DPX 3-way max (__vimax3_s16x2) of whole words keeps the odd
//     bytes' max in the lanes' high bytes, and one of the words masked to
//     their even bytes the rest; __vmaxu4, which Hopper emulates, is gone.
// Known costs it still leaves in: the shear's four byte stores per mma (68
// STS.U8 a warp and chunk, as many shared-memory wavefronts as the issue
// slots the loop needs), two barriers per chunk, and issue at about half
// the dispatch rate (PERF.md).

#include "sweep_mma.cuh"

namespace {

using namespace psa_mma;

constexpr int kBandTiles = kNTiles + 2 * (kMTiles - 1);  // column tiles of a chunk's band: 40
constexpr int kNPerWarp = kBandTiles / kWarps;            // column tiles per warp: 5
constexpr int kLaneChunks = 255 / (kChunk / 4);   // chunks a byte lane holds: 15
constexpr int kBlocksPerSlot = 2;                 // blocks per resident block slot
// Resident blocks per SM the register budget is set for (64 registers a
// thread).  On the compiler's own budget (57, also 4 blocks) the loop ran
// 4-6 % slower back to back (PERF.md).
constexpr int kMinBlocks = 4;
constexpr uint32_t kEven = 0x00FF00FFu;           // a word's even bytes

static_assert(kChunk % 8 == 0, "the decode takes two words a step");
static_assert(kBandTiles % kWarps == 0, "every warp owns as many column tiles");
// Column tile warp + kWarps n: only the first (n = 0) and the last can lie
// outside a row tile's range 2m .. 2m + kNTiles - 1.
static_assert(2 * (kMTiles - 1) <= kWarps && kWarps * (kNPerWarp - 1) <= kNTiles,
              "the middle column tiles serve every row tile");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_v3_kernel(const uint8_t* __restrict__ c1,
                const uint8_t* __restrict__ c2, int chunks,
                const int8_t* __restrict__ code,
                int32_t* __restrict__ out, int noff_pad) {
  __shared__ uint32_t tab[32 * 8];                // tab[c2 * 8 + q] = code[4q .. 4q+3][c2]
  __shared__ uint32_t band[kBandRows * kRowWords];
  uint8_t* band8 = reinterpret_cast<uint8_t*>(band);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const long o0 = static_cast<long>(blockIdx.x) * kTile;
  const int segs = gridDim.y;
  const int c_begin = blockIdx.y * chunks / segs;
  const int c_end = (blockIdx.y + 1) * chunks / segs;

  load_table(code, tab);
  __syncthreads();

  // This warp's column tiles: warp + kWarps n, n < kNPerWarp, of the
  // chunk's kBandTiles; row tile m (positions 16m .. 16m + 15) needs the
  // column tiles 2m .. 2m + kNTiles - 1.  The lane's shear target for row
  // tile 0 and its first column tile: D[g][2t] -> band row (8 warp + 2t - g)
  // + kRowPad, byte g.
  uint8_t* const dst0 = band8 + (8 * warp + 2 * t - g + kRowPad) * kRowBytes + g;
  const uint32_t* row = band + (tid + kRowPad) * kRowWords;

  // The max of v in two 16x2 maxima (DPX): every v <= 126, so each 16-bit
  // lane of a band word is positive and orders by its high byte, and the
  // lane-wise max of whole words holds the max of the odd bytes in its high
  // bytes (mxo); the even bytes are masked into mxe.
  uint32_t mxe = 0, mxo = 0;
  uint32_t m13 = 0, m23 = 0, m3 = 0;              // slot bit 0, bit 1, both: one count per byte lane

  for (int c = c_begin; c < c_end; ++c) {
    const int p0 = c * kChunk;
    uint32_t a[kMTiles][4];                       // every row tile's A fragment
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const uint32_t sa = c2[p0 + 16 * m + g] & 31;
      const uint32_t sb = c2[p0 + 16 * m + g + 8] & 31;
      a[m][0] = tab[sa * 8 + t];
      a[m][1] = tab[sb * 8 + t];
      a[m][2] = tab[sa * 8 + 4 + t];
      a[m][3] = tab[sb * 8 + 4 + t];
    }
    const uint8_t* s1 = c1 + o0 + p0 + 8 * warp + g;  // column g of the first column tile
#pragma unroll
    for (int n = 0; n < kNPerWarp; ++n) {
      const int k = warp + kWarps * n;            // the column tile
      uint32_t b0, b1;
      one_hot_b(__ldg(s1 + 8 * kWarps * n) & 31, t, b0, b1);  // built once, used by up to 4 row tiles
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        if ((n == 0 && k < 2 * m) || (n == kNPerWarp - 1 && k >= 2 * m + kNTiles)) continue;
        int d[4];
        mma_s8(a[m], b0, b1, d);
        // the shear: D[j][w] -> band row (w - j) + kRowPad, byte j
        uint8_t* dst = dst0 + 8 * kWarps * n * kRowBytes + m * (16 - 16 * kRowBytes);
        dst[0] = static_cast<uint8_t>(d[0]);
        dst[kRowBytes] = static_cast<uint8_t>(d[1]);
        dst[8 - 8 * kRowBytes] = static_cast<uint8_t>(d[2]);
        dst[8 - 7 * kRowBytes] = static_cast<uint8_t>(d[3]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kChunk / 4; q += 2) {
      const uint32_t p = row[q];
      const uint32_t r = row[q + 1];
      mxo = __vimax3_s16x2(mxo, p, r);
      mxe = __vimax3_s16x2(mxe, p & kEven, r & kEven);
      const uint32_t lp = p & kB1, lr = r & kB1;
      const uint32_t hp = (p >> 1) & kB1, hr = (r >> 1) & kB1;
      m13 += lp + lr;
      m23 += hp + hr;
      m3 += (lp & hp) + (lr & hr);
    }
    __syncthreads();                              // the band is read before it is rewritten
  }

  const uint32_t n3 = __dp4a(m3, kB1, 0u);
  const int cls0 = static_cast<int>(__dp4a(m13, kB1, 0u) - n3);
  const int cls1 = static_cast<int>(__dp4a(m23, kB1, 0u) - n3);
  const int cls2 = static_cast<int>(n3);
  const uint32_t mx = __vimax3_s16x2(mxe, (mxo >> 8) & kEven, 0u);
  const int vmax = static_cast<int>(max(mx & 0xFFFFu, mx >> 16));
  int32_t* o = out + o0 + tid;
  const long stride = noff_pad;
  if (segs > 1) {
    atomicAdd(o, cls0);
    atomicAdd(o + stride, cls1);
    atomicAdd(o + 2 * stride, cls2);
    atomicMax(o + 4 * stride, vmax);
  } else {
    o[0] = cls0;
    o[stride] = cls1;
    o[2 * stride] = cls2;
    o[3 * stride] = 0;
    o[4 * stride] = vmax;
    o[5 * stride] = 0;
    o[6 * stride] = 0;
    o[7 * stride] = 0;
  }
}

}  // namespace

extern "C" {

// v3: (8, noff_pad) on `stream` with row 3 zero (clean inputs; the caller
// rebuilds class 3); returns the first CUDA error.  noff_pad a multiple of
// kTile, l2p of kChunk.  With more than one segment it zeroes `out` first.
int psa_sweep_v3_launch(const void* c1, int l1k, const void* c2, int l2p,
                        const void* code, void* out, int noff_pad, void* stream) {
  return launch_split(sweep_v3_kernel, kBlocksPerSlot, kLaneChunks, c1, l1k, c2, l2p, code,
                      out, noff_pad, stream);
}

// The split a v3 launch of these shapes takes on the current device
// (psa_mma::write_plan).
int psa_sweep_v3_plan(int l2p, int noff_pad, long long* plan) {
  return write_plan(sweep_v3_kernel, kBlocksPerSlot, kLaneChunks, l2p, noff_pad, plan);
}

}  // extern "C"
