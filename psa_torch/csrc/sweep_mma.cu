// The kernel lab's v2 offset sweep on Hopper (sm_90a): the one-hot
// contraction on the int8 tensor cores, a shear through shared memory and a
// byte-packed (SWAR) decode.
//
// sweep_mma_kernel replaces psa_tpu/ops/_sweep_v2.py::_sweep_kernel_v2
// (launched by _sweep_pallas_v2, which only benchmarks/kernel_lab.py
// runs): class counts folded every chunk, class 3 = nonzero bytes - the
// rest, so lenient inputs (OTHER_CODE, whose pairs are inert) are exact.
// v3, the clean-input variant with deferred counts, is its own kernel in
// sweep_mma_v3.cu; the geometry, the table and the mma are in
// sweep_mma.cuh.
//
// Contract (the TPU kernel's layout):
//   in   c1   (l1k,) uint8 Seq1 codes, l1k = noff_pad + l2p, PAD_CODE (28)
//             past the sequence
//        c2   (l2p,) uint8 Seq2 codes, PAD_CODE past the sequence
//        code (32, 32) int8 fused table, code[c1][c2]: 0 = inert, else
//             1 + cls + 4 * (rank + 1), at most 126
//   out  (8, noff_pad) int32.  For offset o, over i < l2p with
//        v = code[c1[o + i]][c2[i]]: rows 0-3 count the i with v > 0 and
//        (v - 1) & 3 == k, row 4 is max(v) (0 if none), rows 5-7 are 0.
//
// The route.  A block owns kTile offsets and walks Seq2 in chunks of kChunk
// positions.  For each chunk the fused code of every (position j, Seq1
// column w) pair of the band is one product on the tensor cores,
//     D[j, w] = sum_k A[j, k] B[k, w],  A[j, k] = code[k][s2[j]],
//                                       B[k, w] = (s1[w] == k),
// with K = 32 = the table's width, exactly one mma.sync.m16n8k32 s8 depth.
// A's rows are 4-byte words of a transposed table in shared memory; B is
// built in registers from the Seq1 codes (no one-hot array in device
// memory).  D[j, w] belongs to offset w - j: it is sheared into band row
// w - j, byte j, so that 4 consecutive positions of one offset are one
// 32-bit word, and each thread then decodes its offset's row 4 pairs a word:
// the slot v & 3 is 1, 2, 3, 0 for classes 0, 1, 2, 3 (and 0 for inert), so
// bit 0 counts classes 0 and 2, bit 1 classes 1 and 2, both class 2, and
// the high bit of v + 0x7F marks the nonzero (valid) bytes.
//
// What bounds it on this card: not the tensor cores (64 int8 ops per pair at
// 1,979 TOPS) and not HBM (each code byte serves a whole tile), but
// instructions on the CUDA cores: the decode's INT32 operations (10.5 per
// 4-pair word, ops/_sweep_v2.DECODE_OPS_PER_WORD: the route's bound) and
// about as many again to build the band (each product's four byte stores
// and their addresses), plus the band's trip through shared memory (one
// byte written and read per pair).  What the design does about it:
//   * A grid that fills the card.  Block (tile, segment) sweeps one tile's
//     kTile offsets over one segment of whole chunks of Seq2, split evenly
//     (psa_mma::launch_split in sweep_mma.cuh, shared with v3).  The
//     counters fold every chunk, so a segment needs no lane cap: the
//     segment count is the least that gives every resident block slot
//     kBlocksPerSlot blocks, capped at one chunk per segment
//     (ops/_sweep_v2.v2_launch_plan is its model).  One block per tile held
//     481 blocks on 132 SMs at 131072 x 8192, under one wave; the split
//     makes 3 x 481.  Segments meet in atomics: rows 0-3 (class 3 = nonzero
//     - the rest is additive over segments) with atomicAdd, row 4 with
//     atomicMax; with one segment the block stores all 8 rows.
//   * Each B fragment built once (build_band, v3's loop; sweep_mma_v3.cu
//     keeps its own copy, since calling one shared band function changed
//     v3's SASS): each warp owns 5 of the chunk's 40 column tiles, builds
//     each one's one-hot fragment once and runs the mma of every row tile
//     that needs it.  The four warps that share a column tile each built it
//     before: 136 builds a chunk, now 40; the 136 mmas stay.
//   * A decode the card runs natively, two words a step.  The max: every
//     code is <= 126, so each 16-bit lane of a band word is a positive
//     int16 that orders by its high byte, and two DPX 3-way maxima
//     (__vimax3_s16x2), of whole words and of words masked to their even
//     bytes, keep it; the unsigned byte-wise max, which Hopper emulates in
//     several instructions a word, is gone.  The valid count: dp4a of each
//     word's masked high bits (128 per nonzero byte, at most 8,192 a
//     chunk), rescaled into its 32-bit counter every chunk, so that no
//     length of Seq2 overflows it.  The class counters stay byte-wise and
//     fold with dp4a every chunk.
// The shear's byte stores and the two barriers per chunk are the known
// costs this version leaves in.

#include "sweep_mma.cuh"

namespace {

using namespace psa_mma;

// The band of one chunk, each B fragment built once, as in v3's loop
// (sweep_mma_v3.cu).  The band spans kBandTiles = 40 column tiles of 8
// Seq1 codes (row tile m, positions 16m .. 16m + 15, needs the column tiles
// 2m .. 2m + kNTiles - 1); warp w owns the column tiles w + kWarps n,
// n < kBandPerWarp, builds each one's one-hot fragment once from its Seq1
// byte, and runs the mma of every row tile that needs it with that row
// tile's A fragment (all four loaded once a chunk).
constexpr int kBandTiles = kNTiles + 2 * (kMTiles - 1);  // column tiles of a chunk's band: 40
constexpr int kBandPerWarp = kBandTiles / kWarps;         // column tiles per warp: 5

static_assert(kBandTiles % kWarps == 0, "every warp owns as many column tiles");
// Column tile warp + kWarps n: only the first (n = 0) and the last can lie
// outside a row tile's range 2m .. 2m + kNTiles - 1.
static_assert(2 * (kMTiles - 1) <= kWarps && kWarps * (kBandPerWarp - 1) <= kNTiles,
              "the middle column tiles serve every row tile");

// The lane's shear target for row tile 0 and the warp's first column tile:
// D[g][2t] -> band row (8 warp + 2t - g) + kRowPad, byte g.
__device__ __forceinline__ uint8_t* band_target(uint32_t* band, int warp, int g, int t) {
  return reinterpret_cast<uint8_t*>(band) + (8 * warp + 2 * t - g + kRowPad) * kRowBytes + g;
}

// Writes chunk p0's fused codes into the band: D[j][w] -> band row
// (w - j) + kRowPad, byte j, for the block's tile at offset o0.  `dst0` is
// band_target's.  The caller synchronises after it.
__device__ __forceinline__ void build_band(const uint8_t* __restrict__ c1,
                                           const uint8_t* __restrict__ c2,
                                           const uint32_t* tab, uint8_t* dst0, long o0,
                                           int p0, int warp, int g, int t) {
  uint32_t a[kMTiles][4];                         // every row tile's A fragment
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
  for (int n = 0; n < kBandPerWarp; ++n) {
    const int k = warp + kWarps * n;              // the column tile
    uint32_t b0, b1;
    one_hot_b(__ldg(s1 + 8 * kWarps * n) & 31, t, b0, b1);  // built once, used by up to 4 row tiles
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      if ((n == 0 && k < 2 * m) || (n == kBandPerWarp - 1 && k >= 2 * m + kNTiles)) continue;
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
}

constexpr uint32_t kL7 = 0x7F7F7F7Fu;
constexpr uint32_t kH = 0x80808080u;
constexpr uint32_t kEven = 0x00FF00FFu;           // a word's even bytes
constexpr int kBlocksPerSlot = 2;                 // blocks per resident block slot
// Resident blocks per SM the register budget is set for (64 registers a
// thread).  On the compiler's own budget (58, also 4 blocks) the loop has
// fewer instructions (6.80 a pair against 7.55) but ran 2-4 % slower back to
// back (PERF.md).
constexpr int kMinBlocks = 4;

static_assert(kChunk % 8 == 0, "the decode takes two words a step");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_mma_kernel(const uint8_t* __restrict__ c1,
                 const uint8_t* __restrict__ c2, int chunks,
                 const int8_t* __restrict__ code,
                 int32_t* __restrict__ out, int noff_pad) {
  __shared__ uint32_t tab[32 * 8];                // tab[c2 * 8 + q] = code[4q .. 4q+3][c2]
  __shared__ uint32_t band[kBandRows * kRowWords];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const long o0 = static_cast<long>(blockIdx.x) * kTile;
  const int segs = gridDim.y;
  const int c_begin = static_cast<int>(static_cast<long>(blockIdx.y) * chunks / segs);
  const int c_end = static_cast<int>(static_cast<long>(blockIdx.y + 1) * chunks / segs);

  load_table(code, tab);
  __syncthreads();

  uint8_t* const dst0 = band_target(band, warp, g, t);
  const uint32_t* row = band + (tid + kRowPad) * kRowWords;

  // The max of v in two 16x2 maxima (DPX): every v <= 126, so each 16-bit
  // lane of a band word is positive and orders by its high byte, and the
  // lane-wise max of whole words holds the max of the odd bytes in its high
  // bytes (mxo); the even bytes are masked into mxe.
  uint32_t mxe = 0, mxo = 0;
  uint32_t n13 = 0, n23 = 0, n3 = 0, nv = 0;      // slot bit 0, bit 1, both; nonzero
  uint32_t m13 = 0, m23 = 0, m3 = 0;              // the same, one count per byte lane
  uint32_t mv = 0;                                // 128 per nonzero byte

  for (int c = c_begin; c < c_end; ++c) {
    build_band(c1, c2, tab, dst0, o0, c * kChunk, warp, g, t);
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
      // a byte's high bit after + 0x7F: nonzero (bytes <= 126: no carry)
      mv = __dp4a((p + kL7) & kH, kB1, mv);
      mv = __dp4a((r + kL7) & kH, kB1, mv);
    }
    n13 = __dp4a(m13, kB1, n13);
    n23 = __dp4a(m23, kB1, n23);
    n3 = __dp4a(m3, kB1, n3);
    nv += mv >> 7;
    m13 = m23 = m3 = mv = 0;
    __syncthreads();                              // the band is read before it is rewritten
  }

  const int cls0 = static_cast<int>(n13 - n3);
  const int cls1 = static_cast<int>(n23 - n3);
  const int cls2 = static_cast<int>(n3);
  const uint32_t mx = __vimax3_s16x2(mxe, (mxo >> 8) & kEven, 0u);
  const int vmax = static_cast<int>(max(mx & 0xFFFFu, mx >> 16));
  const int cls3 = static_cast<int>(nv) - cls0 - cls1 - cls2;
  int32_t* o = out + o0 + tid;
  const long stride = noff_pad;
  if (segs > 1) {
    atomicAdd(o, cls0);
    atomicAdd(o + stride, cls1);
    atomicAdd(o + 2 * stride, cls2);
    atomicAdd(o + 3 * stride, cls3);
    atomicMax(o + 4 * stride, vmax);
  } else {
    o[0] = cls0;
    o[stride] = cls1;
    o[2 * stride] = cls2;
    o[3 * stride] = cls3;
    o[4 * stride] = vmax;
    o[5 * stride] = 0;
    o[6 * stride] = 0;
    o[7 * stride] = 0;
  }
}

}  // namespace

extern "C" {

int psa_sweep_mma_tile() { return kTile; }

int psa_sweep_mma_chunk() { return kChunk; }

// v2: (8, noff_pad) on `stream`; returns the first CUDA error.  noff_pad a
// multiple of kTile, l2p of kChunk.  With more than one segment it zeroes
// `out` first.
int psa_sweep_v2_launch(const void* c1, int l1k, const void* c2, int l2p,
                        const void* code, void* out, int noff_pad, void* stream) {
  return launch_split(sweep_mma_kernel, kBlocksPerSlot, kNoLaneCap, c1, l1k, c2, l2p, code,
                      out, noff_pad, stream);
}

// The split a v2 launch of these shapes takes on the current device
// (psa_mma::write_plan).
int psa_sweep_v2_plan(int l2p, int noff_pad, long long* plan) {
  return write_plan(sweep_mma_kernel, kBlocksPerSlot, kNoLaneCap, l2p, noff_pad, plan);
}

}  // extern "C"
