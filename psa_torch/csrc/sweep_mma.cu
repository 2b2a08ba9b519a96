// The kernel lab's offset sweeps on Hopper (sm_90a): the one-hot contraction
// on the int8 tensor cores, a shear through shared memory and a byte-packed
// (SWAR) decode.
//
// Replaces two TPU kernels, both launched only by benchmarks/kernel_lab.py:
//   * sweep_mma_kernel<false> replaces psa_tpu/ops/_sweep_v2.py::
//     _sweep_kernel_v2 (launched by _sweep_pallas_v2): class counts folded
//     every chunk, class 3 = nonzero bytes - the rest, so lenient inputs
//     (OTHER_CODE, whose pairs are inert) are exact;
//   * sweep_mma_kernel<true> replaces psa_tpu/ops/_sweep_v3.py::
//     _sweep_kernel_v3 (launched by _sweep_pallas_v3): clean inputs only,
//     deferred counting, no valid count and row 3 left zero (the caller
//     rebuilds class 3 as n2 - the rest).
//
// Contract (the TPU kernels' layout):
//   in   c1   (l1k,) uint8 Seq1 codes, l1k = noff_pad + l2p, PAD_CODE (28)
//             past the sequence
//        c2   (l2p,) uint8 Seq2 codes, PAD_CODE past the sequence
//        code (32, 32) int8 fused table, code[c1][c2]: 0 = inert, else
//             1 + cls + 4 * (rank + 1), at most 126
//   out  (8, noff_pad) int32.  For offset o, over i < l2p with
//        v = code[c1[o + i]][c2[i]]: rows 0-2 count the i with v > 0 and
//        (v - 1) & 3 == k, row 3 likewise for k = 3 (v2) or 0 (v3), row 4 is
//        max(v) (0 if none), rows 5-7 are 0.
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
// bit 0 counts classes 0 and 2, bit 1 classes 1 and 2, both class 2; the max
// is a byte-wise max.
//
// What bounds it on this card: not the tensor cores (64 int8 ops per pair at
// 1,979 TOPS) and not HBM (each code byte serves a whole tile), but
// instructions on the CUDA cores: the decode's INT32 operations (3 per pair
// for v2, 2 for v3: the route's bound) and, in this version, as many again
// to build the band (each B fragment from a Seq1 byte, each product's four
// byte stores and their addresses), plus the band's trip through shared
// memory (one byte written and read per pair).  The design keeps the decode
// to a handful of operations per 4-pair word and folds the byte-wise
// counters with dp4a: v2 every chunk, v3 every kDeferChunks chunks (the byte
// lanes stay below 256), which is v3's point.  The shear's byte stores, the
// B fragments built again by each of the four warps that share a column
// tile, the two barriers per chunk and __vmaxu4 (emulated on Hopper) are the
// known costs this first version leaves in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                        // offsets per block
constexpr int kThreads = 256;                     // one offset per thread in the decode
constexpr int kChunk = 64;                        // Seq2 positions per band
constexpr int kWarps = kThreads / 32;
constexpr int kMTiles = kChunk / 16;              // mma rows: 16 positions each
constexpr int kNTiles = kTile / 8 + 2;            // mma columns: 8 Seq1 codes each
constexpr int kNGroups = kWarps / kMTiles;
constexpr int kNPerWarp = kNTiles / kNGroups;
constexpr int kRowPad = 16;                       // band rows for offsets -16 .. -1
constexpr int kBandRows = kTile + 2 * kRowPad;    // offsets -16 .. kTile + 15
constexpr int kRowWords = kChunk / 4 + 1;         // odd stride: the decode's reads
constexpr int kRowBytes = 4 * kRowWords;          // hit 32 distinct banks
constexpr int kDeferChunks = 255 / (kChunk / 4);  // a byte lane gains <= kChunk/4 a chunk
constexpr uint32_t kB1 = 0x01010101u;
constexpr uint32_t kL7 = 0x7F7F7F7Fu;
constexpr uint32_t kH = 0x80808080u;

static_assert(kThreads == kTile, "the decode gives each thread one offset");
static_assert(kWarps % kMTiles == 0 && kNTiles % kNGroups == 0, "warp split");

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

template <bool kV3>
__global__ void __launch_bounds__(kThreads)
sweep_mma_kernel(const uint8_t* __restrict__ c1,
                 const uint8_t* __restrict__ c2, int l2p,
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

  for (int e = tid; e < 32 * 8; e += kThreads) {
    const int b = e >> 3;                         // Seq2 code
    const int q = e & 7;                          // Seq1 codes 4q .. 4q+3
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w |= static_cast<uint32_t>(static_cast<uint8_t>(code[(4 * q + k) * 32 + b])) << (8 * k);
    }
    tab[e] = w;
  }
  __syncthreads();

  // This warp's band: rows j0 .. j0+15 of the chunk, columns from n-tile nt0.
  const int j0 = (warp % kMTiles) * 16;
  const int nt0 = (warp / kMTiles) * kNPerWarp;
  const uint32_t* row = band + (tid + kRowPad) * kRowWords;

  uint32_t mx = 0;                                // byte-wise max of v
  uint32_t n13 = 0, n23 = 0, n3 = 0, nv = 0;      // slot bit 0, bit 1, both; nonzero
  uint32_t m13 = 0, m23 = 0, m3 = 0, mv = 0;      // the same, one count per byte lane
  int pending = 0;                                // chunks in the byte lanes (v3)

  for (int p0 = 0; p0 < l2p; p0 += kChunk) {
    const uint32_t sa = c2[p0 + j0 + g] & 31;
    const uint32_t sb = c2[p0 + j0 + g + 8] & 31;
    const uint32_t a[4] = {tab[sa * 8 + t], tab[sb * 8 + t],
                           tab[sa * 8 + 4 + t], tab[sb * 8 + 4 + t]};
    const uint8_t* s1 = c1 + o0 + p0;
#pragma unroll
    for (int n = 0; n < kNPerWarp; ++n) {
      const int w0 = j0 + 8 * (nt0 + n);          // the n-tile's first column
      const uint32_t s = __ldg(s1 + w0 + g) & 31; // its column g's Seq1 code
      const uint32_t bit = 1u << (8 * (s & 3));
      const uint32_t b0 = (s >> 2) == static_cast<uint32_t>(t) ? bit : 0u;
      const uint32_t b1 = (s >> 2) == static_cast<uint32_t>(t + 4) ? bit : 0u;
      int d[4];
      mma_s8(a, b0, b1, d);
      // the shear: D[j][w] -> band row (w - j) + kRowPad, byte j
      uint8_t* dst = band8 + (w0 + 2 * t - (j0 + g) + kRowPad) * kRowBytes + j0 + g;
      dst[0] = static_cast<uint8_t>(d[0]);
      dst[kRowBytes] = static_cast<uint8_t>(d[1]);
      dst[8 - 8 * kRowBytes] = static_cast<uint8_t>(d[2]);
      dst[8 - 7 * kRowBytes] = static_cast<uint8_t>(d[3]);
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const uint32_t p = row[q];
      mx = __vmaxu4(mx, p);
      const uint32_t lo = p & kB1;
      const uint32_t hi = (p >> 1) & kB1;
      m13 += lo;
      m23 += hi;
      m3 += lo & hi;
      if (!kV3) mv += ((p + kL7) & kH) >> 7;      // bytes <= 126: no carry
    }
    if (!kV3 || ++pending == kDeferChunks) {
      n13 = __dp4a(m13, kB1, n13);
      n23 = __dp4a(m23, kB1, n23);
      n3 = __dp4a(m3, kB1, n3);
      if (!kV3) nv = __dp4a(mv, kB1, nv);
      m13 = m23 = m3 = mv = 0;
      pending = 0;
    }
    __syncthreads();                              // the band is read before it is rewritten
  }
  if (kV3) {
    n13 = __dp4a(m13, kB1, n13);
    n23 = __dp4a(m23, kB1, n23);
    n3 = __dp4a(m3, kB1, n3);
  }

  const int cls0 = static_cast<int>(n13 - n3);
  const int cls1 = static_cast<int>(n23 - n3);
  const int cls2 = static_cast<int>(n3);
  const int vmax = static_cast<int>(max(max(mx & 0xFFu, (mx >> 8) & 0xFFu),
                                        max((mx >> 16) & 0xFFu, mx >> 24)));
  int32_t* o = out + o0 + tid;
  const long stride = noff_pad;
  o[0] = cls0;
  o[stride] = cls1;
  o[2 * stride] = cls2;
  o[3 * stride] = kV3 ? 0 : static_cast<int>(nv) - cls0 - cls1 - cls2;
  o[4 * stride] = vmax;
  o[5 * stride] = 0;
  o[6 * stride] = 0;
  o[7 * stride] = 0;
}

template <bool kV3>
int launch(const void* c1, int l1k, const void* c2, int l2p, const void* code,
           void* out, int noff_pad, void* stream) {
  if (noff_pad <= 0 || noff_pad % kTile != 0 || l2p <= 0 || l2p % kChunk != 0 ||
      l1k != noff_pad + l2p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sweep_mma_kernel<kV3><<<noff_pad / kTile, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(c1), static_cast<const uint8_t*>(c2), l2p,
      static_cast<const int8_t*>(code), static_cast<int32_t*>(out), noff_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int psa_sweep_mma_tile() { return kTile; }

int psa_sweep_mma_chunk() { return kChunk; }

// v2: writes all 8 rows of `out` (8, noff_pad) on `stream`; returns
// cudaGetLastError().  noff_pad a multiple of kTile, l2p of kChunk.
int psa_sweep_v2_launch(const void* c1, int l1k, const void* c2, int l2p,
                        const void* code, void* out, int noff_pad, void* stream) {
  return launch<false>(c1, l1k, c2, l2p, code, out, noff_pad, stream);
}

// v3: the same with row 3 zero (clean inputs; the caller rebuilds class 3).
int psa_sweep_v3_launch(const void* c1, int l1k, const void* c2, int l2p,
                        const void* code, void* out, int noff_pad, void* stream) {
  return launch<true>(c1, l1k, c2, l2p, code, out, noff_pad, stream);
}

}  // extern "C"
