// What the offset sweeps share (sweep.cu, one query; sweep_batched.cu, B
// queries): the mask table, the window's bit vectors, the warp tile, the
// cp.async.bulk / mbarrier staging helpers, the bit-sliced pair loop of one
// step, and the writes of a warp tile's stats5 (stored by its one worker, or
// added atomically where workers share it).
//
// Contract of a step: for the offsets o of a warp tile and the positions i of
// the staged Seq2 segment, with v = code[c1[o + i] & 31][c2[i] & 31], rows
// 0-3 of stats5 count the i with v > 0 and (v - 1) & 3 == k, and row 4 is the
// maxrank max(((max v - 1) >> 2) - 1, -1).  Every value is an exact integer,
// so the order of the sums (and of the atomics) cannot change a bit.
//
// The pair loop is bit-sliced: each lane owns 32 consecutive offsets, one
// bit of a 32-bit word each, so a warp tile is kGranule = 1024 offsets.  A
// worker is a block of kWarps = 2 warps on one tile: both build a step's
// bit vectors and sweep half its runs each, and warp 0 adds warp 1's counts
// to its own, makes the maxrank and writes.
//   * Masks.  From the table, once a block, lane a holds its row code[a][*]
//     and `rt` holds for each Seq1 code a a 32-bit row over the Seq2 codes b
//     of each kind: v > 0, class bit 0 ((v - 1) & 1), class bit 1
//     ((v - 1) & 2), and rank at least a threshold (v >= 4 r + 5), first the
//     table's top rank R, read from the table itself.
//   * Bit vectors.  For a step's Seq1 window (the tile's offsets and the
//     step's positions, kCols 32-position columns), vec[k][b][c] has bit j
//     when Seq1 code 32 c + j of the window is in mask k of code b: lane j
//     looks its code's rows up in `rt` and a five-round shuffle transpose
//     gives lane b its code's word.  Rows are kRow = 65 words (odd), so the
//     build's stores (lanes on codes) and the sweep's loads (lanes on
//     columns) are both free of bank conflicts.  A step that continues the
//     last one in the same tile keeps its last 32 columns (a copy) and
//     builds only the new ones.  The vectors are the block's: two warps
//     sweep one copy, so twice the warps fit an SM.
//   * Sweep.  At position i = 32 q + r of a step every lane reads code
//     b = s2[i] (one for the warp) and, for each kind, columns q + lane and
//     q + lane + 1 of row b: two conflict-free shared loads and a funnel
//     shift by r give the kind's bits for the lane's 32 offsets.  Per
//     position and warp (1024 pairs): eight loads, four funnel shifts, an
//     AND (both class bits), an OR (the top rank), and carry-save adders.
//   * Counts.  Harley-Seal over each 32-position chunk (31 carry-save
//     adders of two LOP3s a kind) keeps planes 1-16 and rolls the carry of
//     32 into six higher planes; the four counted kinds are v > 0, bit 0,
//     bit 1 and both bits, and bit-sliced subtractions turn them into the
//     four class counts at the end of the step.
//   * Maxrank, exact and top-down.  The top rank's words are ORed over the
//     step.  While some offset of the tile has met no threshold yet (a warp
//     vote), the step is swept again for the next lower threshold, with the
//     bit vectors of that kind rebuilt; a lower threshold cannot raise an
//     offset already met.  maxrank + 1 is kept bit-sliced in five planes.
//   * Out.  A 32 x 32 bit transpose a lane turns two rows' planes into the
//     lane's 32 ints of each (one a half-word), written by store_row
//     (16-byte stores) or add_row (atomics through a padded row of shared
//     memory).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psa {

constexpr int kThreads = 64;                          // a block is one worker
constexpr int kWarps = kThreads / 32;                 // of two warps
// Resident blocks an SM at most: two warps a scheduler.  On an H100 a lone
// warp keeps a scheduler's integer pipe about half busy; a second one
// sharing its bit vectors raised the sweep's rate by a tenth, where a fifth
// one-warp worker on the SM, two on one scheduler beside one on the
// others, made the launch a fifth slower.
constexpr int kBlocksPerSm = 4;
constexpr int kGranule = 32 * 32;                     // offsets per warp tile
constexpr int kPad = 256;                             // offsets pad to this
constexpr int kSegB = 1024;                           // Seq2 positions per step
constexpr int kFlush = 32;                            // positions per chunk
constexpr int kKinds = 4;                             // v > 0, bit 0, bit 1, rank
constexpr int kCols = (kGranule + kSegB) / 32;        // window columns of a step
constexpr int kRow = kCols + 1;                       // words per vector row: odd
constexpr int kPlanes = 11;                           // counts of a step <= 1024
constexpr int kMaskBytes = kKinds * 32 * 4;
constexpr int kVecBytes = kKinds * 32 * kRow * 4;
constexpr int kRowBufBytes = 32 * 33 * 4;             // add_row's padded row
constexpr int kShareBytes = (kKinds * kPlanes + 1) * 32 * 4;   // warp 1's counts

// Dynamic shared bytes of a block whose steps stage at most seg_max Seq2
// positions: masks, two mbarriers and a word of state, bit vectors, two
// Seq1 windows, two Seq2 segments, one padded row, warp 1's counts.
__host__ __device__ constexpr int block_bytes(int seg_max) {
  return kMaskBytes + 32 + kVecBytes + 2 * (kGranule + seg_max) + 2 * seg_max +
         kRowBufBytes + kShareBytes;
}

// The block's shared memory (see block_bytes).
struct Smem {
  uint32_t* rt;             // [kKinds][32] mask rows
  uint64_t* bar;            // one per ring stage
  int* state;               // warp 0's word to the block after a step
  uint32_t* vec;            // [kKinds][32][kRow] bit vectors
  uint8_t* win;             // [2][kGranule + seg_max] Seq1 windows
  uint8_t* s2;              // [2][seg_max] Seq2 segments
  int32_t* buf;             // [32][33] add_row's row
  uint32_t* share;          // [kKinds * kPlanes + 1][32] warp 1's counts

  __device__ Smem(uint8_t* smem, int seg_max) {
    rt = reinterpret_cast<uint32_t*>(smem);
    bar = reinterpret_cast<uint64_t*>(smem + kMaskBytes);
    state = reinterpret_cast<int*>(smem + kMaskBytes + 16);
    vec = reinterpret_cast<uint32_t*>(smem + kMaskBytes + 32);
    win = smem + kMaskBytes + 32 + kVecBytes;
    s2 = win + 2 * (kGranule + seg_max);
    buf = reinterpret_cast<int32_t*>(s2 + 2 * seg_max);
    share = reinterpret_cast<uint32_t*>(s2 + 2 * seg_max + kRowBufBytes);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of copies completing on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Lane 0 of a warp, before it copies into a ring stage that the warp read
// through the generic proxy in the step before last.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte k of x, zero-extended (one PRMT).
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int k) {
  return __byte_perm(x, 0, 0x4440 + k);
}

// Bits b with (b & m) == 0, for the transposes' rounds.
__host__ __device__ constexpr uint32_t lo_mask(int m) {
  return m == 16 ? 0x0000ffffu : m == 8 ? 0x00ff00ffu : m == 4 ? 0x0f0f0f0fu
                 : m == 2 ? 0x33333333u : 0x55555555u;
}

// This lane's row of the fused table: code[lane][b] is byte b % 4 of w[b / 4].
struct TableRow {
  uint32_t w[8];

  __device__ void load(const int8_t* __restrict__ code) {
    const int a = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x |= static_cast<uint32_t>(static_cast<uint8_t>(code[a * 32 + 4 * i + k])) << (8 * k);
      }
      w[i] = x;
    }
  }
  __device__ uint32_t value(int b) const { return byte_of(w[b >> 2], b & 3); }
  // The bits b of the row that pass `keep(v)`.
  template <class F>
  __device__ uint32_t bits(F keep) const {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) m |= (keep(value(b)) ? 1u : 0u) << b;
    return m;
  }
  // Rank at least r: v >= 4 r + 5 (v > 0 follows).
  __device__ uint32_t at_least(int r) const {
    const uint32_t t = 4u * r + 5u;
    return bits([t](uint32_t v) { return v >= t; });
  }
  // The largest rank of the row, or -1.
  __device__ int top_rank() const {
    int r = -1;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int v = static_cast<int>(value(b));
      if (v > 0) r = max(r, ((v - 1) >> 2) - 1);
    }
    return r;
  }
};

// Lane j's word in, lane b's word out with bit j = bit b of lane j's word:
// a 32 x 32 bit transpose over the warp in five rounds, each a shuffle, a
// rotate and a merge.
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, m);
    const bool up = lane & m;
    const uint32_t keep = up ? ~lo_mask(m) : lo_mask(m);
    const uint32_t r = __funnelshift_r(y, y, up ? m : 32 - m);
    x = (x & keep) | (r & ~keep);
  }
  return x;
}

// The block's masks: lane a's rows of kinds 0-3 (kind 3 at the top rank),
// which it writes to rt[k * 32 + a] (`put`) and puts back there after the
// lower threshold passes have used rt; `top` is the table's top rank R (-1:
// no code has one).
struct Masks {
  uint32_t rows[kKinds];
  int top;

  __device__ void make(const TableRow& row) {
    top = __reduce_max_sync(0xffffffffu, row.top_rank());
    rows[0] = row.bits([](uint32_t v) { return v > 0; });
    rows[1] = row.bits([](uint32_t v) { return v > 0 && ((v - 1) & 1); });
    rows[2] = row.bits([](uint32_t v) { return v > 0 && ((v - 1) & 2); });
    rows[3] = top >= 0 ? row.at_least(top) : 0u;
  }
  __device__ void put(uint32_t* rt) const {
    const int a = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kKinds; ++k) rt[k * 32 + a] = rows[k];
  }
};

// Columns c0, c0 + stride, ... below c1 of the bit vectors from the staged
// window `win`: lane j looks up the rows of Seq1 code 32 c + j, the warp
// transposes them, and lane b stores code b's words.
__device__ __forceinline__ void build_columns(uint32_t* vec, const uint32_t* rt,
                                              const uint8_t* win, int c0, int c1,
                                              int stride) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int c = c0; c < c1; c += stride) {
    const int a = win[c * 32 + lane] & 31;
    uint32_t x[kKinds];
#pragma unroll
    for (int k = 0; k < kKinds; ++k) x[k] = warp_transpose(rt[k * 32 + a]);
#pragma unroll
    for (int k = 0; k < kKinds; ++k) vec[(k * 32 + lane) * kRow + c] = x[k];
  }
}

// A step that continues the last one (a full kSegB) in its tile: its first
// 32 columns are the last one's columns kSegB / 32 .. kSegB / 32 + 31, which
// the two warps move, a row each in turn.
__device__ __forceinline__ void carry_columns(uint32_t* vec) {
  static_assert(kSegB / 32 >= 32, "the columns kept do not overlap those moved");
  const int lane = threadIdx.x & 31;
#pragma unroll 8
  for (int r = threadIdx.x >> 5; r < kKinds * 32; r += kWarps) {
    vec[r * kRow + lane] = vec[r * kRow + kSegB / 32 + lane];
  }
}

// A chunk's 32 Seq2 codes, four a word, masked to the table's 32 rows.
__device__ __forceinline__ void chunk_codes(const uint8_t* s2, uint32_t (&c)[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(s2);
  const uint4 a = p[0], b = p[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = w[i] & 0x1f1f1f1fu;
}

// Position R of a chunk in the main pass: the lane's words of the four
// counted kinds (v > 0, bit 0, bit 1, both bits), the top rank ORed in.
struct MainPos {
  const uint32_t* col;       // vec + q + lane: row 0, this lane's first column
  uint32_t codes[8];
  uint32_t top;

  template <int R>
  __device__ __forceinline__ void at(uint32_t (&w)[kKinds]) {
    const uint32_t* p = col + byte_of(codes[R / 4], R % 4) * kRow;
    uint32_t x[kKinds];
#pragma unroll
    for (int k = 0; k < kKinds; ++k) {
      const uint32_t lo = p[k * 32 * kRow];
      x[k] = R ? __funnelshift_r(lo, p[k * 32 * kRow + 1], R) : lo;
    }
    top |= x[3];
    w[0] = x[0];
    w[1] = x[1];
    w[2] = x[2];
    w[3] = x[1] & x[2];
  }
};

// Harley-Seal over the 2^L positions from R0: each kind's count into its
// planes 0 .. L - 1, its carry of weight 2^L out.
template <int L, int R0, class Pos>
__device__ __forceinline__ void hs_tree(uint32_t (&n)[kKinds][kPlanes],
                                        uint32_t (&out)[kKinds], Pos& pos) {
  uint32_t a[kKinds], b[kKinds];
  if constexpr (L == 1) {
    pos.template at<R0>(a);
    pos.template at<R0 + 1>(b);
  } else {
    hs_tree<L - 1, R0>(n, a, pos);
    hs_tree<L - 1, R0 + (1 << (L - 1))>(n, b, pos);
  }
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
    const uint32_t s = n[k][L - 1];
    out[k] = (s & a[k]) | (s & b[k]) | (a[k] & b[k]);
    n[k][L - 1] = s ^ a[k] ^ b[k];
  }
}

// This warp's share of the main pass of one step of `seg` positions (a
// multiple of kFlush): its chunks, every kWarps-th from the warp's index.  n
// holds each counted kind's planes for this lane's 32 offsets over them,
// top the OR of their top-rank words.
__device__ __forceinline__ void main_pass(const uint32_t* vec, const uint8_t* s2, int seg,
                                          uint32_t (&n)[kKinds][kPlanes], uint32_t& top) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) n[k][p] = 0;
  }
  MainPos pos;
  pos.top = 0;
  for (int q = threadIdx.x >> 5; q < seg / kFlush; q += kWarps) {
    pos.col = vec + q + lane;
    chunk_codes(s2 + q * kFlush, pos.codes);
    uint32_t c[kKinds];
    hs_tree<5, 0>(n, c, pos);
#pragma unroll
    for (int k = 0; k < kKinds; ++k) {      // the carry of 32 into planes 5-10
#pragma unroll
      for (int p = 5; p < kPlanes; ++p) {
        const uint32_t t = n[k][p] & c[k];
        n[k][p] ^= c[k];
        c[k] = t;
      }
    }
  }
  top = pos.top;
}

// Four lower thresholds over the step, one a kind of the bit vectors: the
// OR of this lane's words of each.
__device__ __forceinline__ void rank_pass(const uint32_t* vec, const uint8_t* s2, int seg,
                                          uint32_t (&met)[kKinds]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kKinds; ++k) met[k] = 0;
  for (int q = 0; q < seg / kFlush; ++q) {
    uint32_t codes[8];
    chunk_codes(s2 + q * kFlush, codes);
#pragma unroll
    for (int r = 0; r < kFlush; ++r) {
      const uint32_t* p = vec + lane + q + byte_of(codes[r / 4], r % 4) * kRow;
#pragma unroll
      for (int k = 0; k < kKinds; ++k) {
        const uint32_t lo = p[k * 32 * kRow];
        met[k] |= r ? __funnelshift_r(lo, p[k * 32 * kRow + 1], r) : lo;
      }
    }
  }
}

// Warp 1 hands its counts and top-rank word to warp 0 (`share`) ...
__device__ __forceinline__ void share_counts(uint32_t* share,
                                             const uint32_t (&n)[kKinds][kPlanes],
                                             uint32_t top) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) share[(k * kPlanes + p) * 32 + lane] = n[k][p];
  }
  share[kKinds * kPlanes * 32 + lane] = top;
}

// ... which adds them to its own, bit-sliced (a step's counts fit kPlanes).
__device__ __forceinline__ void add_shared_counts(const uint32_t* share,
                                                  uint32_t (&n)[kKinds][kPlanes],
                                                  uint32_t& top) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
    uint32_t c = 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const uint32_t a = n[k][p], b = share[(k * kPlanes + p) * 32 + lane];
      n[k][p] = a ^ b ^ c;
      c = (a & b) | (a & c) | (b & c);
    }
  }
  top |= share[kKinds * kPlanes * 32 + lane];
}

// Bit-sliced x -= y (the result is never negative here).
__device__ __forceinline__ void sub_planes(uint32_t (&x)[kPlanes], const uint32_t (&y)[kPlanes]) {
  uint32_t br = 0;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint32_t d = x[p] ^ y[p];
    const uint32_t nb = (~x[p] & y[p]) | (~d & br);
    x[p] = d ^ br;
    br = nb;
  }
}

// The counts of (v > 0, bit 0, bit 1, both bits) into the four class counts:
// c3 = both, c1 = bit 0 - c3, c2 = bit 1 - c3, c0 = (v > 0) - bit 0 - c2.
__device__ __forceinline__ void class_counts(uint32_t (&n)[kKinds][kPlanes]) {
  sub_planes(n[0], n[1]);
  sub_planes(n[1], n[3]);
  sub_planes(n[2], n[3]);
  sub_planes(n[0], n[2]);
}

// Two rows' planes in, ints out: the low half of v[j] is row a's value at
// offset j (the sum over p of bit j of a[p], << p), the high half row b's.
// One 32 x 32 bit transpose in this lane's registers, a's planes in rows
// 0-15 of the matrix and b's in rows 16-31.
__device__ __forceinline__ void unslice2(const uint32_t (&a)[kPlanes],
                                         const uint32_t (&b)[kPlanes], uint32_t (&v)[32]) {
  static_assert(kPlanes <= 16, "a row's values fit half a word");
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = i < kPlanes ? a[i] : 0u;
    v[16 + i] = i < kPlanes ? b[i] : 0u;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & w) continue;
      const uint32_t t = ((v[i] >> w) ^ v[i + w]) & lo_mask(w);
      v[i + w] ^= t;
      v[i] ^= t << w;
    }
  }
}

// Row r of this lane's 32 offsets (`o` its first offset of row 0, rows
// `stride` ints apart), each value plus `bias`: stored by the worker's first
// step in the tile (`first`), added to (counts) or maxed into (maxrank) by
// its later ones.  Eight 16-byte stores.
__device__ __forceinline__ void store_row(int32_t* o, long stride, int r, bool first,
                                          const uint32_t (&v)[32], int bias) {
  int4* p = reinterpret_cast<int4*>(o + r * stride);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    int4 a = make_int4(static_cast<int>(v[4 * m]) + bias, static_cast<int>(v[4 * m + 1]) + bias,
                       static_cast<int>(v[4 * m + 2]) + bias, static_cast<int>(v[4 * m + 3]) + bias);
    if (!first) {                    // this lane wrote them a step ago
      const int4 pa = p[m];
      a = r < 4 ? make_int4(a.x + pa.x, a.y + pa.y, a.z + pa.z, a.w + pa.w)
                : make_int4(max(a.x, pa.x), max(a.y, pa.y), max(a.z, pa.z), max(a.w, pa.w));
    }
    p[m] = a;
  }
}

// Row r of the first 32 x `lanes` offsets of the warp's tile (`o` its first
// offset of row 0), each value plus `bias`, added (counts) or maxed
// (maxrank) atomically into an output set to 0 and -1 beforehand.  The row
// passes through `buf` (32 x 33 ints of this warp's shared memory), so that
// lane l adds offsets l, l + 32, ...: one warp's atomics fall on 32
// consecutive ints.
__device__ __forceinline__ void add_row(int32_t* o, long stride, int r, int lanes,
                                        int32_t* buf, const uint32_t (&v)[32], int bias) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 32; ++j) buf[lane * 33 + j] = static_cast<int>(v[j]) + bias;
  __syncwarp();
#pragma unroll 8
  for (int k = 0; k < lanes; ++k) {
    const int x = buf[k * 33 + lane];
    int32_t* p = o + r * stride + k * 32 + lane;
    if (r < 4) {
      if (x) atomicAdd(p, x);
    } else if (x >= 0) {
      atomicMax(p, x);
    }
  }
  __syncwarp();                      // every lane has read the row
}

// A step's stats5 of the warp's tile (`o` its first offset of row 0, of
// which the first 32 x `lanes` lie in the output): the class counts from n,
// the maxrank from rank1 (maxrank + 1, bit-sliced), stored (`whole`: the
// worker owns every unit of the tile) or added.
__device__ __forceinline__ void write_stats5(int32_t* o, long stride, int lanes, bool whole,
                                             bool first, int32_t* buf,
                                             uint32_t (&n)[kKinds][kPlanes],
                                             const uint32_t (&rank1)[kPlanes]) {
  const int lane = threadIdx.x & 31;
  class_counts(n);
  // rows (0, 1), (2, 3) and (4, none), one transpose a pair
#pragma unroll 1
  for (int r = 0; r < 5; r += 2) {
    uint32_t pa[kPlanes], pb[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      pa[p] = r == 0 ? n[0][p] : r == 2 ? n[2][p] : rank1[p];
      pb[p] = r == 0 ? n[1][p] : r == 2 ? n[3][p] : 0u;
    }
    uint32_t both[32];
    unslice2(pa, pb, both);
#pragma unroll 1
    for (int h = 0; h < 2 && r + h < 5; ++h) {
      uint32_t v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = h ? both[j] >> 16 : both[j] & 0xffffu;
      const int bias = r + h == 4 ? -1 : 0;
      if (!whole) {
        add_row(o, stride, r + h, lanes, buf, v, bias);
      } else if (lane < lanes) {
        store_row(o + lane * 32, stride, r + h, first, v, bias);
      }
    }
  }
}

// The maxrank of one step, exact and top-down.  `top` holds the lane's
// offsets that met the top rank R in this step, `got` those that met it in
// this worker's earlier steps of the tile too (they need no lower rank: the
// tile's row 4 keeps the largest).  While some offset of the warp's tile
// (its first `lanes` lanes) has met none, the step is swept again at the
// next four lower thresholds, with the bit vectors rebuilt for them (and
// the masks put back after).  rank1 gets this step's maxrank + 1,
// bit-sliced; returns the passes made, the main one included.  Warp 0
// alone, while warp 1 waits at the step's last barrier.
__device__ __forceinline__ int step_ranks(uint32_t* vec, uint32_t* rt, const TableRow& row,
                                          const Masks& masks, const uint8_t* win,
                                          const uint8_t* s2, int seg, int lanes, uint32_t top,
                                          uint32_t got, uint32_t (&rank1)[kPlanes]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) rank1[p] = p < 5 && ((masks.top + 1) >> p & 1) ? top : 0u;
  got |= top;
  int passes = 1;
  for (int r0 = masks.top - 1;
       r0 >= 0 && __any_sync(0xffffffffu, lane < lanes && got != 0xffffffffu);
       r0 -= kKinds) {
#pragma unroll
    for (int k = 0; k < kKinds; ++k) rt[k * 32 + lane] = r0 >= k ? row.at_least(r0 - k) : 0u;
    __syncwarp();
    build_columns(vec, rt, win, 0, (kGranule + seg) / 32, 1);
    __syncwarp();
    uint32_t met[kKinds];
    rank_pass(vec, s2, seg, met);
#pragma unroll
    for (int k = 0; k < kKinds; ++k) {
      const int r = r0 - k;
      const uint32_t fresh = r >= 0 ? met[k] & ~got : 0u;
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        if ((r + 1) >> p & 1) rank1[p] |= fresh;
      }
      got |= fresh;
    }
    ++passes;
  }
  if (passes > 1) {
    __syncwarp();                    // every lane has read rt
    masks.put(rt);
    __syncwarp();
  }
  return passes;
}

// What a worker keeps across its steps: the top ranks its offsets met in
// the current tile so far (warp 0's), and its threshold passes and steps.
struct Tally {
  uint32_t got = 0;
  long passes = 0, steps = 0;

  // Once a worker, at its end: [passes, steps] added to `counters`, if any.
  __device__ void add_to(unsigned long long* counters) const {
    if (counters && threadIdx.x == 0 && steps) {
      atomicAdd(counters, static_cast<unsigned long long>(passes));
      atomicAdd(counters + 1, static_cast<unsigned long long>(steps));
    }
  }
};

// Where a step's bit vectors come from: built from its window, kept from the
// step before (the same window, left as its main pass used it), or carried
// over from a full kSegB step before it in the same tile (its last 32
// columns) with only the new columns built.
enum class Vectors { kBuild, kKeep, kCarry };

// One step of a worker, both warps: the bit vectors of the staged window
// `win`, the main pass over the staged Seq2 segment `s2` of `seg` positions
// (each warp its half of the chunks), then warp 0 adds warp 1's counts,
// makes the maxrank and writes the stats5 of tile t of the query whose
// stats5 start at `out` (rows noff_pad ints apart; `whole` and `first` as
// in write_stats5).  Returns whether the bit vectors are still those of the
// main pass (no lower threshold pass rebuilt them).
__device__ __forceinline__ bool block_step(const Smem& m, const TableRow& row,
                                           const Masks& masks, const uint8_t* win,
                                           const uint8_t* s2, int seg, Vectors vectors,
                                           int32_t* out, int noff_pad, int t, bool whole,
                                           bool first, Tally& tally) {
  const int warp = threadIdx.x >> 5;
  const int cols = (kGranule + seg) / 32;
  if (vectors == Vectors::kCarry) {
    carry_columns(m.vec);
    __syncthreads();
    build_columns(m.vec, m.rt, win, 32 + warp, cols, kWarps);
  } else if (vectors == Vectors::kBuild) {
    build_columns(m.vec, m.rt, win, warp, cols, kWarps);
  }
  __syncthreads();
  uint32_t n[kKinds][kPlanes], top;
  main_pass(m.vec, s2, seg, n, top);
  if (warp == 1) share_counts(m.share, n, top);
  __syncthreads();
  if (warp == 0) {
    add_shared_counts(m.share, n, top);
    const int lanes = min(32, (noff_pad - t * kGranule) / 32);
    if (first) tally.got = 0;
    uint32_t rank1[kPlanes];
    const int made = step_ranks(m.vec, m.rt, row, masks, win, s2, seg, lanes, top,
                                tally.got, rank1);
    tally.got |= top;
    write_stats5(out + static_cast<long>(t) * kGranule, noff_pad, lanes, whole, first,
                 m.buf, n, rank1);
    tally.passes += made;
    ++tally.steps;
    if ((threadIdx.x & 31) == 0) *m.state = made;
  }
  __syncthreads();                   // both warps are done with this stage
  return *m.state == 1;
}

}  // namespace psa
