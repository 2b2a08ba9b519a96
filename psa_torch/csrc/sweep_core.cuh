// What the offset sweeps share (sweep.cu, one query; sweep_batched.cu, B
// queries): the expanded code table, the warp tile, the cp.async.bulk /
// mbarrier staging helpers, the pair loop of one step, and the writes of a
// warp tile's stats5 (stored by its one worker, or added atomically where
// workers share it).
//
// Contract of a step: for the offsets o of a warp tile and the positions i of
// the staged Seq2 segment, with v = code[c1[o + i] & 31][c2[i] & 31], rows
// 0-3 of stats5 count the i with v > 0 and (v - 1) & 3 == k, and row 4 is the
// maxrank max(((max v - 1) >> 2) - 1, -1).  Every value is an exact integer,
// so the order of the sums (and of the atomics) cannot change a bit.
//
// Per pair the work is one 32-bit shared load and two integer ops:
//   * the table is expanded into 32-bit entries
//       e = (v << 24) | (1 << (6 * ((v - 1) & 3)))   (0 for v == 0)
//     so one add counts the class in a 6-bit field and one unsigned max keeps
//     max(v) in the top byte; the fields drain into 12-bit counters every
//     kFlush (< 64) positions;
//   * the table is stored transposed, tab[c2][c1]: a warp reads one Seq2
//     position against 32 Seq1 codes, i.e. words of one 32-word row, 32
//     distinct banks;
//   * each lane owns kOffsetsPerThread consecutive offsets and slides a
//     register window along Seq1, so a warp tile is kGranule = 32 x 8
//     offsets;
//   * positions are taken two at a time, so one IADD3 and one VIMNMX3
//     (Hopper's 3-input max) serve two pairs, and the table is read through
//     32-bit shared addresses, so each pair costs one address add (see
//     sweep_step).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psa {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;                 // warp workers per block
constexpr int kOffsetsPerThread = 8;
constexpr int kGranule = 32 * kOffsetsPerThread;      // offsets per warp tile
constexpr int kSegB = 1024;                           // Seq2 positions per step
constexpr int kFlush = 32;                            // 6-bit fields hold 63
constexpr int kTableBytes = 32 * 32 * 4;

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

// The 32-bit word at shared address `addr`.  The table is written once,
// before the block's only barrier, so the load may be scheduled freely.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// One step: this lane's kOffsetsPerThread offsets against `seg` staged Seq2
// positions (a multiple of kFlush, at most kSegB).  `win` holds the
// kGranule + seg Seq1 codes of the warp's tile, s2 the seg Seq2 codes.  On
// return mx[j] is the largest table entry of offset j, and c02[j] / c13[j]
// hold its class counts 0 and 2 / 1 and 3 in 12-bit fields at bits 0 and 12.
//
// Per pair: one address add, one shared load, and half of an IADD3 and of a
// VIMNMX3 (positions are taken two at a time: acc += ea + eb,
// mx = max(mx, ea, eb)).  The table row's shared address is made once per
// position and the window holds codes premultiplied by 4, so the address
// is one add; codes are read four to a word and masked to the table's 32
// rows a word at a time, so a stray byte never reads outside the table.
__device__ __forceinline__ void sweep_step(uint32_t tab_s, const uint8_t* win,
                                           const uint8_t* s2, int seg,
                                           uint32_t (&mx)[kOffsetsPerThread],
                                           uint32_t (&c02)[kOffsetsPerThread],
                                           uint32_t (&c13)[kOffsetsPerThread]) {
  constexpr uint32_t kCodes = 0x1f1f1f1fu;
  const int lane = threadIdx.x & 31;
  // w1[n]: Seq1 codes lane * 8 + 4n .. + 3 of the window
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(win + lane * kOffsetsPerThread);
  const uint32_t* s2w = reinterpret_cast<const uint32_t*>(s2);
  uint32_t w[kOffsetsPerThread];      // w[j] = 4 * code at lane * 8 + i + j
  const uint32_t lo = (w1[0] & kCodes) << 2, hi = (w1[1] & kCodes) << 2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = byte_of(lo, k);
    w[4 + k] = byte_of(hi, k);
  }
#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) mx[j] = c02[j] = c13[j] = 0;
  for (int i0 = 0; i0 < seg; i0 += kFlush) {
    uint32_t acc[kOffsetsPerThread];
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) acc[j] = 0;
#pragma unroll
    for (int i4 = 0; i4 < kFlush / 4; ++i4) {
      const uint32_t c2 = s2w[i0 / 4 + i4] & kCodes;
      // 4 * codes lane * 8 + i + 8 for the 4 positions i of this word
      const uint32_t c1 = (w1[i0 / 4 + i4 + 2] & kCodes) << 2;
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        const uint32_t ra = tab_s + (byte_of(c2, k) << 7);      // row of position i
        const uint32_t rb = tab_s + (byte_of(c2, k + 1) << 7);  // and of i + 1
        const uint32_t na = byte_of(c1, k);
#pragma unroll
        for (int j = 0; j < kOffsetsPerThread; ++j) {
          const uint32_t ea = lds(ra + w[j]);
          const uint32_t eb = lds(rb + (j + 1 < kOffsetsPerThread ? w[j + 1] : na));
          acc[j] += ea + eb;
          mx[j] = __vimax3_u32(mx[j], ea, eb);
        }
#pragma unroll
        for (int j = 0; j + 2 < kOffsetsPerThread; ++j) w[j] = w[j + 2];
        w[kOffsetsPerThread - 2] = na;
        w[kOffsetsPerThread - 1] = byte_of(c1, k + 1);
      }
    }
    // drain the 6-bit fields (each at most kFlush) into 12-bit ones, which
    // hold the kSegB positions of a step
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) {
      c02[j] += acc[j] & 0x3f03fu;
      c13[j] += (acc[j] >> 6) & 0x3f03fu;
    }
  }
}

// A step's stats5 of this lane's kOffsetsPerThread offsets: v[r][j], rows
// 0-3 the counts and row 4 the maxrank, converted in registers.
__device__ __forceinline__ void step_stats5(const uint32_t (&mx)[kOffsetsPerThread],
                                            const uint32_t (&c02)[kOffsetsPerThread],
                                            const uint32_t (&c13)[kOffsetsPerThread],
                                            int (&v)[5][kOffsetsPerThread]) {
#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) {
    v[0][j] = c02[j] & 0xfff;
    v[1][j] = c13[j] & 0xfff;
    v[2][j] = c02[j] >> 12;
    v[3][j] = c13[j] >> 12;
    v[4][j] = max(((static_cast<int>(mx[j] >> 24) - 1) >> 2) - 1, -1);
  }
}

// Rows 0-4 of this lane's offsets, `o` pointing at its first offset of row
// 0 and rows `stride` ints apart: stored by the first step that writes them
// (`first`), added to (counts) and maxed into (maxrank) by a later step of
// the same worker.  Two 16-byte stores per row: a lane's 8 offsets are 32
// contiguous bytes.
__device__ __forceinline__ void store_stats5(int32_t* o, long stride, bool first,
                                             const int (&v)[5][kOffsetsPerThread]) {
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    int4* p = reinterpret_cast<int4*>(o + r * stride);
    int4 a = make_int4(v[r][0], v[r][1], v[r][2], v[r][3]);
    int4 b = make_int4(v[r][4], v[r][5], v[r][6], v[r][7]);
    if (!first) {                      // this lane wrote them a step ago
      const int4 pa = p[0], pb = p[1];
      if (r < 4) {
        a = make_int4(a.x + pa.x, a.y + pa.y, a.z + pa.z, a.w + pa.w);
        b = make_int4(b.x + pb.x, b.y + pb.y, b.z + pb.z, b.w + pb.w);
      } else {
        a = make_int4(max(a.x, pa.x), max(a.y, pa.y), max(a.z, pa.z), max(a.w, pa.w));
        b = make_int4(max(b.x, pb.x), max(b.y, pb.y), max(b.z, pb.z), max(b.w, pb.w));
      }
    }
    p[0] = a;
    p[1] = b;
  }
}

// Rows 0-4 of this warp's tile, `o` pointing at its first offset of row 0,
// added (counts) and maxed (maxrank) atomically into an output set to 0 and
// -1 beforehand.  Each row passes through `row`, kGranule ints of this
// warp's shared memory, so that lane l adds offsets l, l + 32, ...: one
// warp's atomics fall on 32 consecutive ints.
__device__ __forceinline__ void add_stats5(int32_t* o, long stride, int32_t* row,
                                           const int (&v)[5][kOffsetsPerThread]) {
  const int lane = threadIdx.x & 31;
  int4* mine = reinterpret_cast<int4*>(row + lane * kOffsetsPerThread);
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    mine[0] = make_int4(v[r][0], v[r][1], v[r][2], v[r][3]);
    mine[1] = make_int4(v[r][4], v[r][5], v[r][6], v[r][7]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kOffsetsPerThread; ++k) {
      const int x = row[k * 32 + lane];
      int32_t* p = o + r * stride + k * 32 + lane;
      if (r < 4) {
        if (x) atomicAdd(p, x);
      } else if (x >= 0) {
        atomicMax(p, x);
      }
    }
    __syncwarp();                  // every lane has read the row
  }
}

}  // namespace psa
