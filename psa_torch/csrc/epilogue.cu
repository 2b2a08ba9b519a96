// The checkable-exact top-k epilogue and its pack on Hopper (sm_90a): per
// row of stats5, the f32 keyed totals, the best, the near-tie band's
// population, the top k offsets and their stats5 columns, written as the
// (B, 6k+2) int32 pack that one fetch brings to the host.
//
// Replaces no Pallas kernel: in the JAX package this is XLA code, fused by
// XLA into the runners' one executable (psa_tpu/models/batch.py:643
// exact_topk_epilogue_rows_ops with ops/common.py keyed_f32_totals_ops,
// then :703 pack_epilogue_outputs).  The plain version is
// psa_torch/ops/epilogue.py exact_topk_epilogue_rows + pack_epilogue_outputs.
//
// Contract (the plain version's output, word for word):
//   in   stats (B, 5, np) int32 at strides (sb, sr, 1): rows 0-3 class
//             counts, row 4 the maxrank
//        w32 (4,) f32, diff32 (n_diff,) f32; noffs (B,) int32 or null and
//        then `noff` for every row; eps the f32 band half-width; g0 the
//        global offset of column 0 (a mesh shard's first offset)
//   out  (B, 6k+2) int32: [topi (k, col + g0) | stats at topi (5 x k) |
//        near | best as f32 bits], per row with
//          total = (((w0 c0 + w1 c1) + w2 c2) + w3 c3) + diff32[max(mr, 0)],
//                  each product and sum rounded once (no FMA: __fmul_rn,
//                  __fadd_rn), as the torch ops round them;
//          keyed = +-total where mr >= 0 and col < noff, else -inf;
//          best  = the largest keyed (+0.0 above -0.0); near = #{keyed >=
//                  best - eps} over all np;
//          topi  = the k columns of largest keys, by key descending, then
//                  column ascending: lax.top_k's order.
//   np >= k, 1 <= k <= kMaxK.  Scratch comes from the caller: data
//   (psa_epilogue_scratch_words int32 words, none when np <= kRowCols) and
//   tickets (B int32, zero before the call and zero again after it).
//
// Ranking: every column's key is a 64-bit composite, the order-preserving
// uint32 of its f32 key (larger float, larger uint; +0.0 above -0.0) in the
// high word and ~col in the low word: a strict total order whose top k are
// lax.top_k's, in its order.
// One launch at every shape, a grid of (blocks per row, B rows), 256
// threads a block, each thread kPer columns at a stride of 256:
//   * A block's top KP (32 or 64 >= k) composites come in two stages.  Each
//     thread's largest composite is offered to its warp, which sorts the 32
//     (bitonic, by shuffles); the 8 warps' lists meet in shared memory in
//     three rounds of one barrier.  The KP-th of these maxima is a floor:
//     KP composites lie at or above it, so nothing below can make the top.
//     Then each warp offers its lanes' other composites; a __ballot_sync
//     skips a batch of 32 with none above the floor or the warp's list, a
//     few are inserted one by one (a ballot for the place, a shuffle to
//     shift), more are sorted and merged; the lists meet again.  At random
//     keys a few composites of a block's 2,048 pass the floor.
//   * A row of <= kRowCols offsets (the batch and serve buckets) is one
//     block, which counts near against its best and writes the pack.
//   * A wider row is cut into blocks of p[kCols] offsets: kNarrowCols while
//     they fit two a streaming multiprocessor (one wave), else kRowCols
//     (ops/epilogue.block_cols chooses).  Each block writes its top KP and
//     its band count against its own largest key to scratch, then takes a
//     ticket (a __threadfence and an atomicAdd per row).  The row's last
//     block reads the others' scratch through L2 (__ldcg), the blocks
//     spread over its warps: the lists' heads (each block's largest), whose
//     top KP gives the row's best and a floor; near as the sum of the counts
//     of the blocks whose largest key is the best, plus a recount from
//     stats5 of any block whose largest key lies in [best - eps, best)
//     (none at the timed shapes); then the rest of the lists whose head
//     beats the floor (fewer than KP lists) into the same warp lists; the
//     pack; and it resets the row's ticket to 0.
//
// What bounds it on this card: latency, not bandwidth.  The function reads
// 20 bytes per offset and writes 4 (6k+2) per row: 1.8 MB at the north star
// (0.54 us of HBM), 36.7 MB for 1024 rows of 1792 (11 us).  A wide row's
// time is a chain: a block's loads, its two stages of warp sorts and
// barriers, the ticket, then the last block's reads from L2 and the same
// two stages; 1,024 one-block rows run in about two waves of the same
// chain.  PERF.md §6 has each phase's cycles (utils/epilogue_ab.py
// --phases, which builds the kernel with PSA_EPILOGUE_PHASES defined).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kRowCols = 2048;    // the widest row taken as one block
constexpr int kNarrowCols = 1024;  // the other width a wider row's blocks may take
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kMaxDiff = 64;      // diff32 entries held in shared memory
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;  // the composite keys (the type the intrinsics take)

#ifdef PSA_EPILOGUE_PHASES
// Diagnostic build only (utils/epilogue_ab.py --phases): %globaltimer and
// clock64 at the phase marks of row 0's blocks (or of the first rows of a
// one-block call): 0 entry, 1 keys, 2 top, 3 band count, 4 ticket, and in
// the row's last block 5 best and near, 6 the candidates' top, 7 the pack.
constexpr int kPhaseSlots = 2048;
__device__ unsigned long long g_phase_ns[kPhaseSlots][8];
__device__ long long g_phase_clk[kPhaseSlots][8];
#endif

__device__ __forceinline__ void mark(int slot, int i) {
#ifdef PSA_EPILOGUE_PHASES
  if (threadIdx.x == 0 && slot >= 0 && slot < kPhaseSlots) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phase_ns[slot][i] = t;
    g_phase_clk[slot][i] = clock64();
  }
#endif
}

struct Args {
  const int32_t* stats;
  long long sb, sr;
  int b, np, k, nblk, cols;
  const float* w32;
  const float* diff32;
  int n_diff;
  const int32_t* noffs;
  int noff;
  float eps;
  int is_max;
  int g0;
  int32_t* out;
  // scratch, per (row, block) of a wide row: its top KP composites and its
  // band count; tickets (B,), zero between calls
  u64* cand;
  int32_t* near_part;
  unsigned* ticket;
};

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_key(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 composite(uint32_t key, int col) {
  return (static_cast<u64>(key) << 32) | static_cast<uint32_t>(~col);
}

__device__ __forceinline__ int composite_col(u64 c) {
  return static_cast<int>(~static_cast<uint32_t>(c));
}

// keyed f32 total of one column from its stats (diff: diff32 in shared memory)
__device__ __forceinline__ float keyed_of(const Args& a, const float w[4], const float* diff,
                                          const int (&v)[5], int col, int noff) {
  float t = __fmul_rn(w[0], static_cast<float>(v[0]));
  t = __fadd_rn(t, __fmul_rn(w[1], static_cast<float>(v[1])));
  t = __fadd_rn(t, __fmul_rn(w[2], static_cast<float>(v[2])));
  t = __fadd_rn(t, __fmul_rn(w[3], static_cast<float>(v[3])));
  t = __fadd_rn(t, diff[min(max(v[4], 0), a.n_diff - 1)]);
  if (v[4] < 0 || col >= noff) return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  return a.is_max ? t : -t;
}

// keyed f32 total of column `col` of one stats row
__device__ __forceinline__ float keyed_total(const Args& a, const int32_t* st, int col,
                                             int noff, const float w[4], const float* diff) {
  const int v[5] = {st[col], st[a.sr + col], st[2 * a.sr + col], st[3 * a.sr + col],
                    st[4 * a.sr + col]};
  return keyed_of(a, w, diff, v, col, noff);
}

// the block's sum of v, in every thread (red: kWarps ints of shared memory)
__device__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // red is free from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kWarps; ++i) v += red[i];
  return v;
}

__device__ __forceinline__ u64 umax64(u64 x, u64 y) { return x > y ? x : y; }
__device__ __forceinline__ u64 umin64(u64 x, u64 y) { return x < y ? x : y; }

// A bitonic sequence over the warp's lanes, sorted descending (lane 0 the
// largest).
__device__ __forceinline__ u64 bitonic_merge(u64 v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, v, stride);
    v = (lane & stride) ? umin64(v, o) : umax64(v, o);
  }
  return v;
}

// 32 values, one a lane, sorted descending across the warp.
__device__ __forceinline__ u64 warp_sort(u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, stride);
      const bool desc = (lane & size) == 0, lower = (lane & stride) == 0;
      v = lower == desc ? umax64(v, o) : umin64(v, o);
    }
  }
  return v;
}

// A warp's running top R*32 composites: element r*32 + lane in v[r], sorted
// descending (0s where it holds fewer); thr the least a composite must beat
// to enter: the list's smallest, or `floor` where that is higher.
template <int R>
struct WarpTop {
  u64 v[R];
  u64 thr, floor;

  __device__ void clear(u64 f) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = 0;
    thr = floor = f;
  }

  __device__ void set_thr() { thr = umax64(floor, __shfl_sync(kFull, v[R - 1], 31)); }

  // v = the top R*32 of v and b (b sorted the same way)
  __device__ void merge(const u64 (&b)[R], int lane) {
    if (R == 1) {
      v[0] = bitonic_merge(umax64(v[0], __shfl_sync(kFull, b[0], 31 - lane)), lane);
    } else {
      const u64 c0 = umax64(v[0], __shfl_sync(kFull, b[R - 1], 31 - lane));
      const u64 c1 = umax64(v[R - 1], __shfl_sync(kFull, b[0], 31 - lane));
      v[0] = bitonic_merge(umax64(c0, c1), lane);
      v[R - 1] = bitonic_merge(umin64(c0, c1), lane);
    }
    set_thr();
  }

  // insert one composite x > thr, the same in every lane
  __device__ void insert(u64 x, int lane) {
    int pos = 0;  // elements above x
#pragma unroll
    for (int r = 0; r < R; ++r) pos += __popc(__ballot_sync(kFull, v[r] > x));
    u64 carry = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u64 up = __shfl_up_sync(kFull, v[r], 1);
      const u64 last = __shfl_sync(kFull, v[r], 31);
      if (lane == 0) up = carry;
      const int e = r * 32 + lane;
      v[r] = e < pos ? v[r] : e == pos ? x : up;
      carry = last;
    }
    set_thr();
  }

  // offer one composite a lane: a few that beat thr are inserted one by
  // one, more are sorted and merged
  __device__ void offer(u64 x, int lane) {
    unsigned m = __ballot_sync(kFull, x > thr);
    if (!m) return;
    if (__popc(m) <= 3) {
      do {
        const u64 y = __shfl_sync(kFull, x, __ffs(m) - 1);
        m &= m - 1;
        if (y > thr) insert(y, lane);
      } while (m);
      return;
    }
    u64 b[R];
    b[0] = warp_sort(x, lane);
#pragma unroll
    for (int r = 1; r < R; ++r) b[r] = 0;
    merge(b, lane);
  }
};

// The block's top R*32 into warp 0's `top`, the warps' lists meeting in
// shared memory `lists` (kWarps x R*32) in three rounds of one barrier: in
// round s warp w (w % 2s == 0) merges in warp w + s's list, and no slot
// written in a round is one read in the round before.  The caller puts a
// barrier between two calls.
template <int R>
__device__ void block_merge(WarpTop<R>& top, u64* lists) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 1; s < kWarps; s <<= 1) {
    if (warp % s == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) lists[warp * R * 32 + r * 32 + lane] = top.v[r];
    }
    __syncthreads();
    if (warp % (2 * s) == 0) {
      const u64* o = lists + (warp + s) * R * 32;
      if (o[0] > top.thr) {  // the other list's largest beats our smallest
        u64 b[R];
#pragma unroll
        for (int r = 0; r < R; ++r) b[r] = o[r * 32 + lane];
        top.merge(b, lane);
      }
    }
  }
}

// Warp 0's `top` becomes the block's top R*32 of the composites its threads
// hold: pass(f) calls f(x) on every composite of this thread (0: none), the
// same ones at each call, the same number of times in every thread.  First
// the block's top R*32 of the threads' maxima: its smallest is a floor no
// composite below can pass, since R*32 composites lie at or above it.  Then
// each warp offers the composites above the floor other than its lanes'
// maxima (at random keys a few in the block, inserted one by one), and the
// lists meet again.
template <int R, class Pass>
__device__ void block_top(WarpTop<R>& top, Pass pass, u64* lists, u64* floor_sh) {
  const int lane = threadIdx.x & 31;
  u64 m = 0;
  pass([&](u64 x) { m = umax64(m, x); });
  top.clear(0);
  top.offer(m, lane);
  block_merge(top, lists);
  if (threadIdx.x == 31) *floor_sh = top.v[R - 1];
  __syncthreads();
  if (threadIdx.x >= 32) top.clear(*floor_sh);
  top.floor = *floor_sh;
  pass([&](u64 x) { top.offer(x != m ? x : 0, lane); });
  block_merge(top, lists);
}

// Warp 0 writes the pack of one row from its top list.
template <int R>
__device__ void write_pack(const Args& a, int row, const WarpTop<R>& top, int near,
                           float best) {
  const int lane = threadIdx.x & 31;
  int32_t* o = a.out + static_cast<long long>(row) * (6 * a.k + 2);
  const int32_t* st = a.stats + row * a.sb;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < a.k) {
      const int col = composite_col(top.v[r]);
      o[e] = col + a.g0;
#pragma unroll
      for (int q = 0; q < 5; ++q) o[(q + 1) * a.k + e] = st[q * a.sr + col];
    }
  }
  if (lane == 0) {
    o[6 * a.k] = near;
    o[6 * a.k + 1] = __float_as_int(best);
  }
}

// One block of a row: kPer columns a thread, at a stride of kThreads.
template <int R, int kPer>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(Args a) {
  constexpr int KP = R * 32;
  __shared__ u64 lists[kWarps * KP];
  __shared__ float diff[kMaxDiff];
  __shared__ int red_i[kWarps];
  __shared__ u64 top_sh, floor_sh;
  __shared__ bool last;
  const int row = blockIdx.y, blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int c0 = blk * a.cols, c1 = min(c0 + a.cols, a.np);
  const int32_t* st = a.stats + row * a.sb;
  const int slot_mark = a.nblk == 1 ? row : row == 0 ? blk : -1;
  mark(slot_mark, 0);
  // the stats loads go out first; diff32 meets them in shared memory
  int v[kPer][5];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int col = c0 + t * kThreads + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 5; ++q) v[t][q] = col < c1 ? st[q * a.sr + col] : 0;
  }
  if (threadIdx.x < a.n_diff) diff[threadIdx.x] = a.diff32[threadIdx.x];
  const int noff = a.noffs ? a.noffs[row] : a.noff;
  const float w[4] = {a.w32[0], a.w32[1], a.w32[2], a.w32[3]};
  __syncthreads();
  u64 c[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int col = c0 + t * kThreads + threadIdx.x;
    c[t] = col < c1 ? composite(order_key(keyed_of(a, w, diff, v[t], col, noff)), col) : 0;
  }
  mark(slot_mark, 1);
  WarpTop<R> top;
  block_top(top, [&](auto f) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) f(c[t]);
  }, lists, &floor_sh);
  if (threadIdx.x == 0) top_sh = top.v[0];
  __syncthreads();
  mark(slot_mark, 2);
  // this block's band count against its own largest key
  const uint32_t mx = static_cast<uint32_t>(top_sh >> 32);
  float lo = __fsub_rn(unorder_key(mx), a.eps);
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    cnt += c[t] != 0 && unorder_key(static_cast<uint32_t>(c[t] >> 32)) >= lo;
  }
  cnt = block_sum(cnt, red_i);
  mark(slot_mark, 3);
  if (a.nblk == 1) {
    if (threadIdx.x < 32) write_pack(a, row, top, cnt, unorder_key(mx));
    mark(slot_mark, 7);
    return;
  }
  const long long base = static_cast<long long>(row) * a.nblk;
  const u64* cand = a.cand + base * KP;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) a.cand[(base + blk) * KP + r * 32 + lane] = top.v[r];
  }
  if (threadIdx.x == 0) a.near_part[base + blk] = cnt;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&a.ticket[row], 1u) == static_cast<unsigned>(a.nblk - 1);
  }
  __syncthreads();
  mark(slot_mark, 4);
  if (!last) return;
  __threadfence();
  // The last block of the row.  In round j thread (warp, lane) takes block
  // j * kThreads + lane * kWarps + warp, so that a row's few blocks spread
  // over the warps.  Stage one: the block lists' heads (their largest
  // composites; the first kKeep rounds' kept in registers with their band
  // counts).  Their top KP gives the row's best and a floor.
  constexpr int kKeep = 4;
  const int warp = threadIdx.x >> 5;
  const int mine = lane * kWarps + warp;  // this thread's block in round 0
  const auto head_of = [&](int i) {
    return i < a.nblk ? __ldcg(cand + static_cast<long long>(i) * KP) : 0;
  };
  u64 heads[kKeep];
  int counts[kKeep];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int i = j * kThreads + mine;
    heads[j] = head_of(i);
    counts[j] = i < a.nblk ? __ldcg(&a.near_part[base + i]) : 0;
  }
  top.clear(0);
#pragma unroll
  for (int j = 0; j < kKeep; ++j) top.offer(heads[j], lane);
  for (int i0 = kKeep * kThreads; i0 < a.nblk; i0 += kThreads) {
    top.offer(head_of(i0 + mine), lane);
  }
  block_merge(top, lists);
  if (threadIdx.x == 0) top_sh = top.v[0];
  if (threadIdx.x == 31) floor_sh = top.v[R - 1];
  __syncthreads();
  const u64 fl = floor_sh;
  const uint32_t rmx = static_cast<uint32_t>(top_sh >> 32);
  const float best = unorder_key(rmx);
  lo = __fsub_rn(best, a.eps);
  // near: the counts of the blocks whose largest key is the row's (against
  // the row's own line), and a recount of any block whose largest key lies
  // in [best - eps, best); round base i0, this thread's head h
  int near = 0;
  const auto count = [&](int i0, u64 h, int part) {
    const uint32_t bm = static_cast<uint32_t>(h >> 32);
    const bool in = i0 + mine < a.nblk;
    if (in && bm == rmx) near += part;
    unsigned mk = __ballot_sync(kFull, in && bm != rmx && unorder_key(bm) >= lo);
    while (mk) {
      const int b = i0 + (__ffs(mk) - 1) * kWarps + warp;
      mk &= mk - 1;
      const int e = min((b + 1) * a.cols, a.np);
      for (int col = b * a.cols + lane; col < e; col += 32) {
        near += keyed_total(a, st, col, noff, w, diff) >= lo;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kKeep; ++j) count(j * kThreads, heads[j], counts[j]);
  for (int i0 = kKeep * kThreads; i0 < a.nblk; i0 += kThreads) {
    const int i = i0 + mine;
    count(i0, head_of(i), i < a.nblk ? __ldcg(&a.near_part[base + i]) : 0);
  }
  near = block_sum(near, red_i);
  mark(slot_mark, 5);
  // Stage two: the other members of the lists whose head beats the floor
  // (fewer than KP lists), each warp its own blocks' lists, four at a time.
  if (threadIdx.x >= 32) top.clear(fl);
  top.floor = fl;
  const auto take = [&](int i0, u64 h) {
    unsigned mk = __ballot_sync(kFull, h > fl);
    while (mk) {
      u64 x[4][R];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = mk ? i0 + (__ffs(mk) - 1) * kWarps + warp : -1;
        mk &= mk - 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = r * 32 + lane;
          x[q][r] = b >= 0 && e > 0 ? __ldcg(cand + static_cast<long long>(b) * KP + e) : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < R; ++r) top.offer(x[q][r], lane);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kKeep; ++j) take(j * kThreads, heads[j]);
  for (int i0 = kKeep * kThreads; i0 < a.nblk; i0 += kThreads) take(i0, head_of(i0 + mine));
  block_merge(top, lists);
  mark(slot_mark, 6);
  if (threadIdx.x < 32) write_pack(a, row, top, near, best);
  if (threadIdx.x == 0) a.ticket[row] = 0;
  mark(slot_mark, 7);
}

// a row's blocks: one for np <= kRowCols, else blocks of `cols` offsets
int blocks_per_row(int np, int cols) { return np <= kRowCols ? 1 : (np + cols - 1) / cols; }

int top_width(int k) { return k <= 32 ? 32 : 64; }

template <int R>
void launch(const Args& a, cudaStream_t s) {
  static_assert(kRowCols % kThreads == 0 && kNarrowCols % kThreads == 0, "block widths");
  const dim3 grid(a.nblk, a.b);
  if (a.cols == kRowCols) {
    epilogue_kernel<R, kRowCols / kThreads><<<grid, kThreads, 0, s>>>(a);
  } else {
    epilogue_kernel<R, kNarrowCols / kThreads><<<grid, kThreads, 0, s>>>(a);
  }
}

// The launch's arguments, one int64 each (pointers as addresses, eps as the
// bits of its float): ctypes passes one pointer, where 19 arguments cost the
// host ~6 us a call to convert.
enum Param {
  kStats, kSb, kSr, kB, kNp, kW32, kDiff32, kNDiff, kNoffs, kNoff, kEpsBits, kIsMax, kG0,
  kK, kOut, kScratch, kScratchWords, kTickets, kStream, kCols, kParams
};

}  // namespace

extern "C" {

#ifdef PSA_EPILOGUE_PHASES
// Copy the phase marks to the host, (kPhaseSlots, 8) ns then clocks, and
// clear them on the device; returns kPhaseSlots or a negative CUDA error.
int psa_epilogue_phases(unsigned long long* ns, long long* clk) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_phase_ns, sizeof(g_phase_ns));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clk, g_phase_clk, sizeof(g_phase_clk));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_phase_ns);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_phase_ns));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return e == cudaSuccess ? kPhaseSlots : -static_cast<int>(e);
}
#endif

int psa_epilogue_cols() { return kRowCols; }
int psa_epilogue_narrow_cols() { return kNarrowCols; }
int psa_epilogue_params() { return kParams; }

// int32 words of data scratch an epilogue of these shapes needs (0: none):
// per block of a wide row (blocks of `cols` offsets) its top KP composites
// and its band count.
long long psa_epilogue_scratch_words(int b, int np, int k, int cols) {
  if (np <= kRowCols) return 0;
  return static_cast<long long>(b) * blocks_per_row(np, cols) * (2LL * top_width(k) + 1);
}

// (B, 6k+2) int32 pack of B stats5 rows in one launch on p[kStream] (see
// the note at the head of the file; p holds kParams values, enum Param);
// returns cudaGetLastError().
int psa_epilogue_launch(const long long* p) {
  const int b = static_cast<int>(p[kB]), np = static_cast<int>(p[kNp]);
  const int k = static_cast<int>(p[kK]), n_diff = static_cast<int>(p[kNDiff]);
  const int cols = np <= kRowCols ? kRowCols : static_cast<int>(p[kCols]);
  void* scratch = reinterpret_cast<void*>(p[kScratch]);
  if (b < 1 || b > 65535 || k < 1 || k > kMaxK || np < k || n_diff < 1 ||
      n_diff > kMaxDiff || (cols != kRowCols && cols != kNarrowCols) ||
      p[kScratchWords] < psa_epilogue_scratch_words(b, np, k, cols) ||
      (np > kRowCols && (scratch == nullptr || p[kTickets] == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.stats = reinterpret_cast<const int32_t*>(p[kStats]);
  a.sb = p[kSb];
  a.sr = p[kSr];
  a.b = b;
  a.np = np;
  a.k = k;
  a.nblk = blocks_per_row(np, cols);
  a.cols = cols;
  a.w32 = reinterpret_cast<const float*>(p[kW32]);
  a.diff32 = reinterpret_cast<const float*>(p[kDiff32]);
  a.n_diff = n_diff;
  a.noffs = reinterpret_cast<const int32_t*>(p[kNoffs]);
  a.noff = static_cast<int>(p[kNoff]);
  const int32_t eps_bits = static_cast<int32_t>(p[kEpsBits]);
  std::memcpy(&a.eps, &eps_bits, sizeof(a.eps));
  a.is_max = static_cast<int>(p[kIsMax]);
  a.g0 = static_cast<int>(p[kG0]);
  a.out = reinterpret_cast<int32_t*>(p[kOut]);
  a.cand = nullptr;
  a.near_part = nullptr;
  a.ticket = reinterpret_cast<unsigned*>(p[kTickets]);
  if (a.nblk > 1) {  // carve the scratch: see psa_epilogue_scratch_words
    const long long slots = static_cast<long long>(b) * a.nblk;
    a.cand = static_cast<u64*>(scratch);
    a.near_part = reinterpret_cast<int32_t*>(a.cand + slots * top_width(k));
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p[kStream]);
  if (top_width(k) == 32) {
    launch<1>(a, s);
  } else {
    launch<2>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
