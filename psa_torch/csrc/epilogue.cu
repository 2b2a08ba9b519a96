// The checkable-exact top-k epilogue and its pack on Hopper (sm_90a): per
// row of stats5, the f32 keyed totals, the best, the near-tie band's
// population, the top k offsets and their stats5 columns, written as the
// (B, 6k+2) int32 pack that one fetch brings to the host.
//
// Replaces no Pallas kernel: in the JAX package this is XLA code, fused by
// XLA into the runners' one executable (psa_tpu/models/batch.py:643
// exact_topk_epilogue_rows_ops with ops/common.py keyed_f32_totals_ops,
// then :703 pack_epilogue_outputs).  The port ran it as ~15 torch launches
// (psa_torch/models/batch.py exact_topk_epilogue_rows and
// pack_epilogue_outputs, kept as the plain version); here it is one launch
// when a row fits one block (np <= kCols: the batch and serve buckets) and
// two otherwise, with no host synchronisation.
//
// Contract (the plain version's output, bit for bit up to the order of
// equal keys):
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
//          best  = max keyed; near = #{keyed >= best - eps} over all np;
//          topi  = k distinct columns whose keys are the k largest (ties at
//                  the k-th key in any order; -inf columns fill the rest).
//   np >= k, 1 <= k <= kMaxK.  Scratch comes from the caller
//   (psa_epilogue_scratch_words int32 words, none when np <= kCols).
//
// What bounds it on this card: latency, not bandwidth.  The function reads
// 20 bytes per offset and writes 4 (6k+2) per row: 1.8 MB at the north
// star (0.54 us of HBM), 7.3 MB for 1024 rows of 1792 (2.2 us).  So the
// design spends few passes and no host round trip:
//   * Launch 1, a grid of (np / kCols blocks, B rows): each block computes
//     its kCols keys into shared memory as order-preserving uint32 (larger
//     float, larger uint; out-of-range columns 0, below -inf), their max,
//     and its top k by a radix select on those keys (four 8-bit histogram
//     passes in shared memory, the digit found by one warp's scan, then one
//     compaction pass).  A row of one block then counts `near` on its
//     shared keys and writes the pack: the batch path's one launch.
//   * Otherwise each block stores its keys, max and candidates to scratch,
//     and launch 2, the same grid, counts `near` per block
//     against the row's best (every block reduces the row's block maxima).
//     The last block of a row to finish (a __threadfence and an atomic
//     ticket per row) sums `near`, merges the candidates and writes the
//     pack, selecting the row's top k from the blocks' k candidates each
//     (45 x 32 keys at the north star) in place in scratch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 2048;    // offsets per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;

struct Args {
  const int32_t* stats;
  long long sb, sr;
  int b, np, k, nblk;
  const float* w32;
  const float* diff32;
  int n_diff;
  const int32_t* noffs;
  int noff;
  float eps;
  int is_max;
  int g0;
  int32_t* out;
  // scratch, rows of nblk (x k) per stats row; keys (B, np)
  uint32_t* cand_key;
  int32_t* cand_idx;
  uint32_t* blk_max;
  int32_t* near_part;
  unsigned* ticket;
  uint32_t* keys;
};

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_key(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// keyed f32 total of column `col` of one stats row
__device__ __forceinline__ float keyed_total(const Args& a, const int32_t* st, int col,
                                             int noff, const float w[4]) {
  const int32_t mr = st[4 * a.sr + col];
  float t = __fmul_rn(w[0], static_cast<float>(st[col]));
  t = __fadd_rn(t, __fmul_rn(w[1], static_cast<float>(st[a.sr + col])));
  t = __fadd_rn(t, __fmul_rn(w[2], static_cast<float>(st[2 * a.sr + col])));
  t = __fadd_rn(t, __fmul_rn(w[3], static_cast<float>(st[3 * a.sr + col])));
  t = __fadd_rn(t, a.diff32[min(max(mr, 0), a.n_diff - 1)]);
  if (mr < 0 || col >= noff) return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  return a.is_max ? t : -t;
}

template <class T, class Op>
__device__ T block_reduce(T v, Op op, T* red) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red is free from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kWarps; ++i) v = op(v, red[i]);
  return v;
}

struct MaxOp {
  __device__ uint32_t operator()(uint32_t x, uint32_t y) const { return x > y ? x : y; }
};
struct SumOp {
  __device__ int operator()(int x, int y) const { return x + y; }
};

struct Select {
  unsigned hist[256];
  uint32_t prefix, mask;
  int rem;  // of the items equal to the threshold, how many to take
  int n_gt, n_eq;
  uint32_t red_u[kWarps];
  int red_i[kWarps];
  uint32_t key[kMaxK];
  int idx[kMaxK];
};

// Warp 0: the digit at `shift` holding the rem-th largest key among those
// matching prefix; lane l scans the digits 255 - 8l down to 248 - 8l.
__device__ void pick_digit(Select& s, int shift) {
  const int lane = threadIdx.x;
  const int top = 255 - 8 * lane;
  unsigned h[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = s.hist[top - i];
    sum += h[i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned excl = incl - sum;
  const unsigned rem = static_cast<unsigned>(s.rem);
  const unsigned hit = __ballot_sync(0xffffffffu, excl < rem && incl >= rem);
  if (lane == __ffs(hit) - 1) {
    unsigned c = excl;
    for (int i = 0; i < 8; ++i) {
      if (c + h[i] >= rem) {
        s.prefix |= static_cast<uint32_t>(top - i) << shift;
        s.mask |= 255u << shift;
        s.rem = static_cast<int>(rem - c);
        break;
      }
      c += h[i];
    }
  }
}

// The k largest of n >= k keys key(i) into s.key / s.idx (slots in no
// order); ties at the k-th key are taken in the order the atomics give.
template <class Key, class Idx>
__device__ void select_top(Key key, Idx idx, int n, int k, Select& s) {
  if (threadIdx.x == 0) {
    s.prefix = 0;
    s.mask = 0;
    s.rem = k;
    s.n_gt = 0;
    s.n_eq = 0;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    const uint32_t prefix = s.prefix, mask = s.mask;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t u = key(i);
      if ((u & mask) == prefix) atomicAdd(&s.hist[(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) pick_digit(s, shift);
    __syncthreads();
  }
  const uint32_t thr = s.prefix;
  const int take_eq = s.rem, n_gt = k - take_eq;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t u = key(i);
    if (u > thr) {
      const int p = atomicAdd(&s.n_gt, 1);
      s.key[p] = u;
      s.idx[p] = idx(i);
    } else if (u == thr) {
      const int p = atomicAdd(&s.n_eq, 1);
      if (p < take_eq) {
        s.key[n_gt + p] = u;
        s.idx[n_gt + p] = idx(i);
      }
    }
  }
  __syncthreads();
}

// The pack of one row from the selected columns s.idx.
__device__ void write_pack(const Args& a, int row, const Select& s, int near, float best) {
  int32_t* o = a.out + static_cast<long long>(row) * (6 * a.k + 2);
  const int32_t* st = a.stats + row * a.sb;
  for (int j = threadIdx.x; j < a.k; j += kThreads) {
    const int col = s.idx[j];
    o[j] = col + a.g0;
#pragma unroll
    for (int r = 0; r < 5; ++r) o[(r + 1) * a.k + j] = st[r * a.sr + col];
  }
  if (threadIdx.x == 0) {
    o[6 * a.k] = near;
    o[6 * a.k + 1] = __float_as_int(best);
  }
}

__global__ void __launch_bounds__(kThreads) epilogue_keys_kernel(Args a) {
  __shared__ uint32_t keys[kCols];
  __shared__ Select s;
  const int row = blockIdx.y, blk = blockIdx.x;
  const int c0 = blk * kCols;
  const int32_t* st = a.stats + row * a.sb;
  const int noff = a.noffs ? a.noffs[row] : a.noff;
  const float w[4] = {a.w32[0], a.w32[1], a.w32[2], a.w32[3]};
  uint32_t mx = 0;
#pragma unroll
  for (int t = 0; t < kCols / kThreads; ++t) {
    const int j = t * kThreads + threadIdx.x;
    const int col = c0 + j;
    uint32_t u = 0;
    if (col < a.np) {
      u = order_key(keyed_total(a, st, col, noff, w));
      if (a.nblk > 1) a.keys[static_cast<long long>(row) * a.np + col] = u;
    }
    keys[j] = u;
    mx = u > mx ? u : mx;
  }
  mx = block_reduce(mx, MaxOp(), s.red_u);
  select_top([&](int i) { return keys[i]; }, [&](int i) { return c0 + i; }, kCols, a.k, s);
  if (a.nblk == 1) {
    const float best = unorder_key(mx);
    const float lo = __fsub_rn(best, a.eps);
    int cnt = 0;
    for (int j = threadIdx.x; j < a.np; j += kThreads) cnt += unorder_key(keys[j]) >= lo;
    write_pack(a, row, s, block_reduce(cnt, SumOp(), s.red_i), best);
    return;
  }
  const long long slot = static_cast<long long>(row) * a.nblk + blk;
  for (int j = threadIdx.x; j < a.k; j += kThreads) {
    a.cand_key[slot * a.k + j] = s.key[j];
    a.cand_idx[slot * a.k + j] = s.idx[j];
  }
  if (threadIdx.x == 0) {
    a.blk_max[slot] = mx;
    if (blk == 0) a.ticket[row] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) epilogue_merge_kernel(Args a) {
  __shared__ Select s;
  __shared__ bool last;
  const int row = blockIdx.y, blk = blockIdx.x;
  const long long base = static_cast<long long>(row) * a.nblk;
  uint32_t mx = 0;
  for (int i = threadIdx.x; i < a.nblk; i += kThreads) mx = max(mx, a.blk_max[base + i]);
  mx = block_reduce(mx, MaxOp(), s.red_u);
  const float best = unorder_key(mx);
  const float lo = __fsub_rn(best, a.eps);
  const int c0 = blk * kCols, c1 = min(c0 + kCols, a.np);
  const uint32_t* keys = a.keys + static_cast<long long>(row) * a.np;
  int cnt = 0;
  for (int col = c0 + threadIdx.x; col < c1; col += kThreads) {
    cnt += unorder_key(keys[col]) >= lo;
  }
  cnt = block_reduce(cnt, SumOp(), s.red_i);
  if (threadIdx.x == 0) {
    a.near_part[base + blk] = cnt;
    __threadfence();
    last = atomicAdd(&a.ticket[row], 1u) == static_cast<unsigned>(a.nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int near = 0;
  for (int i = threadIdx.x; i < a.nblk; i += kThreads) near += __ldcg(&a.near_part[base + i]);
  near = block_reduce(near, SumOp(), s.red_i);
  select_top([&](int i) { return a.cand_key[base * a.k + i]; },
             [&](int i) { return a.cand_idx[base * a.k + i]; }, a.nblk * a.k, a.k, s);
  write_pack(a, row, s, near, best);
}

int blocks_per_row(int np) { return (np + kCols - 1) / kCols; }

}  // namespace

extern "C" {

int psa_epilogue_cols() { return kCols; }

// int32 words of scratch an epilogue of these shapes needs (0: none).
long long psa_epilogue_scratch_words(int b, int np, int k) {
  const long long nblk = blocks_per_row(np);
  if (nblk <= 1) return 0;
  return static_cast<long long>(b) * (nblk * (2LL * k + 2) + 1 + np);
}

// (B, 6k+2) int32 pack of B stats5 rows on `stream` (see the note at the
// head of the file); returns cudaGetLastError().
int psa_epilogue_launch(const void* stats, long long sb, long long sr, int b, int np,
                        const void* w32, const void* diff32, int n_diff, const void* noffs,
                        int noff, float eps, int is_max, int g0, int k, void* out,
                        void* scratch, long long scratch_words, void* stream) {
  if (b < 1 || b > 65535 || k < 1 || k > kMaxK || np < k || n_diff < 1 ||
      scratch_words < psa_epilogue_scratch_words(b, np, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.stats = static_cast<const int32_t*>(stats);
  a.sb = sb;
  a.sr = sr;
  a.b = b;
  a.np = np;
  a.k = k;
  a.nblk = blocks_per_row(np);
  a.w32 = static_cast<const float*>(w32);
  a.diff32 = static_cast<const float*>(diff32);
  a.n_diff = n_diff;
  a.noffs = static_cast<const int32_t*>(noffs);
  a.noff = noff;
  a.eps = eps;
  a.is_max = is_max;
  a.g0 = g0;
  a.out = static_cast<int32_t*>(out);
  a.cand_key = a.blk_max = a.keys = nullptr;
  a.cand_idx = a.near_part = nullptr;
  a.ticket = nullptr;
  if (a.nblk > 1) {  // carve the scratch: see psa_epilogue_scratch_words
    const long long rows = static_cast<long long>(b) * a.nblk;
    uint32_t* w = static_cast<uint32_t*>(scratch);
    a.cand_key = w;
    a.cand_idx = reinterpret_cast<int32_t*>(w + rows * k);
    a.blk_max = w + 2 * rows * k;
    a.near_part = reinterpret_cast<int32_t*>(a.blk_max + rows);
    a.ticket = reinterpret_cast<unsigned*>(a.near_part + rows);
    a.keys = reinterpret_cast<uint32_t*>(a.ticket + b);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.nblk, b);
  epilogue_keys_kernel<<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nblk == 1) return static_cast<int>(err);
  epilogue_merge_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
