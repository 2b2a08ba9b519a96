// Offset sweep on Hopper (sm_90a): per-offset sign-class counts and the
// largest fused code, for one query.
//
// Replaces psa_tpu/ops/pallas_sweep.py::_sweep_kernel (launched by
// _sweep_pallas) and, at B=1, what _sweep_kernel_batched does for a Seq1
// beyond the TPU's VMEM budget: codes are read from device memory here, so
// Seq1 length has no on-chip cap.
//
// Contract (the same layout as the TPU kernel):
//   in   c1   (l1,)  uint8 Seq1 codes, PAD_CODE (28) past the sequence
//        c2   (l2p,) uint8 Seq2 codes, PAD_CODE past the sequence
//        code (32, 32) int8 fused table, code[c1][c2]: 0 = inert, else
//             1 + cls + 4 * (rank + 1), at most 126
//   out  (8, noff_pad) int32.  For offset o, over i < l2p with
//        v = code[c1[o + i]][c2[i]]: rows 0-3 count the i with v > 0 and
//        (v - 1) & 3 == k, row 4 is max(v) (0 if none), rows 5-7 are 0.
// Every value is an exact integer, so the order of summation (and of the
// atomics below) cannot change a bit of the result.
//
// What bounds it on this card: per (offset, position) pair the work is one
// shared-memory table read and a few integer operations, while each code
// byte read from device memory serves a whole tile of offsets — so the
// INT32 instruction rate and the shared-memory request rate bound it, not HBM.
// The design keeps the per-pair work at one 32-bit shared load and three
// integer ops (address, add, max):
//   * the table is expanded per block into 32-bit entries
//       e = (v << 24) | (1 << (6 * ((v - 1) & 3)))   (0 for v == 0)
//     so one add accumulates the class count in a 6-bit field and one
//     unsigned max tracks max(v) in the top byte; the fields are drained
//     into plain counters every kFlush (< 64) positions;
//   * the expanded table is stored transposed, tab[c2][c1]: a warp reads
//     one Seq2 position against 32 Seq1 codes, i.e. words of one 32-word
//     row, which are 32 distinct banks (indexed [c1][c2] they would all
//     fall into one bank);
//   * each thread owns kOffsetsPerThread consecutive offsets and slides a
//     register window along Seq1, so Seq1 costs one shared load per
//     kOffsetsPerThread pairs;
//   * Seq2 is split across grid.y so that a 100k-offset query still fills
//     the 132 SMs; the partial results meet in atomics on `out`, which the
//     entry point zeroes first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kOffsetsPerThread = 8;
constexpr int kTile = kThreads * kOffsetsPerThread;   // offsets per block
constexpr int kSeg = 1024;                            // Seq2 positions per block
constexpr int kFlush = 32;                            // 6-bit fields hold 63
constexpr uint8_t kPadCode = 28;

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint8_t* __restrict__ c1, int l1,
             const uint8_t* __restrict__ c2, int l2p,
             const int8_t* __restrict__ code,
             int32_t* __restrict__ out, int noff_pad) {
  __shared__ uint32_t tab[32 * 32];          // tab[c2 * 32 + c1]
  __shared__ uint8_t s1[kTile + kSeg];
  __shared__ uint8_t s2[kSeg];

  const int t = threadIdx.x;
  const int o0 = blockIdx.x * kTile;
  const int p0 = blockIdx.y * kSeg;
  const int seg = min(kSeg, l2p - p0);       // a multiple of kFlush

  for (int e = t; e < 32 * 32; e += kThreads) {
    const int a = e & 31;                    // Seq1 code
    const int b = e >> 5;                    // Seq2 code
    const uint32_t v = static_cast<uint8_t>(code[a * 32 + b]);
    tab[e] = v ? ((v << 24) | (1u << (6 * ((v - 1) & 3)))) : 0u;
  }
  // Codes are masked to the table's 32 rows: a stray byte can never read
  // outside it.
  for (int i = t; i < kTile + seg; i += kThreads) {
    const long g = static_cast<long>(o0) + p0 + i;
    s1[i] = (g < l1 ? c1[g] : kPadCode) & 31;
  }
  for (int i = t; i < seg; i += kThreads) s2[i] = c2[p0 + i] & 31;
  __syncthreads();

  const int base = t * kOffsetsPerThread;
  uint32_t w[kOffsetsPerThread];             // w[j] = s1[base + i + j]
  uint32_t mx[kOffsetsPerThread];
  int cnt[kOffsetsPerThread][4];
#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) {
    w[j] = s1[base + j];
    mx[j] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) cnt[j][k] = 0;
  }

  for (int i0 = 0; i0 < seg; i0 += kFlush) {
    uint32_t acc[kOffsetsPerThread];
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) acc[j] = 0;
#pragma unroll
    for (int ii = 0; ii < kFlush; ++ii) {
      const uint32_t* row = tab + (static_cast<uint32_t>(s2[i0 + ii]) << 5);
#pragma unroll
      for (int j = 0; j < kOffsetsPerThread; ++j) {
        const uint32_t e = row[w[j]];
        acc[j] += e;
        mx[j] = max(mx[j], e);
      }
#pragma unroll
      for (int j = 0; j + 1 < kOffsetsPerThread; ++j) w[j] = w[j + 1];
      // the last index read is base + seg - 1 + kOffsetsPerThread
      // <= kTile + seg - 1, inside s1
      w[kOffsetsPerThread - 1] = s1[base + i0 + ii + kOffsetsPerThread];
    }
#pragma unroll
    for (int j = 0; j < kOffsetsPerThread; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt[j][k] += (acc[j] >> (6 * k)) & 63;
    }
  }

#pragma unroll
  for (int j = 0; j < kOffsetsPerThread; ++j) {
    const int o = o0 + base + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cnt[j][k]) atomicAdd(out + static_cast<long>(k) * noff_pad + o, cnt[j][k]);
    }
    if (mx[j]) atomicMax(out + 4L * noff_pad + o, static_cast<int>(mx[j] >> 24));
  }
}

}  // namespace

extern "C" {

int psa_sweep_tile() { return kTile; }

int psa_sweep_align() { return kFlush; }

const char* psa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Zeroes `out` and launches the sweep on `stream`; returns cudaGetLastError().
// noff_pad must be a multiple of kTile and l2p a multiple of kFlush.
int psa_sweep_launch(const void* c1, int l1, const void* c2, int l2p,
                     const void* code, void* out, int noff_pad, void* stream) {
  if (noff_pad <= 0 || noff_pad % kTile != 0 || l2p <= 0 || l2p % kFlush != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * 8 * static_cast<size_t>(noff_pad), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(noff_pad / kTile, (l2p + kSeg - 1) / kSeg);
  sweep_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(c1), l1, static_cast<const uint8_t*>(c2), l2p,
      static_cast<const int8_t*>(code), static_cast<int32_t*>(out), noff_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
