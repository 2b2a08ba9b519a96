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
// The per-pair design (expanded table, transposed for banks, register window
// along Seq1) is in sweep_core.cuh, shared with the batched kernels.  Here,
// Seq2 is split across grid.y so that a 100k-offset query still fills the
// 132 SMs; the partial results meet in atomics on `out`, which the entry
// point zeroes first.

#include "sweep_core.cuh"

using namespace psa;

namespace {

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint8_t* __restrict__ c1, int l1,
             const uint8_t* __restrict__ c2, int l2p,
             const int8_t* __restrict__ code,
             int32_t* __restrict__ out, int noff_pad) {
  __shared__ uint32_t tab[32 * 32];          // tab[c2 * 32 + c1]
  __shared__ uint8_t s1[kTile + kSeg];
  __shared__ uint8_t s2[kSeg];

  const int o0 = blockIdx.x * kTile;
  const int p0 = blockIdx.y * kSeg;
  const int seg = min(kSeg, l2p - p0);       // a multiple of kFlush

  expand_table(tab, code);
  stage_codes(s1, c1, l1, static_cast<long>(o0) + p0, kTile + seg);
  stage_codes(s2, c2, l2p, p0, seg);
  __syncthreads();
  sweep_tile(tab, s1, s2, seg, out, noff_pad, o0);
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
