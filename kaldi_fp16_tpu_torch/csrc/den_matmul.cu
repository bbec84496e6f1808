// out = (M^T if transpose else M) @ v for the structured denominator's
// constant phone-LM residual matrix M [F, F] fp32 and v [F, n] fp32.
//
// Replaces the TPU kernel kaldi_fp16_tpu/ops/pallas_den_matmul.py
// (`_split3_kernel` through `_apply_padded` / `PallasDenMatmul.apply`),
// which read each fp32 M tile once and rebuilt fp32-class accuracy from a
// 3-term bf16 split with six MXU dots.  This card has fp32 FFMA units, so
// the first port computes in fp32 directly: no split, no tensor cores.
//
// Design (simple and right first): one block owns one BM x BN output
// tile and runs the whole K loop itself through den_tile.cuh's tile loop
// (fp32 FFMA, blocked BK-deep partial sums, M^T read by strides, ragged
// edges zero-filled and masked): no split-K, no atomics, so repeated calls
// are bit-identical.
//
// What bounds it on an H100 SXM (data sheet): at F = 3526, n = 128 an
// application is 3.2 GFLOP of fp32 FMA (67 TFLOP/s peak: >= 47 us) and
// reads the 49.7 MB matrix (3.35 TB/s: >= 15 us; it about fills the 50 MB
// L2).  So it is bound by fp32 arithmetic, and this kernel's shared-memory
// traffic (one LDS per two FMAs) caps it at about half of that peak.
// PERF.md holds its measured time beside torch.matmul's.

#include <cuda_runtime.h>

#include "den_tile.cuh"

namespace {

using namespace den_tile;

struct LoadV {                         // B(k, j) = v[k, j]
  const float* __restrict__ v;
  int n;
  __device__ float operator()(int k, int j) const {
    return v[(size_t)k * n + j];
  }
};

template <bool TRANS>
__global__ void __launch_bounds__(NT)
den_matmul_kernel(const float* __restrict__ M, const float* __restrict__ v,
                  float* __restrict__ out, int F, int n) {
  __shared__ Smem s;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN];
  mm_tile<TRANS>(M, F, n, row0, col0, s, LoadV{v, n}, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty + i * TY;
    if (gi >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + tx + j * TX;
      if (gj < n) out[(size_t)gi * n + gj] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// All pointers are device pointers to contiguous fp32 arrays: M [F, F],
// v [F, n], out [F, n].  Launches on `stream` and does not synchronise;
// returns the launch status.
extern "C" cudaError_t den_matmul(const float* M, const float* v, float* out,
                                  int F, int n, int transpose,
                                  cudaStream_t stream) {
  if (F <= 0 || n <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (F + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  if (transpose)
    den_matmul_kernel<true><<<grid, NT, 0, stream>>>(M, v, out, F, n);
  else
    den_matmul_kernel<false><<<grid, NT, 0, stream>>>(M, v, out, F, n);
  return cudaGetLastError();
}
