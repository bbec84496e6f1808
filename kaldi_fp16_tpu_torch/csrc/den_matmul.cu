// out = (M^T if transpose else M) @ v for the structured denominator's
// constant phone-LM residual matrix M [F, F] fp32 and v [F, n] fp32.
//
// Replaces the TPU kernel kaldi_fp16_tpu/ops/pallas_den_matmul.py
// (`_split3_kernel` through `_apply_padded` / `PallasDenMatmul.apply`),
// which read each fp32 M tile once and rebuilt fp32-class accuracy from a
// 3-term bf16 split with six MXU dots.  This card has fp32 FFMA units, so
// the first port computes in fp32 directly: no split, no tensor cores.
//
// Design (simple and right first):
//   * one block owns one BM x BN output tile and runs the whole K loop
//     itself: no split-K, no atomics, so repeated calls are bit-identical;
//   * M and v tiles go through shared memory BK rows deep; every thread
//     keeps a TM x TN register tile of the output (strided by the thread
//     grid, so shared-memory reads are conflict-free and stores coalesce);
//   * summation is blocked: each BK-deep stage sums into a fresh partial
//     that is then added to the accumulator, so the rounding error grows
//     with BK + F/BK instead of F (the fp64 bar is 3e-6 relative);
//   * M^T is read by strides, not from a transposed copy: the tile loader
//     maps consecutive threads onto whichever index is contiguous in
//     memory, so both orientations load coalesced and M is stored once;
//   * F and n need not be multiples of anything: the loaders zero-fill
//     and the store masks the ragged edges.
//
// What bounds it on an H100 SXM (data sheet): at F = 3526, n = 128 an
// application is 3.2 GFLOP of fp32 FMA (67 TFLOP/s peak: >= 47 us) and
// reads the 49.7 MB matrix (3.35 TB/s: >= 15 us; it about fills the 50 MB
// L2).  So it is bound by fp32 arithmetic, and this kernel's shared-memory
// traffic (one LDS per two FMAs) caps it at about half of that peak.
// PERF.md holds its measured time beside torch.matmul's.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                 // output rows per block
constexpr int BN = 64;                 // output columns per block
constexpr int BK = 32;                 // depth of one shared-memory stage
constexpr int TM = 4;                  // output rows per thread
constexpr int TN = 4;                  // output columns per thread
constexpr int TX = BN / TN;            // threads along the columns (16)
constexpr int TY = BM / TM;            // threads along the rows (16)
constexpr int NT = TX * TY;            // threads per block (256)
static_assert(BM * BK % NT == 0 && BK * BN % NT == 0,
              "tile loads must divide evenly over the block");

template <bool TRANS>
__global__ void __launch_bounds__(NT)
den_matmul_kernel(const float* __restrict__ M, const float* __restrict__ v,
                  float* __restrict__ out, int F, int n) {
  // As[k][i] = A(row0 + i, k0 + k) with A = M or M^T; the +1 keeps the
  // transposing store of the row-major load free of bank conflicts.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * BK / NT; ++it) {
      const int idx = tid + it * NT;
      // consecutive threads walk the index that is contiguous in memory
      const int r = TRANS ? idx % BM : idx / BK;
      const int c = TRANS ? idx / BM : idx % BK;
      const int gi = row0 + r;
      const int gk = k0 + c;
      float a = 0.f;
      if (gi < F && gk < F)
        a = TRANS ? M[(size_t)gk * F + gi] : M[(size_t)gi * F + gk];
      As[c][r] = a;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / NT; ++it) {
      const int idx = tid + it * NT;
      const int c = idx / BN;
      const int j = idx % BN;
      const int gk = k0 + c;
      const int gj = col0 + j;
      Bs[c][j] = (gk < F && gj < n) ? v[(size_t)gk * n + gj] : 0.f;
    }
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

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
