// The 3-term bf16 split of the den product's operands (den_mma.cuh).
//
// Replaces the split steps of the TPU kernels
// kaldi_fp16_tpu/ops/pallas_den_matmul.py `_split3_kernel` and
// _probe_pallas_den.py `kernel_mpre` / `kernel_msplit`, which split v once,
// at grid step 0, into VMEM scratch, and (`make_mpre`) split M once on the
// host into three bf16 planes.
//
//   den_split_v       v [F, n] fp32 -> the panel layout of the product's B
//                     operand, [ceil(n/128)][Fp/8][3][16][8][8] bf16, zero
//                     beyond F and n.  One thread per (8 rows of K, column):
//                     coalesced reads along the columns, one 16-byte store
//                     per plane.  Launched once per application, before the
//                     product (den_matmul.cu).
//   den_split_planes  M [F, F] fp32 -> planes [3, Fp, Fp] bf16, zero beyond
//                     F: the A operand of split="pre", made once per matrix.
//
// Bound (H100 SXM data sheet, 3.35 TB/s): the v split at F = 3526, n = 128
// reads 1.8 MB and writes 2.75 MB, >= 1.4 us; it is memory-bound and tiny
// next to the product.

#include <cuda_runtime.h>

#include "den_mma.cuh"

namespace {

using namespace den_mma;

__global__ void split_v_kernel(const float* __restrict__ v,
                               bf16* __restrict__ panels, int F, int n,
                               int KB, int np) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)KB * np) return;
  const int col = (int)(idx % np), kb = (int)(idx / np);
  float x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = kb * 8 + j;
    x[j] = (k < F && col < n) ? v[(size_t)k * n + col] : 0.f;
  }
  store_split8(panels, kb, col, KB, x);
}

__global__ void split_planes_kernel(const float* __restrict__ M,
                                    bf16* __restrict__ planes, int F, int Fp) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long count = (long long)Fp * Fp;
  if (idx >= count) return;
  const int r = (int)(idx / Fp), c = (int)(idx % Fp);
  const float x = (r < F && c < F) ? M[(size_t)r * F + c] : 0.f;
  const bf16 h0 = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(h0);
  const bf16 h1 = __float2bfloat16_rn(rest);
  planes[idx] = h0;
  planes[count + idx] = h1;
  planes[2 * count + idx] = __float2bfloat16_rn(rest - __bfloat162float(h1));
}

}  // namespace

// Plain C entry points, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// Device pointers; launch on `stream`, no synchronisation; return the
// launch status.  Fp must be a multiple of 128.

// v [F, n] fp32 -> panels [ceil(n/128) * Fp * 3 * 128] bf16.
extern "C" cudaError_t den_split_v(const float* v, bf16* panels, int F, int n,
                                   int Fp, cudaStream_t stream) {
  if (F <= 0 || n <= 0 || Fp < F || Fp % BM) return cudaErrorInvalidValue;
  const int np = (n + BN - 1) / BN * BN, KB = Fp / 8;
  const long long threads = (long long)KB * np;
  split_v_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      v, panels, F, n, KB, np);
  return cudaGetLastError();
}

// M [F, F] fp32 -> planes [3, Fp, Fp] bf16.
extern "C" cudaError_t den_split_planes(const float* M, bf16* planes, int F,
                                        int Fp, cudaStream_t stream) {
  if (F <= 0 || Fp < F || Fp % BM) return cudaErrorInvalidValue;
  const long long count = (long long)Fp * Fp;
  split_planes_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      M, planes, F, Fp);
  return cudaGetLastError();
}
