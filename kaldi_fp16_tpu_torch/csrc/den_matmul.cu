// out = (M^T if transpose else M) @ v for the structured denominator's
// constant phone-LM residual matrix M [F, F] fp32 and v [F, n] fp32.
//
// Replaces the TPU kernels kaldi_fp16_tpu/ops/pallas_den_matmul.py
// (`_split3_kernel` through `_apply_padded` / `PallasDenMatmul.apply`)
// and _probe_pallas_den.py (`make_msplit` / `kernel_msplit`,
// `make_mpre` / `kernel_mpre`).  Those read each M tile once and rebuilt
// fp32-class accuracy from a 3-term bf16 split with three or six MXU
// dots, splitting M in-kernel (msplit, the package's kernel) or streaming
// M pre-split into three bf16 planes (mpre).  This port keeps that
// arithmetic on Hopper's tensor cores through den_mma.cuh:
//
//   split = "kernel" (pre = 0)  A is the zero-padded fp32 M [Fp, Fp]; each
//                               thread splits its fragments in registers;
//   split = "pre"    (pre = 1)  A is M split once into bf16 planes
//                               [3, Fp, Fp] (den_split.cu).
//
// One application is three launches: den_split_v splits v into the bf16
// panels, the product runs over (Fp/128) x (np/128) tiles and S K slices
// (S picked to cover the SMs), and a reduce adds the S slice partials in
// order into the masked [F, n] result.
//
// What bounds it on an H100 SXM (data sheet): at F = 3526, n = 128 the six
// bf16 products are 6 * 2 * 3526^2 * 128 = 19.1 GFLOP (989 TFLOP/s dense:
// >= 19.3 us); reading M once is 49.7 MB fp32 (3.35 TB/s: >= 14.8 us) or
// 74.6 MB of planes for split="pre" (>= 22.3 us).  So split="kernel" is
// bound by the tensor cores, split="pre" by memory.  PERF.md holds the
// measured times beside torch.matmul's.

#include <cuda_runtime.h>

#include "den_mma.cuh"

extern "C" cudaError_t den_split_v(const float* v, den_mma::bf16* panels,
                                   int F, int n, int Fp, cudaStream_t stream);

namespace {

using namespace den_mma;

template <bool TRANS, bool PRE, int TERMS>
__global__ void __launch_bounds__(NT, 1) den_matmul_kernel(Operands op) {
  product_block<TRANS, PRE, TERMS>(op);
}

// out[r, c] = sum over the slices of ws[s, r, c], r < F, c < n.
__global__ void reduce_out_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int F, int Fp,
                                  int n, int np, int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(idx / n), c = (int)(idx % n);
  if (r >= F) return;
  out[idx] = slice_sum(ws, S, (size_t)Fp * np, (size_t)r * np + c);
}

template <bool TRANS, bool PRE, int TERMS>
cudaError_t launch(const Operands& op, dim3 grid, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TRANS, PRE>();
  auto kernel = den_matmul_kernel<TRANS, PRE, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(op);
  return cudaGetLastError();
}

template <bool TRANS, bool PRE>
cudaError_t launch_terms(int terms, const Operands& op, dim3 grid,
                         cudaStream_t stream) {
  return terms == 3 ? launch<TRANS, PRE, 3>(op, grid, stream)
                    : launch<TRANS, PRE, 6>(op, grid, stream);
}

}  // namespace

// K slices the product uses for an [Fp, np] output on the current device;
// the workspace holds slices * Fp * np floats.
extern "C" int den_mma_slices(int Fp, int np) {
  return choose_slices(Fp, np);
}

// Plain C entry point, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// Device pointers: A = fp32 M [Fp, Fp] (pre = 0) or bf16 planes [3, Fp, Fp]
// (pre = 1), zero beyond F; v [F, n] and out [F, n] fp32; scratch: panels
// [np * Fp * 3] bf16 and ws [slices * Fp * np] fp32, np = n rounded up to
// 128, slices from den_mma_slices.  Launches on `stream` and does not
// synchronise; returns the first launch status.
extern "C" cudaError_t den_matmul(const void* A, int pre, const float* v,
                                  float* out, bf16* panels, float* ws, int F,
                                  int Fp, int n, int slices, int transpose,
                                  int terms, cudaStream_t stream) {
  if (F <= 0 || n <= 0 || Fp < F || Fp % BM || slices < 1 ||
      slices > Fp / BK || (terms != 3 && terms != 6))
    return cudaErrorInvalidValue;
  cudaError_t err = den_split_v(v, panels, F, n, Fp, stream);
  if (err != cudaSuccess) return err;
  const int np = (n + BN - 1) / BN * BN;
  const Operands op{A, panels, ws, Fp, slices};
  const dim3 grid(Fp / BM, np / BN, slices);
  if (transpose)
    err = pre ? launch_terms<true, true>(terms, op, grid, stream)
              : launch_terms<true, false>(terms, op, grid, stream);
  else
    err = pre ? launch_terms<false, true>(terms, op, grid, stream)
              : launch_terms<false, false>(terms, op, grid, stream);
  if (err != cudaSuccess) return err;
  const long long count = (long long)F * n;
  reduce_out_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      ws, out, F, Fp, n, np, slices);
  return cudaGetLastError();
}
