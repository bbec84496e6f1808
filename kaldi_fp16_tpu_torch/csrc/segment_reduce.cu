// Blocked segment sum: out[b, s, c] = sum over k with labels[b, k] == s of
// vals[b, k, c], for vals [NB, K, n] fp32 and labels [NB, K] int32; a label
// outside [0, sb) marks a padding slot and contributes nothing.
//
// Replaces the TPU kernel kaldi_fp16_tpu/ops/pallas_reduce.py
// (`blocked_segment_reduce` / `_reduce_kernel`), which built one-hot rows
// from the labels in VMEM and fed the MXU twice (a hi/lo bf16 split of the
// values) to reach fp32-class sums.  The blocked denominator's bulk
// posterior pass calls it once per chunk of frames (`posterior_reduce=
// "kernel"`), to reduce per-arc occupation values into per-pdf sums.
//
// Design (simple and right first): the labels are constants of the graph.
// One block per (b, tile of CT columns), one thread per column, and a
// shared-memory accumulator [sb, CT].  Each thread walks k = 0..K-1 in
// order and adds vals[b, k, c] into row labels[b, k] of its own column:
// O(K * n) work, no races and no atomics (a thread touches only its own
// column), so the result is deterministic, and plain fp32 sums are at least
// as accurate as the TPU's hi/lo split.  Consecutive threads read
// consecutive columns, so the value loads coalesce; every thread of a block
// reads the same label, which the cache broadcasts.
//
// What bounds it on an H100 SXM (data sheet): at the production pdf order
// (NB = 25, K = 6144, n = Tc * N = 384) a call reads 236 MB of values
// (3.35 TB/s: >= 70 us) for 59 M adds, so it should be bound by memory
// bandwidth.  This first version is not: its grid is 25 x 6 blocks of two
// warps, about one block per SM, and each thread's loop is a chain of
// loads and shared-memory adds, so it is bound by latency.  Slicing K over
// more blocks with a fixed-order second pass is the first fix.  PERF.md
// holds its measured time beside the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int CT = 64;   // columns (threads) per block
constexpr int U = 8;     // loads in flight per thread

__global__ void __launch_bounds__(CT)
segment_reduce_kernel(const float* __restrict__ vals,
                      const int* __restrict__ labels, float* __restrict__ out,
                      int K, int n, int sb) {
  extern __shared__ float acc[];                 // [sb][CT]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * CT + tid;
  if (c >= n) return;                            // no block-wide sync below
  for (int s = 0; s < sb; ++s) acc[s * CT + tid] = 0.f;
  const int* lab = labels + (size_t)b * K;
  const float* v = vals + (size_t)b * K * n + c;
  int k = 0;
  for (; k + U <= K; k += U) {
    int s[U];
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = lab[k + u];
      x[u] = v[(size_t)(k + u) * n];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if ((unsigned)s[u] < (unsigned)sb) acc[s[u] * CT + tid] += x[u];
  }
  for (; k < K; ++k) {
    const int s = lab[k];
    if ((unsigned)s < (unsigned)sb) acc[s * CT + tid] += v[(size_t)k * n];
  }
  float* o = out + (size_t)b * sb * n + c;
  for (int s = 0; s < sb; ++s) o[(size_t)s * n] = acc[s * CT + tid];
}

}  // namespace

// Plain C entry point, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// Device pointers: vals [NB, K, n] fp32, labels [NB, K] int32, out
// [NB, sb, n] fp32, all contiguous.  Launches on `stream` and does not
// synchronise; returns the launch status.
extern "C" cudaError_t segment_reduce(const float* vals, const int* labels,
                                      float* out, int NB, int K, int n, int sb,
                                      cudaStream_t stream) {
  if (NB <= 0 || K < 0 || n <= 0 || sb <= 0 || NB > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)sb * CT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + CT - 1) / CT, NB);
  segment_reduce_kernel<<<grid, CT, smem, stream>>>(vals, labels, out, K, n,
                                                    sb);
  return cudaGetLastError();
}
