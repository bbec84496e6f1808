// The structured denominator's alpha and beta recursions over T frames,
// each frame's dense phone-LM product fused with the elementwise update
// that follows it.
//
// Replaces the TPU kernels kaldi_fp16_tpu/ops/pallas_den_scan.py
// `fused_forward` / `_fwd_kernel` (alpha) and `fused_backward` /
// `_bwd_kernel` (beta).  Those kept the [L, Fp, N] probability state in
// VMEM across a sequential (T, K) grid, streamed M in row tiles once per
// frame, and rebuilt fp32-class accuracy from a 3-term bf16 split with
// six MXU dots.
//
// Design (simple and right first):
//   * The state is [L, Fp, N] fp32, 3.7 MB at production scale (L = 2,
//     Fp = 3584, N = 128): more than one SM holds, and CUDA blocks run in
//     no order.  So each frame is ONE launch over the whole state, and a
//     C loop over T enqueues the T frame launches on the caller's stream
//     (one ctypes call per scan, no Python per frame).  Stream order is
//     the frame barrier.
//   * Read/write hazard: every block reads the whole chain-end row of the
//     previous frame's state for its M product while other blocks write
//     this frame's rows.  The state is ping-ponged between two buffers,
//     and the product's operand (adash[L-1] forward, xs_res * beta[0]
//     backward) is formed on the fly while the tile loader reads the
//     previous frame's buffer.
//   * The normaliser (alpha sum forward, leaky * <beta', init> backward)
//     is a sum over all Fp rows.  Each block writes its per-column partial
//     sums to a [row-blocks, N] buffer (also ping-ponged); at the start of
//     the next frame every block reduces that buffer for its columns in
//     the same fixed order.  No float atomics: repeats are bit-identical.
//   * The product is fp32 FFMA through den_tile.cuh (den_matmul.cu's tile
//     loop and blocked partial sums), reading M^T (forward) or M
//     (backward) by strides from the one stored M; the tile's registers
//     then feed the elementwise update directly, so f / h never touch
//     device memory.
//   * The lazy normalisation of the TPU kernel is kept: the state holds
//     the unscaled next-frame values, and adash = nxt + a * leaky * init
//     (or beta = bd + tot) is formed where it is read.  The histories and
//     per-frame stats follow den_structured.py's conventions: adash_hist[t]
//     and asum[t] are the state entering frame t, beta_hist[t] is beta at
//     frame t + 1.
//
// What bounds it on an H100 SXM (data sheet): a frame is 2 * Fp^2 * N =
// 3.3 GFLOP of fp32 FMA (67 TFLOP/s: >= 49 us) and reads the 51 MB M
// (3.35 TB/s: >= 15 us; M about fills the 50 MB L2), plus (3L + 1) * Fp * N
// * 4 B = 12.8 MB of state, emissions and history.  So each frame is bound
// by fp32 arithmetic, and this tile loop (one shared-memory load per two
// FMAs, 112 blocks on 132 SMs) holds it to about a fifth of that peak, as
// den_matmul does.  The T launches per scan cost a few microseconds each
// on the stream, not host time per frame.  PERF.md holds the measured
// times beside the plain PyTorch versions'.

#include <cuda_runtime.h>

#include "den_tile.cuh"

namespace {

using namespace den_tile;

// Per-column sums of the block's BM rows: psum[j] is this thread's partial
// for column col0 + tx + j*TX; the TY threads of a column are added in
// order of ty and the result is written to row_out[col].
__device__ __forceinline__ void block_col_sums(const float (&psum)[TN],
                                               float (&red)[TY][BN],
                                               float* __restrict__ row_out,
                                               int col0, int N) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * TX] = psum[j];
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && col0 + c < N) {
    float s = 0.f;
    for (int y = 0; y < TY; ++y) s += red[y][c];
    row_out[col0 + c] = s;
  }
}

// norm[c] = scale * sum_rb parts[rb, col0 + c], in order of rb.
__device__ __forceinline__ void reduce_parts(const float* __restrict__ parts,
                                             int RB, int N, int col0,
                                             float scale, float* norm) {
  const int c = threadIdx.x;
  if (c < BN) {
    float s = 0.f;
    if (col0 + c < N)
      for (int rb = 0; rb < RB; ++rb) s += parts[(size_t)rb * N + col0 + c];
    norm[c] = scale * s;
  }
  __syncthreads();
}

// ---- forward (alpha) ------------------------------------------------------

struct LoadAdashEnd {  // B(k, j) = adash[L-1, k, j], formed from the state
  const float* __restrict__ st_end;     // state_in[L-1]  [F, N]
  const float* __restrict__ init_end;   // init[L-1]      [F]
  const float* a;                       // shared, a[j - col0]
  float leaky;
  int N, col0;
  __device__ float operator()(int k, int j) const {
    return st_end[(size_t)k * N + j] + a[j - col0] * leaky * init_end[k];
  }
};

// State entering frame 0: nxt = init (broadcast over N), partial sums of it.
__global__ void __launch_bounds__(NT)
fwd_init_kernel(const float* __restrict__ init, float* __restrict__ st,
                float* __restrict__ parts, int L, int F, int N) {
  __shared__ float red[TY][BN];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float psum[TN] = {};
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= N) continue;
      for (int l = 0; l < L; ++l) {
        const float v = init[(size_t)l * F + r];
        st[((size_t)l * F + r) * N + c] = v;
        psum[j] += v;
      }
    }
  }
  block_col_sums(psum, red, parts + (size_t)blockIdx.y * N, col0, N);
}

// One alpha frame: a = sum of the previous state; adash = st_in + a*leaky*init
// (written to hist); f = M^T @ adash[L-1];
// st_out[l] = (adash[l]*xs_self[l] + adash[l-1]*xs_fwd[l-1] + [l=0] f*xs_res) / a.
__global__ void __launch_bounds__(NT)
fwd_frame_kernel(const float* __restrict__ M,
                 const float* __restrict__ xs_self,   // [L, F, N]   frame t
                 const float* __restrict__ xs_fwd,    // [L-1, F, N] frame t
                 const float* __restrict__ xs_res,    // [F, N]      frame t
                 const float* __restrict__ init,      // [L, F]
                 const float* __restrict__ st_in,     // [L, F, N]
                 float* __restrict__ st_out,
                 const float* __restrict__ parts_in,  // [RB, N]
                 float* __restrict__ parts_out,
                 float* __restrict__ hist,            // [L, F, N]   frame t
                 float* __restrict__ asum,            // [N]         frame t
                 float* __restrict__ logc,            // [N]         frame t
                 int L, int F, int N, float leaky) {
  __shared__ Smem s;
  __shared__ float red[TY][BN];
  __shared__ float a[BN];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  reduce_parts(parts_in, gridDim.y, N, col0, 1.f, a);
  if (blockIdx.y == 0 && threadIdx.x < BN && col0 + threadIdx.x < N) {
    const float av = a[threadIdx.x];
    asum[col0 + threadIdx.x] = av;
    logc[col0 + threadIdx.x] = av > 0.f ? logf(av) : 0.f;
  }

  float f[TM][TN];
  mm_tile<true>(M, F, N, row0, col0, s,
                LoadAdashEnd{st_in + (size_t)(L - 1) * F * N,
                             init + (size_t)(L - 1) * F, a, leaky, N, col0},
                f);

  float psum[TN] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= N) continue;
      const float aj = a[c - col0];
      const float inv = aj > 0.f ? 1.f / aj : 1.f;
      float prev = 0.f;                                   // adash[l-1]
      for (int l = 0; l < L; ++l) {
        const size_t o = ((size_t)l * F + r) * N + c;
        const float ad = st_in[o] + aj * leaky * init[(size_t)l * F + r];
        hist[o] = ad;
        float u = ad * xs_self[o];
        if (l >= 1) u += prev * xs_fwd[((size_t)(l - 1) * F + r) * N + c];
        if (l == 0) u += f[i][j] * xs_res[(size_t)r * N + c];
        const float nv = u * inv;
        st_out[o] = nv;
        psum[j] += nv;
        prev = ad;
      }
    }
  }
  block_col_sums(psum, red, parts_out + (size_t)blockIdx.y * N, col0, N);
}

// ---- backward (beta) ------------------------------------------------------

struct LoadW {         // B(k, j) = xs_res[k, j] * beta[0, k, j]
  const float* __restrict__ xs_res;     // [F, N] frame f
  const float* __restrict__ bd0;        // state_in[0]  [F, N]
  const float* tot;                     // shared, tot[j - col0]
  int N, col0;
  __device__ float operator()(int k, int j) const {
    const size_t o = (size_t)k * N + j;
    return xs_res[o] * (bd0[o] + tot[j - col0]);
  }
};

// beta'[T] = real / total_prob (0 where total_prob <= 0); partial sums of
// beta' * init for the leaky term.
__global__ void __launch_bounds__(NT)
bwd_init_kernel(const float* __restrict__ real, const float* __restrict__ init,
                const float* __restrict__ total, float* __restrict__ st,
                float* __restrict__ parts, int L, int F, int N) {
  __shared__ float red[TY][BN];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float psum[TN] = {};
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= N) continue;
      const float tc = total[c];
      const float invt = tc > 0.f ? 1.f / tc : 0.f;
      for (int l = 0; l < L; ++l) {
        const float v = real[(size_t)l * F + r] * invt;
        st[((size_t)l * F + r) * N + c] = v;
        psum[j] += v * init[(size_t)l * F + r];
      }
    }
  }
  block_col_sums(psum, red, parts + (size_t)blockIdx.y * N, col0, N);
}

// One beta frame f: tot = leaky * sum of the partials; beta = st_in + tot
// (written to hist, = beta at f+1); h = M @ (xs_res * beta[0]);
// st_out[l] = (beta[l]*xs_self[l] + beta[l+1]*xs_fwd[l] + [l=L-1] h) / asum[f].
__global__ void __launch_bounds__(NT)
bwd_frame_kernel(const float* __restrict__ M,
                 const float* __restrict__ xs_self,   // [L, F, N]   frame f
                 const float* __restrict__ xs_fwd,    // [L-1, F, N] frame f
                 const float* __restrict__ xs_res,    // [F, N]      frame f
                 const float* __restrict__ asum,      // [N]         frame f
                 const float* __restrict__ init,      // [L, F]
                 const float* __restrict__ st_in,     // [L, F, N]
                 float* __restrict__ st_out,
                 const float* __restrict__ parts_in,  // [RB, N]
                 float* __restrict__ parts_out,
                 float* __restrict__ hist,            // [L, F, N]   frame f
                 int L, int F, int N, float leaky) {
  __shared__ Smem s;
  __shared__ float red[TY][BN];
  __shared__ float tot[BN];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  reduce_parts(parts_in, gridDim.y, N, col0, leaky, tot);

  float h[TM][TN];
  mm_tile<false>(M, F, N, row0, col0, s, LoadW{xs_res, st_in, tot, N, col0},
                 h);

  float psum[TN] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= N) continue;
      const float tj = tot[c - col0];
      const float as = asum[c];
      const float inv = as > 0.f ? 1.f / as : 0.f;
      float next = 0.f;                                   // beta[l+1]
      for (int l = L - 1; l >= 0; --l) {
        const size_t o = ((size_t)l * F + r) * N + c;
        const float bn = st_in[o] + tj;
        hist[o] = bn;
        float b = bn * xs_self[o];
        if (l < L - 1) b += next * xs_fwd[o];             // xs_fwd[l] row
        if (l == L - 1) b += h[i][j];
        b *= inv;
        st_out[o] = b;
        psum[j] += b * init[(size_t)l * F + r];
        next = bn;
      }
    }
  }
  block_col_sums(psum, red, parts_out + (size_t)blockIdx.y * N, col0, N);
}

// out[c] = sum_rb parts[rb, c], in order of rb.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, int RB, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float s = 0.f;
  for (int rb = 0; rb < RB; ++rb) s += parts[(size_t)rb * N + c];
  out[c] = s;
}

bool bad_shape(int L, int F, int N, int T) {
  return L < 1 || F <= 0 || N <= 0 || T <= 0 || (F + BM - 1) / BM > 65535;
}

}  // namespace

// Plain C entry points, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// All pointers are device pointers to contiguous fp32 arrays.  Each call
// enqueues T + 2 launches on `stream` and does not synchronise; it returns
// the first launch error, or cudaSuccess.

// Rows of M per block: the partial-sum buffers have ceil(F / this) rows.
extern "C" int den_scan_row_block() { return BM; }

// M [F, F]; xs_self [T, L, F, N], xs_fwd [T, L-1, F, N], xs_res [T, F, N];
// init [L, F]; workspace state [2, L, F, N], parts [2, RB, N];
// out: hist [T, L, F, N], asum [T, N], logc [T, N], a_final [N].
extern "C" cudaError_t den_scan_forward(
    const float* M, const float* xs_self, const float* xs_fwd,
    const float* xs_res, const float* init, float* state, float* parts,
    float* hist, float* asum, float* logc, float* a_final, int L, int F,
    int N, int T, float leaky, cudaStream_t stream) {
  if (bad_shape(L, F, N, T)) return cudaErrorInvalidValue;
  const int RB = (F + BM - 1) / BM;
  const dim3 grid((N + BN - 1) / BN, RB);
  const size_t LFN = (size_t)L * F * N, FN = (size_t)F * N;
  fwd_init_kernel<<<grid, NT, 0, stream>>>(init, state, parts, L, F, N);
  cudaError_t err = cudaGetLastError();
  for (int t = 0; t < T && err == cudaSuccess; ++t) {
    const int cur = t % 2, nxt = 1 - cur;
    fwd_frame_kernel<<<grid, NT, 0, stream>>>(
        M, xs_self + t * LFN, xs_fwd + t * (LFN - FN), xs_res + t * FN, init,
        state + cur * LFN, state + nxt * LFN, parts + (size_t)cur * RB * N,
        parts + (size_t)nxt * RB * N, hist + t * LFN, asum + (size_t)t * N,
        logc + (size_t)t * N, L, F, N, leaky);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  sum_parts_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      parts + (size_t)(T % 2) * RB * N, a_final, RB, N);
  return cudaGetLastError();
}

// M [F, F]; emissions as den_scan_forward; asum [T, N] from it; init [L, F];
// real [L, F] (1 on real slots, 0 on padding); total [N];
// workspace as den_scan_forward; out: hist [T, L, F, N].
extern "C" cudaError_t den_scan_backward(
    const float* M, const float* xs_self, const float* xs_fwd,
    const float* xs_res, const float* asum, const float* init,
    const float* real, const float* total, float* state, float* parts,
    float* hist, int L, int F, int N, int T, float leaky,
    cudaStream_t stream) {
  if (bad_shape(L, F, N, T)) return cudaErrorInvalidValue;
  const int RB = (F + BM - 1) / BM;
  const dim3 grid((N + BN - 1) / BN, RB);
  const size_t LFN = (size_t)L * F * N, FN = (size_t)F * N;
  bwd_init_kernel<<<grid, NT, 0, stream>>>(real, init, total, state, parts,
                                           L, F, N);
  cudaError_t err = cudaGetLastError();
  for (int i = 0; i < T && err == cudaSuccess; ++i) {
    const int f = T - 1 - i;
    const int cur = i % 2, nxt = 1 - cur;
    bwd_frame_kernel<<<grid, NT, 0, stream>>>(
        M, xs_self + f * LFN, xs_fwd + f * (LFN - FN), xs_res + f * FN,
        asum + (size_t)f * N, init, state + cur * LFN, state + nxt * LFN,
        parts + (size_t)cur * RB * N, parts + (size_t)nxt * RB * N,
        hist + f * LFN, L, F, N, leaky);
    err = cudaGetLastError();
  }
  return err;
}
