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
// Design:
//   * The state is [L, Fp, N] fp32, 3.7 MB at production scale (L = 2,
//     Fp = 3584, N = 128): more than one SM holds, and CUDA blocks run in
//     no order.  So each frame runs as launches over the whole state, and a
//     C loop over T enqueues them on the caller's stream (one ctypes call per
//     scan, no Python per frame).  Stream order is the frame barrier.
//   * Each frame is three launches.  The operand launch forms the product's
//     operand once -- adash[L-1] = nxt[L-1] + a * leaky * init[L-1]
//     forward, xs_res * (bd[0] + tot) backward -- from the fixed-order
//     normaliser partials, and writes its three bf16 planes (one, on the
//     one-plane route) in the product's panel layout (den_mma.cuh); it
//     also writes the frame's normaliser (asum and logc forward, tot
//     backward).  The product is den_mma.cuh's tensor-core tile (M^T
//     forward, M backward, TERMS = 6, 3 or 1 bf16 cross products in fp32
//     -- the TPU kernels' `terms`: 6 in the exact den, 1 in the fast den
//     -- split="kernel" or "pre" as den_matmul.cu, or at TERMS = 1 the
//     one-plane route, below), K split over the SMs into slice partials.
//     The update launch, one
//     thread per (chain, column) over the whole card, adds the slices in
//     order and applies the elementwise update.  (Run by the product's own
//     last block per tile instead, the update sat on 28 SMs and was
//     latency-bound.)
//   * The state is ping-ponged between two buffers (the update reads the
//     previous frame's rows and writes this frame's).
//   * The normaliser (alpha sum forward, leaky * <beta', init> backward)
//     is a sum over all Fp rows.  Each update block writes the per-column
//     sums of its CH rows to a [Fp/CH, N] buffer (ping-ponged), which the
//     next frame's operand launch reduces in chunk order.  No float
//     atomics: repeats are bit-identical.
//   * The lazy normalisation of the TPU kernel is kept: the state holds
//     the unscaled next-frame values, and adash = nxt + a * leaky * init
//     (or beta = bd + tot) is formed where it is read.  The histories and
//     per-frame stats follow den_structured.py's conventions: adash_hist[t]
//     and asum[t] are the state entering frame t, beta_hist[t] is beta at
//     frame t + 1.
//   * Launches per scan: forward 1 + 3T + 1 (init, T x (operand, product,
//     update), final sum), backward 1 + 3T.
//
// What bounds it on an H100 SXM (data sheet): at TERMS = 6 a frame is
// 6 * 2 * Fp^2 * N = 19.7 GFLOP of bf16 tensor-core products (989 TFLOP/s:
// >= 19.9 us) and reads M once (51.4 MB fp32, 3.35 TB/s: >= 15.3 us; about
// the 50 MB L2), plus (3L + 1) * Fp * N * 4 B = 12.8 MB of state, emissions
// and history (>= 3.8 us).  So a 49-frame scan is bound at ~1 ms by the
// tensor cores.  At TERMS = 1 a frame is 3.3 GFLOP (>= 3.3 us) and the
// scan is bound by its bytes, 0.169 ms with M read once as one bf16 plane.
// The three-plane routes at TERMS = 1 stream the fp32 M (51.4 MB a frame,
// more than the L2 beside the state) or three planes, and split them.
// The one-plane route (pre = 2, the fast den's) reads M's one bf16 plane,
// 25.7 MB, laid out once for wgmma (den_mma.cuh `plane_product_block`),
// and the operand's one plane, 8 KB a stage each by bulk copy, with the
// same arithmetic and so the same bits.  Once the product no longer
// splits, the gaps between the frame's three launches weigh as much as a
// launch, so each is a programmatic dependent of the one before it
// (`launch`, `wait_prior_grid`): the same order, most of the gap gone.
// Each frame still rereads the plane and writes and rereads the K-slice
// partials, which keeps the route above the bound; L2 policies that keep
// the plane (evict_last) and stream the emissions past it did not speed
// the fast den up (tools/ablate_den_scan.py), so it has none.
// PERF.md holds the measured times beside the plain PyTorch versions'.

#include <cuda_runtime.h>

#include <utility>

#include "den_mma.cuh"

namespace {

using namespace den_mma;

constexpr int CH = 16;  // rows of one normaliser chunk (one update block)
constexpr int KG = 4;   // k-groups (8 rows each) per thread of an operand launch
constexpr int RG = 8;   // row groups of an update block (CH / RG rows each)
constexpr int UT = BN * RG;  // threads of an update block

// The operand's x[0..7] = B(kb*8 + j, n) into its panels: three planes, or
// plane 0 alone (ONE).
template <bool ONE>
__device__ __forceinline__ void store_operand(bf16* __restrict__ panels,
                                              int kb, int n, int KB,
                                              const float (&x)[8]) {
  if constexpr (ONE) store_plane8(panels, kb, n, KB, x);
  else store_split8(panels, kb, n, KB, x);
}

// out[c] = sum_k parts[k, c], in order of k.
__device__ __forceinline__ float sum_parts(const float* __restrict__ parts,
                                           int NCH, int N, int c) {
  float s = 0.f;
  for (int k = 0; k < NCH; ++k) s += parts[(size_t)k * N + c];
  return s;
}

__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, int NCH, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < N) out[c] = sum_parts(parts, NCH, N, c);
}

// The update blocks' column sums: psum is this thread's sum over its rows
// of the chunk (row group g = threadIdx.x / BN: rows g, g + RG, ..); the
// groups are added in order into row_out[column].
__device__ __forceinline__ void chunk_col_sums(float psum,
                                               float* __restrict__ row_out) {
  __shared__ float red[UT];
  red[threadIdx.x] = psum;
  __syncthreads();
  if (threadIdx.x < BN) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) s += red[g * BN + threadIdx.x];
    row_out[threadIdx.x] = s;
  }
}

// ---- forward (alpha) ------------------------------------------------------

// State entering frame 0: nxt = init (broadcast over N); per-chunk column
// sums.  Grid (F / CH, N / BN), one thread per column.
__global__ void fwd_init_kernel(const float* __restrict__ init,
                                float* __restrict__ st,
                                float* __restrict__ parts, int L, int F,
                                int N) {
  const int c = blockIdx.y * BN + threadIdx.x;
  float s = 0.f;
  for (int r = blockIdx.x * CH; r < (blockIdx.x + 1) * CH; ++r)
    for (int l = 0; l < L; ++l) {
      const float v = init[(size_t)l * F + r];
      st[((size_t)l * F + r) * N + c] = v;
      s += v;
    }
  parts[(size_t)blockIdx.x * N + c] = s;
}

// a = sum of the previous state's partials (-> asum[t], logc[t]); the
// operand adash[L-1] = st_end + a * leaky * init_end, split into panels.
// Grid (F / 8 / KG, N / BN), one thread per column and KG k-groups.
template <bool ONE>
__global__ void fwd_operand_kernel(const float* __restrict__ st_end,
                                   const float* __restrict__ init_end,
                                   const float* __restrict__ parts, int NCH,
                                   float* __restrict__ asum,
                                   float* __restrict__ logc,
                                   bf16* __restrict__ panels, int F, int N,
                                   float leaky) {
  const int c = blockIdx.y * BN + threadIdx.x;
  if constexpr (ONE) wait_prior_grid();
  const float a = sum_parts(parts, NCH, N, c);
  if (blockIdx.x == 0) {
    asum[c] = a;
    logc[c] = a > 0.f ? logf(a) : 0.f;
  }
  for (int g = 0; g < KG; ++g) {
    const int kb = blockIdx.x * KG + g;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kb * 8 + j;
      x[j] = st_end[(size_t)k * N + c] + a * leaky * init_end[k];
    }
    store_operand<ONE>(panels, kb, c, F / 8, x);
  }
}

template <bool PRE, int TERMS>
__global__ void __launch_bounds__(NT, 1) fwd_product_kernel(Operands op) {
  product_block<true, PRE, TERMS>(op);
}

// One alpha frame's update, at f = (M^T @ adash[L-1])[r, c] (the sum of
// the slice partials): adash[l] = st_in[l] + a*leaky*init[l] (-> hist);
// st_out[l] = (adash[l] xs_self[l] + adash[l-1] xs_fwd[l-1]
//              + [l=0] f xs_res) / a.
// Grid (F / CH, N / BN), UT threads; PLANE: on the one-plane route.
template <bool PLANE>
__global__ void __launch_bounds__(UT) fwd_update_kernel(
    const float* __restrict__ ws, int S,
    const float* __restrict__ xs_self,   // [L, F, N]   frame t
    const float* __restrict__ xs_fwd,    // [L-1, F, N] frame t
    const float* __restrict__ xs_res,    // [F, N]      frame t
    const float* __restrict__ init,      // [L, F]
    const float* __restrict__ st_in,     // [L, F, N]
    float* __restrict__ st_out,
    float* __restrict__ hist,            // [L, F, N]   frame t
    const float* __restrict__ asum,      // [N]         frame t
    float* __restrict__ parts_out,       // [F / CH, N]
    int L, int F, int N, float leaky) {
  const int c = blockIdx.y * BN + threadIdx.x % BN;
  if constexpr (PLANE) wait_prior_grid();
  const float aj = asum[c];
  const float inv = aj > 0.f ? 1.f / aj : 1.f;
  const size_t FN = (size_t)F * N;
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < CH / RG; ++i) {
    const int r = blockIdx.x * CH + RG * i + threadIdx.x / BN;
    const size_t rc = (size_t)r * N + c;
    const float f = slice_sum(ws, S, FN, rc);
    float prev = 0.f;                                       // adash[l-1]
    for (int l = 0; l < L; ++l) {
      const size_t o = l * FN + rc;
      const float ad = st_in[o] + aj * leaky * init[(size_t)l * F + r];
      hist[o] = ad;
      float u = ad * xs_self[o];
      if (l >= 1) u += prev * xs_fwd[o - FN];
      if (l == 0) u += f * xs_res[rc];
      const float nv = u * inv;
      st_out[o] = nv;
      psum += nv;
      prev = ad;
    }
  }
  chunk_col_sums(psum, parts_out + (size_t)blockIdx.x * N + blockIdx.y * BN);
}

// ---- backward (beta) ------------------------------------------------------

// beta'[T] = real / total_prob (0 where total_prob <= 0); per-chunk column
// sums of beta' * init for the leaky term.  Grid as fwd_init_kernel.
__global__ void bwd_init_kernel(const float* __restrict__ real,
                                const float* __restrict__ init,
                                const float* __restrict__ total,
                                float* __restrict__ st,
                                float* __restrict__ parts, int L, int F,
                                int N) {
  const int c = blockIdx.y * BN + threadIdx.x;
  const float tc = total[c];
  const float invt = tc > 0.f ? 1.f / tc : 0.f;
  float s = 0.f;
  for (int r = blockIdx.x * CH; r < (blockIdx.x + 1) * CH; ++r)
    for (int l = 0; l < L; ++l) {
      const float v = real[(size_t)l * F + r] * invt;
      st[((size_t)l * F + r) * N + c] = v;
      s += v * init[(size_t)l * F + r];
    }
  parts[(size_t)blockIdx.x * N + c] = s;
}

// tot = leaky * sum of the partials (-> tot_out); the operand
// xs_res * (bd[0] + tot), split into panels.  Grid as fwd_operand_kernel.
template <bool ONE>
__global__ void bwd_operand_kernel(const float* __restrict__ xs_res,
                                   const float* __restrict__ bd0,
                                   const float* __restrict__ parts, int NCH,
                                   float* __restrict__ tot_out,
                                   bf16* __restrict__ panels, int F, int N,
                                   float leaky) {
  const int c = blockIdx.y * BN + threadIdx.x;
  if constexpr (ONE) wait_prior_grid();
  const float tot = leaky * sum_parts(parts, NCH, N, c);
  if (blockIdx.x == 0) tot_out[c] = tot;
  for (int g = 0; g < KG; ++g) {
    const int kb = blockIdx.x * KG + g;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t o = (size_t)(kb * 8 + j) * N + c;
      x[j] = xs_res[o] * (bd0[o] + tot);
    }
    store_operand<ONE>(panels, kb, c, F / 8, x);
  }
}

template <bool PRE, int TERMS>
__global__ void __launch_bounds__(NT, 1) bwd_product_kernel(Operands op) {
  product_block<false, PRE, TERMS>(op);
}

// The one-plane TERMS = 1 product, both directions: A's panels hold M^T
// (forward) or M (backward).
__global__ void __launch_bounds__(NT, 1) plane_product_kernel(Operands op) {
  plane_product_block(op);
}

// One beta frame's update, at h = (M @ (xs_res * beta[0]))[r, c]:
// beta[l] = st_in[l] + tot (-> hist, beta at f+1); st_out[l] = (beta[l]
// xs_self[l] + beta[l+1] xs_fwd[l] + [l=L-1] h) / asum[f].
// Grid (F / CH, N / BN), UT threads; PLANE: on the one-plane route.
template <bool PLANE>
__global__ void __launch_bounds__(UT) bwd_update_kernel(
    const float* __restrict__ ws, int S,
    const float* __restrict__ xs_self,   // [L, F, N]   frame f
    const float* __restrict__ xs_fwd,    // [L-1, F, N] frame f
    const float* __restrict__ asum,      // [N]         frame f
    const float* __restrict__ init,      // [L, F]
    const float* __restrict__ st_in,     // [L, F, N]
    float* __restrict__ st_out,
    float* __restrict__ hist,            // [L, F, N]   frame f
    const float* __restrict__ tot,       // [N]
    float* __restrict__ parts_out,       // [F / CH, N]
    int L, int F, int N) {
  const int c = blockIdx.y * BN + threadIdx.x % BN;
  if constexpr (PLANE) wait_prior_grid();
  const float tj = tot[c];
  const float as = asum[c];
  const float inv = as > 0.f ? 1.f / as : 0.f;
  const size_t FN = (size_t)F * N;
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < CH / RG; ++i) {
    const int r = blockIdx.x * CH + RG * i + threadIdx.x / BN;
    const size_t rc = (size_t)r * N + c;
    const float hv = slice_sum(ws, S, FN, rc);
    float next = 0.f;                                       // beta[l+1]
    for (int l = L - 1; l >= 0; --l) {
      const size_t o = l * FN + rc;
      const float bn = st_in[o] + tj;
      hist[o] = bn;
      float b = bn * xs_self[o];
      if (l < L - 1) b += next * xs_fwd[o];                 // xs_fwd[l] row
      if (l == L - 1) b += hv;
      b *= inv;
      st_out[o] = b;
      psum += b * init[(size_t)l * F + r];
      next = bn;
    }
  }
  chunk_col_sums(psum, parts_out + (size_t)blockIdx.x * N + blockIdx.y * BN);
}

bool bad_shape(int pre, int L, int F, int N, int T, int slices, int terms) {
  return L < 1 || F <= 0 || N <= 0 || T <= 0 || F % BM || N % BN ||
         slices < 1 || slices > F / BK ||
         (terms != 1 && terms != 3 && terms != 6) ||
         pre < 0 || pre > 2 || (pre == 2 && terms != 1);
}

typedef void (*Product)(Operands);

// The product kernel of a direction (TRANS: forward) for (pre, terms).
template <bool TRANS, bool PRE, int TERMS>
Product product_kernel() {
  if constexpr (TRANS) return fwd_product_kernel<PRE, TERMS>;
  else return bwd_product_kernel<PRE, TERMS>;
}

template <bool TRANS, bool PRE>
Product pick_terms(int terms) {
  if (terms == 1) return product_kernel<TRANS, PRE, 1>();
  if (terms == 3) return product_kernel<TRANS, PRE, 3>();
  return product_kernel<TRANS, PRE, 6>();
}

// A scan's route: its product kernel with the dynamic shared memory it
// needs allowed (err: that call's status), and whether it is the one-plane
// route.
struct Route {
  Product prod;
  int smem;
  bool one;
  cudaError_t err;
};

template <bool TRANS>
Route pick_route(int pre, int terms) {
  Route r;
  r.one = pre == 2;
  if (r.one) {
    r.prod = plane_product_kernel;
    r.smem = SMEM1;
  } else {
    r.prod = pre ? pick_terms<TRANS, true>(terms)
                 : pick_terms<TRANS, false>(terms);
    r.smem = pre ? smem_bytes<TRANS, true>() : smem_bytes<TRANS, false>();
  }
  r.err = cudaFuncSetAttribute(
      r.prod, cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
  return r;
}

// Launch k on `stream`; with pdl, as a programmatic dependent of the launch
// before it (the one-plane route): its blocks may start while that one
// drains and wait for it in wait_prior_grid(), so stream order holds and
// the gap between the frame's launches shrinks.
template <typename... Params, typename... Args>
cudaError_t launch(bool pdl, void (*k)(Params...), dim3 grid, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

}  // namespace

// Plain C entry points, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// All pointers are device pointers to contiguous arrays; F and N are
// multiples of 128.  A is the fp32 M [F, F] (pre = 0), its bf16 planes
// [3, F, F] (pre = 1), or at terms = 1 its one bf16 plane in the panel
// layout of den_mma.cuh's `plane_product_block` (pre = 2), of M^T for the
// forward scan and of M for the backward one.  Workspace: state
// [2, L, F, N] and parts
// [2, F/16, N] fp32, panels [3 * F * N] bf16 ([F * N] at pre = 2), ws
// [slices, F, N] fp32, slices from den_mma_slices(F, N); terms = 1, 3 or
// 6 cross products.  Each call enqueues its launches on
// `stream` and does not synchronise; it returns the first launch error,
// or cudaSuccess.

// Rows of a normaliser chunk: the partial-sum buffers have F / this rows.
extern "C" int den_scan_row_block() { return CH; }

// xs_self [T, L, F, N], xs_fwd [T, L-1, F, N], xs_res [T, F, N]; init
// [L, F]; out: hist [T, L, F, N], asum [T, N], logc [T, N], a_final [N].
extern "C" cudaError_t den_scan_forward(
    const void* A, int pre, const float* xs_self, const float* xs_fwd,
    const float* xs_res, const float* init, float* state, float* parts,
    bf16* panels, float* ws, float* hist, float* asum, float* logc,
    float* a_final, int L, int F, int N, int T, int slices, int terms,
    float leaky, cudaStream_t stream) {
  if (bad_shape(pre, L, F, N, T, slices, terms)) return cudaErrorInvalidValue;
  const int NCH = F / CH;
  const size_t LFN = (size_t)L * F * N, FN = (size_t)F * N;
  const Route r = pick_route<true>(pre, terms);
  if (r.err != cudaSuccess) return r.err;
  const auto operand_k = r.one ? fwd_operand_kernel<true>
                               : fwd_operand_kernel<false>;
  const auto update_k = r.one ? fwd_update_kernel<true>
                              : fwd_update_kernel<false>;
  const dim3 chunks(NCH, N / BN), product(F / BM, N / BN, slices);
  const dim3 operand(F / 8 / KG, N / BN);
  const Operands op{A, panels, ws, F, slices};
  fwd_init_kernel<<<chunks, BN, 0, stream>>>(init, state, parts, L, F, N);
  cudaError_t err = cudaGetLastError();
  for (int t = 0; t < T && err == cudaSuccess; ++t) {
    const int cur = t % 2, nxt = 1 - cur;
    const float* st_in = state + cur * LFN;
    err = launch(r.one, operand_k, operand, BN, 0, stream,
                 st_in + (L - 1) * FN, init + (size_t)(L - 1) * F,
                 parts + (size_t)cur * NCH * N, NCH, asum + (size_t)t * N,
                 logc + (size_t)t * N, panels, F, N, leaky);
    if (err == cudaSuccess)
      err = launch(r.one, r.prod, product, NT, r.smem, stream, op);
    if (err == cudaSuccess)
      err = launch(r.one, update_k, chunks, UT, 0, stream, ws, slices,
                   xs_self + t * LFN, xs_fwd + t * (LFN - FN),
                   xs_res + t * FN, init, st_in, state + nxt * LFN,
                   hist + t * LFN, asum + (size_t)t * N,
                   parts + (size_t)nxt * NCH * N, L, F, N, leaky);
  }
  if (err != cudaSuccess) return err;
  sum_parts_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      parts + (size_t)(T % 2) * NCH * N, a_final, NCH, N);
  return cudaGetLastError();
}

// Emissions as den_scan_forward; asum [T, N] from it; init [L, F]; real
// [L, F] (1 on real slots, 0 on padding); total [N]; tot [N] workspace;
// out: hist [T, L, F, N].
extern "C" cudaError_t den_scan_backward(
    const void* A, int pre, const float* xs_self, const float* xs_fwd,
    const float* xs_res, const float* asum, const float* init,
    const float* real, const float* total, float* state, float* parts,
    bf16* panels, float* ws, float* tot, float* hist, int L, int F, int N,
    int T, int slices, int terms, float leaky, cudaStream_t stream) {
  if (bad_shape(pre, L, F, N, T, slices, terms)) return cudaErrorInvalidValue;
  const int NCH = F / CH;
  const size_t LFN = (size_t)L * F * N, FN = (size_t)F * N;
  const Route r = pick_route<false>(pre, terms);
  if (r.err != cudaSuccess) return r.err;
  const auto operand_k = r.one ? bwd_operand_kernel<true>
                               : bwd_operand_kernel<false>;
  const auto update_k = r.one ? bwd_update_kernel<true>
                              : bwd_update_kernel<false>;
  const dim3 chunks(NCH, N / BN), product(F / BM, N / BN, slices);
  const dim3 operand(F / 8 / KG, N / BN);
  const Operands op{A, panels, ws, F, slices};
  bwd_init_kernel<<<chunks, BN, 0, stream>>>(real, init, total, state, parts,
                                             L, F, N);
  cudaError_t err = cudaGetLastError();
  for (int i = 0; i < T && err == cudaSuccess; ++i) {
    const int f = T - 1 - i;
    const int cur = i % 2, nxt = 1 - cur;
    const float* st_in = state + cur * LFN;
    err = launch(r.one, operand_k, operand, BN, 0, stream, xs_res + f * FN,
                 st_in, parts + (size_t)cur * NCH * N, NCH, tot, panels, F, N,
                 leaky);
    if (err == cudaSuccess)
      err = launch(r.one, r.prod, product, NT, r.smem, stream, op);
    if (err == cudaSuccess)
      err = launch(r.one, update_k, chunks, UT, 0, stream, ws, slices,
                   xs_self + f * LFN, xs_fwd + f * (LFN - FN),
                   asum + (size_t)f * N, init, st_in, state + nxt * LFN,
                   hist + f * LFN, tot, parts + (size_t)nxt * NCH * N, L, F,
                   N);
  }
  return err;
}
