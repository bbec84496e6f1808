// The chain numerator's log-domain forward-backward over a padded batch of
// supervision graphs (chain/graph.py NumeratorGraphBatch): per sequence b,
// the total log-probability and the pdf posteriors [T, P].
//
// Replaces no TPU kernel: the JAX package runs the numerator as a lax.scan
// of one-hot matrix products (kaldi_fp16_tpu/chain/numerator.py), which XLA
// compiles into one loop.  Its PyTorch transcription
// (chain/numerator.py `_forward_backward`, the plain version) issues about
// a dozen small operations per frame and direction, ~1,100 launches a
// training step, and builds one-hot [B, A, S] and [B, A, P] matrices; the
// host's time to enqueue them was the largest phase of the train step.
//
// What bounds it on an H100 SXM (data sheet): the arithmetic is tiny (a
// linear supervision chain at B = 128, T = 49, S = 50, A = 98 is 0.6 M
// arc-frames a direction), so bytes: the [B, T, P] fp32 posteriors (77.3 MB
// at P = 3080, zeroed by the caller's memset, then only the arcs' pdfs
// written here), the nnet output's values the arcs read (B T A x 4 B) and
// the arcs themselves, >= 23 us at 3.35 TB/s.  The recursion itself is a
// chain of 2T dependent frames per sequence, so the kernel sits on the
// latency of a frame (a gather from shared memory, three block barriers,
// an exp and a log per arc), not on bandwidth.
//
// Design: one block per sequence (B = 128 is one wave on 132 SMs), the
// block sized from the S and A of the batch.
//   * Each thread holds up to ARCS_PER_THREAD arcs (arc a = thread + k *
//     blockDim) in registers: source, destination, pdf and weight.  An arc
//     is live when its mask is > 0, its pdf lies in [0, P) and its states in
//     [0, S); only live arcs contribute, as in the plain version (epsilon
//     arcs are masked by build_numerator_batch).
//   * At entry the block sorts the live arcs three times, stably, by rank
//     (each arc counts the arcs whose key, then index, is smaller): by
//     destination (alpha), by source (beta) and by pdf (posteriors).  Each
//     state's sum is then one thread's loop over its arcs in increasing arc
//     index, and each pdf's sum likewise over its run of arcs.
//   * Alpha (forward) and beta (backward) of the current frame live in
//     shared memory.  A frame: each arc's value from its state and its
//     score (the nnet output at its pdf, prefetched a frame ahead, plus its
//     weight); the row max over the live arcs (NaN wins, as torch.amax),
//     clamped below at -1e28 (all-dead frames); exp(value - max) per arc;
//     each state's sum in fp32 in arc order; max + log(sum), or LOG_ZERO
//     for an empty sum.  States ~87 nats below the row max underflow to
//     LOG_ZERO exactly as in the plain version and the JAX package.
//   * The forward sweep writes alpha at each frame into a [B, T, S] scratch;
//     the backward sweep reads it back and forms each arc's posterior,
//     exp(min(alpha + score + beta - total, 0)), beside beta's update, then
//     sums the arcs of each pdf into the frame's row of the output.  A
//     sequence whose final states are unreachable (total LOG_ZERO) skips the
//     backward sweep: its posteriors stay zero.
// Every sum runs in a fixed order (no float atomics), so repeats are
// bit-identical.  Everything is fp32; exp and log are the accurate expf /
// logf.  PERF.md holds the measured time beside the plain version's.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_ZERO = -1.0e30f;   // chain/graph.py LOG_ZERO
constexpr float DEAD_GUARD = -1.0e28f; // the plain version's all-dead clamp
constexpr int MAX_THREADS = 512;
constexpr int ARCS_PER_THREAD = 8;
constexpr int MAX_ARCS = MAX_THREADS * ARCS_PER_THREAD;  // 4096
constexpr int MAX_STATES = 4096;
constexpr int ARC_BITS = 12;           // arc index in a packed sort key
constexpr int SMEM_MAX = 232448;       // shared memory a block can use

static_assert(MAX_ARCS <= (1 << ARC_BITS), "arc index must fit its bits");
static_assert(((MAX_STATES + 1LL) << ARC_BITS) < INT_MAX, "packed keys");

// torch.amax's max: a NaN on either side wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The block's max of v (NaN wins), through `slots` [32]; every thread gets
// it.  One barrier; the caller's next barrier keeps the slots from being
// rewritten before every thread has read them.
__device__ __forceinline__ float block_max(float v, float* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d; d >>= 1) v = nan_max(v, __shfl_xor_sync(FULL, v, d));
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  float m = slots[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) m = nan_max(m, slots[w]);
  return m;
}

// Number of sorted positions whose packed key (>> ARC_BITS) is below s.
__device__ __forceinline__ int lower_bound(const int* keys, const int* order,
                                           int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((keys[order[mid]] >> ARC_BITS) < s) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct Smem {
  float* pv;     // [A] exp(value - max) per arc; the dst keys at entry
  float* apost;  // [A] arc posteriors; the src keys at entry
  int* od;       // [A] live arcs by destination, then padding arcs
  int* os;       // [A] by source
  int* op;       // [A] by pdf
  int* kp;       // [A] pdf of each arc, INT_MAX if not live
  int* runs;     // [A + 1] first position of each pdf's run in op
  float* st;     // [S] alpha, then beta, of the current frame
  int* doff;     // [S + 1] each state's first position in od
  int* soff;     // [S + 1] in os
  float* slots;  // [32] block_max's
  int* misc;     // [2] number of runs; total (as float bits)
};

__host__ __device__ inline size_t smem_words(int S, int A) {
  return 7 * (size_t)A + 1 + 3 * (size_t)S + 2 + 32 + 2;
}

__device__ Smem carve(int S, int A) {
  extern __shared__ int smem_words_[];
  Smem m;
  int* p = smem_words_;
  m.pv = reinterpret_cast<float*>(p), p += A;
  m.apost = reinterpret_cast<float*>(p), p += A;
  m.od = p, p += A;
  m.os = p, p += A;
  m.op = p, p += A;
  m.kp = p, p += A;
  m.runs = p, p += A + 1;
  m.st = reinterpret_cast<float*>(p), p += S;
  m.doff = p, p += S + 1;
  m.soff = p, p += S + 1;
  m.slots = reinterpret_cast<float*>(p), p += 32;
  m.misc = p;
  return m;
}

__global__ void __launch_bounds__(MAX_THREADS)
numerator_kernel(const float* __restrict__ x, const int* __restrict__ arc_src,
                 const int* __restrict__ arc_dst,
                 const int* __restrict__ arc_pdf,
                 const float* __restrict__ arc_logw,
                 const float* __restrict__ arc_mask,
                 const int* __restrict__ start,
                 const float* __restrict__ final_logw,
                 float* __restrict__ alpha_hist, float* __restrict__ total_out,
                 float* __restrict__ post, int T, int P, int S, int A) {
  constexpr int K = ARCS_PER_THREAD;
  const Smem sm = carve(S, A);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  int* kd = reinterpret_cast<int*>(sm.pv);     // packed (dst, arc) keys
  int* ks = reinterpret_cast<int*>(sm.apost);  // packed (src, arc) keys

  // this thread's arcs, in registers
  int src[K], dst[K], pdf[K];
  float lw[K];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = tid + k * nt;
    src[k] = dst[k] = pdf[k] = 0;
    lw[k] = 0.f;
    if (a < A) {
      const size_t i = (size_t)b * A + a;
      const int s = arc_src[i], d = arc_dst[i], p = arc_pdf[i];
      const bool ok = arc_mask[i] > 0.f && p >= 0 && p < P && s >= 0 &&
                      s < S && d >= 0 && d < S;
      if (ok) {
        live |= 1u << k;
        src[k] = s, dst[k] = d, pdf[k] = p;
        lw[k] = arc_logw[i];
      }
      kd[a] = ((ok ? d : S) << ARC_BITS) | a;
      ks[a] = ((ok ? s : S) << ARC_BITS) | a;
      sm.kp[a] = ok ? p : INT_MAX;
    }
  }
  __syncthreads();

  // stable sorts by rank, one key at a time: the packed keys are distinct,
  // the pdfs' ties are broken by the arc index
  auto place = [&](const int* keys, int* order, bool packed) {
    int mine[K], rank[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = tid + k * nt;
      mine[k] = a < A ? keys[a] : INT_MAX;
      rank[k] = 0;
    }
    for (int j = 0; j < A; ++j) {
      const int key = keys[j];
#pragma unroll
      for (int k = 0; k < K; ++k)
        rank[k] += key < mine[k] ||
                   (!packed && key == mine[k] && j < tid + k * nt);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (tid + k * nt < A) order[rank[k]] = tid + k * nt;
  };
  place(kd, sm.od, true);
  place(ks, sm.os, true);
  place(sm.kp, sm.op, false);
  __syncthreads();
  // each state's segment of the sorted lists; doff[S] = the live arcs
  for (int s = tid; s <= S; s += nt) {
    sm.doff[s] = lower_bound(kd, sm.od, A, s);
    sm.soff[s] = lower_bound(ks, sm.os, A, s);
  }
  __syncthreads();
  // the runs of equal pdfs among the live arcs, in sorted order
  if (warp == 0) {
    const int n = sm.doff[S];
    int base = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool first = i < n && (i == 0 || sm.kp[sm.op[i]] !=
                                                 sm.kp[sm.op[i - 1]]);
      const unsigned firsts = __ballot_sync(FULL, first);
      if (first) sm.runs[base + __popc(firsts & ((1u << lane) - 1u))] = i;
      base += __popc(firsts);
    }
    if (lane == 0) {
      sm.runs[base] = n;
      sm.misc[0] = base;
    }
  }
  for (int s = tid; s < S; s += nt) sm.st[s] = LOG_ZERO;
  __syncthreads();
  if (tid == 0) {
    const int s0 = start[b];
    if (s0 >= 0 && s0 < S) sm.st[s0] = 0.f;
  }
  __syncthreads();

  const float* xb = x + (size_t)b * T * P;
  float* hist = alpha_hist + (size_t)b * T * S;
  auto load_scores = [&](float* xv, int t) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      xv[k] = (live >> k) & 1u ? __ldg(xb + (size_t)t * P + pdf[k]) : 0.f;
  };

  // forward: alpha over frames 0 .. T-1; hist[t] = alpha entering frame t
  float xv[K], xn[K];
  if (T > 0) load_scores(xv, 0);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) load_scores(xn, t + 1);
    float v[K];
    float lm = LOG_ZERO;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = LOG_ZERO;
      if ((live >> k) & 1u) {
        const float sa = sm.st[src[k]];
        const float sc = xv[k] + lw[k];
        v[k] = sa > LOG_ZERO ? sa + sc : LOG_ZERO;
        lm = nan_max(lm, v[k]);
      }
    }
    float m = block_max(lm, sm.slots);
    m = m < DEAD_GUARD ? DEAD_GUARD : m;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u)
        sm.pv[tid + k * nt] = v[k] > LOG_ZERO ? expf(v[k] - m) : 0.f;
    __syncthreads();
    for (int s = tid; s < S; s += nt) {
      float sum = 0.f;
      for (int i = sm.doff[s]; i < sm.doff[s + 1]; ++i) sum += sm.pv[sm.od[i]];
      hist[(size_t)t * S + s] = sm.st[s];
      sm.st[s] = sum > 0.f ? m + logf(sum) : LOG_ZERO;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) xv[k] = xn[k];
  }

  // total = logsumexp over the final states (torch.logsumexp's steps),
  // LOG_ZERO if not finite
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const float fw = final_logw[(size_t)b * S + s];
      mx = nan_max(mx, fw > LOG_ZERO ? sm.st[s] + fw : -INFINITY);
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) mx = nan_max(mx, __shfl_xor_sync(FULL, mx, d));
    if (fabsf(mx) == INFINITY) mx = 0.f;
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float fw = final_logw[(size_t)b * S + s];
      sum += expf((fw > LOG_ZERO ? sm.st[s] + fw : -INFINITY) - mx);
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
    float total = logf(sum) + mx;
    if (!isfinite(total)) total = LOG_ZERO;
    if (lane == 0) {
      sm.misc[1] = __float_as_int(total);
      total_out[b] = total;
    }
  }
  __syncthreads();
  const float total = __int_as_float(sm.misc[1]);
  if (!(total > LOG_ZERO)) return;   // posteriors stay zero

  // backward: beta from the final weights; at frame t (T-1 .. 0) the arc
  // posteriors use beta at t + 1, then beta steps to frame t
  for (int s = tid; s < S; s += nt) {
    const float fw = final_logw[(size_t)b * S + s];
    sm.st[s] = fw > LOG_ZERO ? fw : LOG_ZERO;
  }
  __syncthreads();
  const int nruns = sm.misc[0];
  float ah[K], an[K];
  auto load_alpha = [&](float* out, int t) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = (live >> k) & 1u ? hist[(size_t)t * S + src[k]] : 0.f;
  };
  if (T > 0) {
    load_scores(xv, T - 1);
    load_alpha(ah, T - 1);
  }
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      load_scores(xn, t - 1);
      load_alpha(an, t - 1);
    }
    float v[K];
    float lm = LOG_ZERO;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = LOG_ZERO;
      if ((live >> k) & 1u) {
        const float db = sm.st[dst[k]];
        const float sa = ah[k];
        const float sc = xv[k] + lw[k];
        v[k] = db > LOG_ZERO ? db + sc : LOG_ZERO;
        lm = nan_max(lm, v[k]);
        float lp = sa > LOG_ZERO && db > LOG_ZERO ? sa + sc + db - total
                                                  : -INFINITY;
        lp = lp > 0.f ? 0.f : lp;                 // chain.cu:311
        sm.apost[tid + k * nt] = isfinite(lp) ? expf(lp) : 0.f;
      }
    }
    float m = block_max(lm, sm.slots);
    m = m < DEAD_GUARD ? DEAD_GUARD : m;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u)
        sm.pv[tid + k * nt] = v[k] > LOG_ZERO ? expf(v[k] - m) : 0.f;
    __syncthreads();
    for (int s = tid; s < S; s += nt) {
      float sum = 0.f;
      for (int i = sm.soff[s]; i < sm.soff[s + 1]; ++i) sum += sm.pv[sm.os[i]];
      sm.st[s] = sum > 0.f ? m + logf(sum) : LOG_ZERO;
    }
    float* row = post + ((size_t)b * T + t) * P;
    for (int r = tid; r < nruns; r += nt) {
      const int i0 = sm.runs[r], i1 = sm.runs[r + 1];
      float sum = 0.f;
      for (int i = i0; i < i1; ++i) sum += sm.apost[sm.op[i]];
      row[sm.kp[sm.op[i0]]] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xv[k] = xn[k];
      ah[k] = an[k];
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).

extern "C" int numerator_max_states() { return MAX_STATES; }
extern "C" int numerator_max_arcs() { return MAX_ARCS; }

// Device pointers, all contiguous: x [B, T, P] fp32; arc_src, arc_dst,
// arc_pdf [B, A] int32; arc_logw, arc_mask [B, A] fp32; start [B] int32;
// final_logw [B, S] fp32; alpha_hist [B, T, S] fp32 scratch; total [B]
// fp32 (written); post [B, T, P] fp32, zeroed by the caller (the arcs'
// pdfs written).  One launch on `stream`, no synchronisation; returns the
// launch status (cudaErrorInvalidValue for S or A past the limits).
extern "C" cudaError_t chain_numerator(
    const float* x, const int* arc_src, const int* arc_dst, const int* arc_pdf,
    const float* arc_logw, const float* arc_mask, const int* start,
    const float* final_logw, float* alpha_hist, float* total, float* post,
    int B, int T, int P, int S, int A, cudaStream_t stream) {
  if (B <= 0 || T < 0 || P <= 0 || S <= 0 || S > MAX_STATES || A <= 0 ||
      A > MAX_ARCS)
    return cudaErrorInvalidValue;
  int threads = A > S ? A : S;
  threads = (threads + 31) & ~31;
  if (threads < 64) threads = 64;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = smem_words(S, A) * sizeof(int);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        numerator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  numerator_kernel<<<B, threads, smem, stream>>>(
      x, arc_src, arc_dst, arc_pdf, arc_logw, arc_mask, start, final_logw,
      alpha_hist, total, post, T, P, S, A);
  return cudaGetLastError();
}
