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
// What bounds it on an H100 SXM (data sheet): one add per labelled value,
// so bytes.  At the production pdf order (NB = 25, K = 6144, n = Tc * N =
// 384) 109,306 of the 153,600 slots carry a label: their values are 167.9
// MB, the labels 0.6 MB and the output 4.9 MB, 173.4 MB in all, >= 51.8 us
// at 3.35 TB/s.  Reading every slot, padding included, would be 241.5 MB
// (>= 72 us).
//
// Design: read each labelled row once, whole and coalesced, and nothing
// else.  Two launches from one C call:
//
//   1. Order pass, one block per b: a stable counting sort of the block's
//      labels.  Each warp takes a contiguous slice of K, loads R steps of
//      32 labels at once and counts them (shared-memory integer atomics:
//      the counts do not depend on their order); per-label prefixes over
//      the warps and a warp scan over the labels give offsets [NB, sb + 1]
//      and each warp's first position per label; each warp then walks its
//      slice again in k order and places every labelled slot at its
//      position, ranked within a 32-slot step by __match_any_sync.  order
//      [NB, K] holds the slot indices of labels in [0, sb) grouped by
//      label, increasing k within a group; padding slots are dropped.  It
//      reads the 0.6 MB of labels.
//   2. Segmented row sum, one warp per (b, s, tile of 128 columns): the
//      warp walks order[b, offsets[b, s] .. offsets[b, s + 1]) in order,
//      each lane loading 16 bytes (four neighbouring columns) of each row,
//      U rows in flight, and adds them into sums that start from 0.f.  The
//      loads are evict-first (each value is read once).  An empty segment
//      writes zeros.  A ragged n (not a multiple of 4, or a
//      base not 16-byte aligned) takes the scalar variant: one column per
//      lane per 32.
//
// Every output is summed from zero in increasing k, the order of a serial
// index_add_, with no float atomics: repeats are bit-identical and the
// result equals the plain version computed on the CPU bit for bit.  Labels
// need not be sorted (the blocked den's are: each segment is then a run of
// neighbouring rows).  PERF.md holds the measured times beside the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ORDER_WARPS = 32;   // warps of an order-pass block
constexpr int R = 8;                  // 32-slot steps loaded at once
constexpr int SMEM_MAX = 232448;      // shared memory a block can use
constexpr int TILE = 128;             // columns per warp of the row sum
constexpr int WPB = 4;                // warps per row-sum block
constexpr int U = 8;                  // rows in flight per warp

// smem: cursor [W][sb] (counts, then each warp's next position per label)
// and tot [sb] (label totals, then their exclusive prefix).
__global__ void segment_order_kernel(const int* __restrict__ labels,
                                     int* __restrict__ order,
                                     int* __restrict__ offsets, int K,
                                     int sb) {
  extern __shared__ int cursor[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tot = cursor + W * sb;
  const int b = blockIdx.x;
  const int* lab = labels + (size_t)b * K;
  int* ord = order + (size_t)b * K;
  int* off = offsets + (size_t)b * (sb + 1);
  for (int i = threadIdx.x; i < W * sb; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  // each warp's slice: a multiple of 32 slots, so steps stay aligned
  const int span = ((K + W - 1) / W + 31) & ~31;
  const int k0 = warp * span, k1 = min(K, k0 + span);
  int* mine = cursor + warp * sb;
  for (int kb = k0; kb < k1; kb += 32 * R) {
    int s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = kb + 32 * r + lane;
      s[r] = k < k1 ? lab[k] : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((unsigned)s[r] < (unsigned)sb) atomicAdd(mine + s[r], 1);
  }
  __syncthreads();
  // per label: exclusive prefix over the warps, and the label's total
  for (int s = threadIdx.x; s < sb; s += blockDim.x) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const int c = cursor[w * sb + s];
      cursor[w * sb + s] = run;
      run += c;
    }
    tot[s] = run;
  }
  __syncthreads();
  // exclusive prefix over the labels: the segment offsets
  if (warp == 0) {
    int carry = 0;
    for (int s0 = 0; s0 < sb; s0 += 32) {
      const int s = s0 + lane;
      const int v = s < sb ? tot[s] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += t;
      }
      if (s < sb) {
        tot[s] = carry + incl - v;
        off[s] = carry + incl - v;
      }
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) off[sb] = carry;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W * sb; i += blockDim.x)
    cursor[i] += tot[i % sb];
  __syncthreads();
  // placement, in k order within the warp's slice
  const unsigned below = (1u << lane) - 1u;
  for (int kb = k0; kb < k1; kb += 32 * R) {
    int s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = kb + 32 * r + lane;
      s[r] = k < k1 ? lab[k] : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = (unsigned)s[r] < (unsigned)sb;
      const unsigned peers = __match_any_sync(FULL, valid ? s[r] : -1);
      if (valid)
        ord[mine[s[r]] + __popc(peers & below)] = kb + 32 * r + lane;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) mine[s[r]] += __popc(peers);
      __syncwarp();
    }
  }
}

// One warp per (b, s, tile): units = NB * sb * tiles, tile fastest.
template <bool VEC>
__global__ void __launch_bounds__(WPB * 32)
segment_rows_kernel(const float* __restrict__ vals,
                    const int* __restrict__ order,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int K, int n, int sb, int tiles, long long units) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WPB + (threadIdx.x >> 5);
  if (g >= units) return;
  const int tile = (int)(g % tiles);
  const long long bs = g / tiles;               // b * sb + s
  const int s = (int)(bs % sb), b = (int)(bs / sb);
  const int* off = offsets + (size_t)b * (sb + 1) + s;
  const int j0 = off[0], j1 = off[1];
  const int* ord = order + (size_t)b * K;
  const int c0 = tile * TILE;
  // VEC: columns c0 + 4 * lane .. + 3; else c0 + lane + 32 * q
  const float* base = vals + (size_t)b * K * n + c0 + (VEC ? 4 * lane : lane);
  bool live[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    live[q] = VEC ? c0 + 4 * lane < n : c0 + lane + 32 * q < n;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = j0; j < j1; j += 32) {
    const int cnt = min(32, j1 - j);
    const int row_here = lane < cnt ? __ldg(ord + j + lane) : 0;
    for (int u = 0; u < cnt; u += U) {
      float x[U][4] = {};
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int row = __shfl_sync(FULL, row_here, (u + i) & 31);
        const float* p = base + (size_t)row * n;
        if (u + i < cnt) {
          if (VEC) {
            if (live[0]) {
              const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
              x[i][0] = v.x;
              x[i][1] = v.y;
              x[i][2] = v.z;
              x[i][3] = v.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (live[q]) x[i][q] = __ldcs(p + 32 * q);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (u + i < cnt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += x[i][q];
        }
    }
  }
  float* o = out + ((size_t)b * sb + s) * n + c0;
  if (VEC) {
    if (live[0])
      *reinterpret_cast<float4*>(o + 4 * lane) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (live[q]) o[lane + 32 * q] = acc[q];
  }
}

cudaError_t launch_order(const int* labels, int* order, int* offsets, int NB,
                         int K, int sb, cudaStream_t stream) {
  int W = K > 0 ? (K + 31) / 32 : 1;
  if (W > MAX_ORDER_WARPS) W = MAX_ORDER_WARPS;
  while (W > 1 && (size_t)(W + 1) * sb * sizeof(int) > SMEM_MAX) --W;
  const size_t smem = (size_t)(W + 1) * sb * sizeof(int);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  segment_order_kernel<<<NB, 32 * W, smem, stream>>>(labels, order, offsets,
                                                     K, sb);
  return cudaGetLastError();
}

bool valid_shape(int NB, int K, int sb) {
  return NB > 0 && K >= 0 && sb > 0 && sb < (1 << 30);
}

}  // namespace

// Plain C entry points, bound with ctypes (kaldi_fp16_tpu_torch/ops/_build.py).
// Device pointers, all contiguous: labels [NB, K] int32, order [NB, K] and
// offsets [NB, sb + 1] int32 (written: the order pass's output; order past
// offsets[b, sb] is left unwritten), vals [NB, K, n] fp32, out [NB, sb, n]
// fp32.  Each launches on `stream`, does not synchronise and returns the
// launch status.

// The order pass alone.
extern "C" cudaError_t segment_order(const int* labels, int* order,
                                     int* offsets, int NB, int K, int sb,
                                     cudaStream_t stream) {
  if (!valid_shape(NB, K, sb)) return cudaErrorInvalidValue;
  return launch_order(labels, order, offsets, NB, K, sb, stream);
}

// The order pass, then the segmented row sum.
extern "C" cudaError_t segment_reduce(const float* vals, const int* labels,
                                      int* order, int* offsets, float* out,
                                      int NB, int K, int n, int sb,
                                      cudaStream_t stream) {
  if (!valid_shape(NB, K, sb) || n <= 0) return cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  const long long units = (long long)NB * sb * tiles;
  const long long blocks = (units + WPB - 1) / WPB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = launch_order(labels, order, offsets, NB, K, sb, stream);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    segment_rows_kernel<true><<<(unsigned)blocks, WPB * 32, 0, stream>>>(
        vals, order, offsets, out, K, n, sb, tiles, units);
  else
    segment_rows_kernel<false><<<(unsigned)blocks, WPB * 32, 0, stream>>>(
        vals, order, offsets, out, K, n, sb, tiles, units);
  return cudaGetLastError();
}
