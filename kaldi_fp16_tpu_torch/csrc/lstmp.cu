// The recurrence of Kaldi's fast-lstmp layer (ops/lstmp.py): the forward
// and the backward of the per-step cell over T steps of a [B, T] batch, one
// launch each.
//
// Replaces no TPU kernel: the JAX package has no LSTM.  The port's plain
// version (ops/lstmp.py `lstmp_recurrence_plain`) is a Python loop of ~15
// PyTorch operations a step and direction; at B = 64 and ~70 steps a layer
// that is thousands of launches a train step of a three-layer TDNN-LSTM.
// cuDNN's LSTM has no peepholes, no scaled cell recurrence and no
// non-recurrent projection, so it cannot compute this layer.
//
// What bounds it on an H100 SXM: a step is a [B, R] x [R, 4C] product, the
// gates, and a [B, C] x [C, R] product (at B 64, C 1024, R 256: 168 MFLOP),
// and the steps are a chain of dependent frames.  The bytes the algorithm
// must move (the gates' pre-activations read once, c, m and r written once,
// the weights once) bound one layer's forward at ~31 us; the chain of steps,
// each two grid-wide barriers and two small products, sets the time.
//
// A reverse walk (Kaldi's delay > 0, the backward layer of a BLSTM) is
// the same code with the direction a template parameter: its forward walks
// t = start down to 0 and reads the state at t + D, its backward walks the
// window up; the kernels are named apart (lstmp_rev_fwd_kernel,
// lstmp_rev_bwd_kernel) so that a trace tells the directions apart.  The
// frames are indexed in place: nothing is flipped.
//
// Design (right and simple first): one persistent cooperative grid (at
// most one block an SM, cudaLaunchCooperativeKernel, so that every block is
// resident) walks the steps; a grid barrier (an atomic counter) separates
// the phases.
//   Forward, a step t:
//     1. unit tiles: a block owns UNITS cell units, holds W_r's 4 x UNITS
//        gate columns of them in shared memory (loaded once when the grid
//        has a block a tile), reads r' = s r_{t-D} of a chunk of BROWS
//        sequences (rounded to bf16 where the operands are), computes the
//        gate pre-activations, and the cell: c, m and the activated gates
//        (saved for the backward) at its units.
//     barrier
//     2. product tiles of RROWS sequences x COLS columns of r:
//        r_t = m_t W_rr + b_r, through shared-memory chunks of depth KF.
//     barrier
//   Backward, a step t from the window's end down to its start:
//     A. unit tiles: the derivative of r_t (the layer's, plus the
//        recurrence's from step t + D, scaled, clipped and zeroed by its
//        row's norm), dm = g_m + dr W_rr^T at the block's units, the cell's
//        backward into the gates' derivatives dz (the output) and dc' into
//        row t - D, with the row's partial squared norm.
//     barrier
//     B. product tiles: dr' = dz_t W_r^T into row t - D, with the partial
//        squared norms.
//     barrier
//   A row's norm sums its partials in a fixed order, so repeats are
//   bit-identical; there are no float atomics.
// Shared-memory tiles are filled by 16-byte asynchronous copies (cp.async),
// all of a tile's in flight at once: a fill of one 4-byte load a thread at a
// time waits an L2 round trip per 1 KB and made the steps latency-bound.
// So C and R must be multiples of 4, and every row 16-byte aligned.
// Products read their shared-memory rows in float4 loads (`dot4`, two
// interleaved partial sums) or, where the operand is column-major, in four
// interleaved partial sums (`dot`).  Every sum is float32 in a fixed
// order.  Products read float32
// weights that the wrapper rounded to bf16 where the operands are bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNITS = 8;             // cell units of a unit tile
constexpr int GCOLS = 4 * UNITS;     // their gate columns (i, f, g, o)
constexpr int BROWS = 32;            // sequences of a unit tile's chunk
constexpr int RROWS = 8;             // sequences of a product tile
constexpr int COLS = 32;             // columns of a product tile
constexpr int KF = 256;              // depth of a forward product chunk
constexpr int KB = 512;              // depth of a backward product chunk
constexpr int MAX_R = 512;
constexpr int SMEM_MAX = 232448;

static_assert(THREADS == BROWS * UNITS, "one thread a (sequence, unit)");
static_assert(THREADS == RROWS * COLS, "one thread an output of a tile");
static_assert(GCOLS == 32, "a warp spans a unit tile's gate columns");
static_assert(BROWS % 4 == 0 && KB % 4 == 0, "float4 rows stay aligned");

struct Fwd {
  const float* z;      // [B, T, 4C]
  const float* wr;     // [R, 4C]
  const float* peep;   // [3, C]
  const float* wrr;    // [C, R]
  const float* br;     // [R]
  float* c;            // [B, T, C]
  float* m;            // [B, T, C]
  float* r;            // [B, T, R]
  float* gates;        // [B, T, 4C]
  unsigned* bar;
  int B, T, C, R, start, D;
  float s;
  int bf16;
};

struct Bwd {
  const float* gates;  // [B, T, 4C]
  const float* c;      // [B, T, C]
  const float* wr;     // [R, 4C]
  const float* peep;   // [3, C]
  const float* wrr;    // [C, R]
  const float* g_r;    // [B, T, R]
  const float* g_m;    // [B, T, C]
  float* dz;           // [B, T, 4C]
  float* drt;          // [B, T, R]: r's whole derivative
  float* rc;           // [B, T, C]: dc' arriving at row t (pre-truncation)
  float* rr;           // [B, T, R]: dr' arriving at row t (pre-truncation)
  float* parts;        // [T, B, NP]: a row's partial squared norms
  unsigned* bar;
  int B, T, C, R, start, D, lo, hi;
  float s, clip, zthr;
  int zi, rec, frame0, frame_step;
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float op(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// The pitch of a shared-memory row of n floats (n a multiple of 4) that
// float4 loads read: 4 more, so that the eight lanes of a quarter warp
// reading eight rows at one column fall on distinct banks.
__host__ __device__ constexpr int pitch4(int n) { return n + 4; }

// rows x cols floats (cols a multiple of 4) into shared memory at row pitch
// dp: the 16 bytes at row r, column c from src(r, c) (16-byte aligned;
// nullptr: zeros), in asynchronous copies (cp.async) that are all in flight
// at once; returns when they have landed.  The caller syncs the block.
template <typename Src>
__device__ __forceinline__ void copy_rows(float* dst, int dp, int rows,
                                          int cols, Src src) {
  const int q4 = cols / 4;
  for (int i = threadIdx.x; i < rows * q4; i += THREADS) {
    const int r = i / q4, c = 4 * (i % q4);
    float* d = dst + r * dp + c;
    const float* g = src(r, c);
    if (g != nullptr) {
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(g)
                   : "memory");
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sum_k x[k] y[k] over k < n (a multiple of 4; x and y 16-byte aligned),
// from shared memory in float4 loads: (sum of the .x and .y products) +
// (sum of the .z and .w products), each in increasing k.
__device__ __forceinline__ float dot4(const float* x, const float* y, int n) {
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll 4
  for (int k = 0; k < n; k += 4) {
    const float4 u = *reinterpret_cast<const float4*>(x + k);
    const float4 v = *reinterpret_cast<const float4*>(y + k);
    p0 = fmaf(u.x, v.x, p0);
    p1 = fmaf(u.z, v.z, p1);
    p0 = fmaf(u.y, v.y, p0);
    p1 = fmaf(u.w, v.w, p1);
  }
  return p0 + p1;
}

// sum_k x[k xs] y[k ys] over k < n from shared memory, in four interleaved
// partial sums ((p0 + p1) + (p2 + p3)): four independent chains of
// multiply-adds, their loads issued ahead of the adds.
__device__ __forceinline__ float dot(const float* x, int xs, const float* y,
                                     int ys, int n) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= n; k += 4) {
    p0 += x[k * xs] * y[k * ys];
    p1 += x[(k + 1) * xs] * y[(k + 1) * ys];
    p2 += x[(k + 2) * xs] * y[(k + 2) * ys];
    p3 += x[(k + 3) * xs] * y[(k + 3) * ys];
  }
  for (; k < n; ++k) p0 += x[k * xs] * y[k * ys];
  return (p0 + p1) + (p2 + p3);
}

// Every block of the (co-resident) grid arrives, then leaves: the counter
// only grows, so the k-th barrier waits for k x gridDim.x arrivals.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*((volatile unsigned*)bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The forward pass, walking up from a.start (REV: down from it).
template <bool REV>
__device__ __forceinline__ void fwd_walk(Fwd a, float* sm) {
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, C = a.C, R = a.R, G = 4 * a.C;
  const int RS = pitch4(R);
  float* wt = sm;                          // [GCOLS][RS]: W_r's columns
  float* rs = wt + GCOLS * RS;             // [BROWS][RS]: r' rows
  float* pre = rs + BROWS * RS;            // [BROWS][GCOLS]
  float* ms = pre + BROWS * GCOLS;         // [RROWS][KF]
  float* ws = ms + RROWS * KF;             // [KF][COLS]
  const int n_unit = (C + UNITS - 1) / UNITS;
  const int n_row = (B + RROWS - 1) / RROWS, n_col = (R + COLS - 1) / COLS;
  const bool resident = n_unit <= (int)gridDim.x;
  unsigned target = 0;
  bool loaded = false;

  for (int t = a.start; REV ? t >= 0 : t < T; t += REV ? -1 : 1) {
    const int src = REV ? t + a.D : t - a.D;   // the state step t reads
    const bool has_prev = REV ? src <= a.start : src >= a.start;
    // 1. gates and cell at each unit tile
    for (int tile = blockIdx.x; tile < n_unit; tile += gridDim.x) {
      const int u0 = tile * UNITS;
      if (!(resident && loaded)) {
        __syncthreads();
        for (int i = tid; i < R * GCOLS; i += THREADS) {
          const int k = i / GCOLS, col = i % GCOLS;
          const int u = u0 + col % UNITS, g = col / UNITS;
          wt[col * RS + k] = u < C ? a.wr[(size_t)k * G + g * C + u] : 0.0f;
        }
        loaded = true;
      }
      for (int b0 = 0; b0 < B; b0 += BROWS) {
        __syncthreads();
        copy_rows(rs, RS, BROWS, R, [&](int bb, int k) -> const float* {
          const int b = b0 + bb;
          return (b < B && has_prev) ? a.r + ((size_t)b * T + src) * R + k
                                     : nullptr;
        });
        __syncthreads();
        for (int i = tid; i < BROWS * R; i += THREADS) {   // r' = s r, rounded
          float* v = rs + (i / R) * RS + i % R;
          *v = op(a.s * *v, a.bf16);
        }
        __syncthreads();
        {
          // a warp: one row group, the 32 gate columns; four rows a thread
          const int col = tid % GCOLS, rg = tid / GCOLS;
#pragma unroll
          for (int q = 0; q < BROWS / 8; ++q)
            pre[(rg + 8 * q) * GCOLS + col] =
                dot4(rs + (rg + 8 * q) * RS, wt + col * RS, R);
        }
        __syncthreads();
        {
          const int bb = tid / UNITS, uu = tid % UNITS;
          const int b = b0 + bb, u = u0 + uu;
          if (b < B && u < C) {
            const size_t row = (size_t)b * T + t;
            const float* zr = a.z + row * G;
            const float ai = pre[bb * GCOLS + uu] + zr[u];
            const float af = pre[bb * GCOLS + UNITS + uu] + zr[C + u];
            const float ag = pre[bb * GCOLS + 2 * UNITS + uu] + zr[2 * C + u];
            const float ao = pre[bb * GCOLS + 3 * UNITS + uu] + zr[3 * C + u];
            const float cp =
                has_prev ? a.s * a.c[((size_t)b * T + src) * C + u] : 0.0f;
            const float i = sigm(ai + a.peep[u] * cp);
            const float f = sigm(af + a.peep[C + u] * cp);
            const float g = tanhf(ag);
            const float cc = f * cp + i * g;
            const float o = sigm(ao + a.peep[2 * C + u] * cc);
            a.c[row * C + u] = cc;
            a.m[row * C + u] = op(o * tanhf(cc), a.bf16);
            float* gr = a.gates + row * G;
            gr[u] = i;
            gr[C + u] = f;
            gr[2 * C + u] = g;
            gr[3 * C + u] = o;
          }
        }
      }
    }
    grid_sync(a.bar, target);
    // 2. r_t = m_t W_rr + b_r
    for (int tile = blockIdx.x; tile < n_row * n_col; tile += gridDim.x) {
      const int b0 = (tile / n_col) * RROWS, c0 = (tile % n_col) * COLS;
      const int row = tid / COLS, col = tid % COLS;
      float acc = 0.0f;
      for (int k0 = 0; k0 < C; k0 += KF) {
        __syncthreads();
        copy_rows(ms, KF, RROWS, KF, [&](int rr, int kk) -> const float* {
          const int b = b0 + rr, k = k0 + kk;
          return (b < B && k < C) ? a.m + ((size_t)b * T + t) * C + k
                                  : nullptr;
        });
        copy_rows(ws, COLS, KF, COLS, [&](int kk, int cc) -> const float* {
          const int k = k0 + kk, n = c0 + cc;
          return (k < C && n < R) ? a.wrr + (size_t)k * R + n : nullptr;
        });
        __syncthreads();
        acc += dot(ms + row * KF, 1, ws + col, COLS, KF);
      }
      const int b = b0 + row, n = c0 + col;
      if (b < B && n < R) a.r[((size_t)b * T + t) * R + n] = acc + a.br[n];
    }
    grid_sync(a.bar, target);
  }
}

__global__ void __launch_bounds__(THREADS) lstmp_fwd_kernel(Fwd a) {
  extern __shared__ __align__(16) float sm[];
  fwd_walk<false>(a, sm);
}

__global__ void __launch_bounds__(THREADS) lstmp_rev_fwd_kernel(Fwd a) {
  extern __shared__ __align__(16) float sm[];
  fwd_walk<true>(a, sm);
}

// The backward pass over the window, against the forward's order: down
// from a.hi (REV: up from a.lo).
template <bool REV>
__device__ __forceinline__ void bwd_walk(Bwd a, float* sm) {
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, C = a.C, R = a.R, G = 4 * a.C;
  const int RS = pitch4(R);
  float* wrrs = sm;                        // [UNITS][RS]: W_rr's unit rows
  float* drs = wrrs + UNITS * RS;          // [BROWS][RS]: dr_t rows
  float* rrs = drs + BROWS * RS;           // [BROWS][RS]: row t's dr'
  float* fac = rrs + BROWS * RS;           // [BROWS]: row t's factors
  float* dzs = fac + BROWS;                // [RROWS][KB]
  float* wts = dzs + RROWS * KB;           // [COLS][KB + 4]
  const int n_unit = (C + UNITS - 1) / UNITS;
  const int n_row = (B + RROWS - 1) / RROWS, n_col = (R + COLS - 1) / COLS;
  const int NP = n_unit + n_col;
  const bool resident = n_unit <= (int)gridDim.x;
  unsigned target = 0;
  bool loaded = false;

  for (int t = REV ? a.lo : a.hi; REV ? t <= a.hi : t >= a.lo;
       t += REV ? 1 : -1) {
    const int src = REV ? t + a.D : t - a.D;   // the state step t read
    const bool has_prev = REV ? src <= a.start : src >= a.start;
    // A. dr_t, dm and the cell's backward at each unit tile
    for (int tile = blockIdx.x; tile < n_unit; tile += gridDim.x) {
      const int u0 = tile * UNITS;
      if (!(resident && loaded)) {
        __syncthreads();
        copy_rows(wrrs, RS, UNITS, R, [&](int uu, int k) -> const float* {
          return u0 + uu < C ? a.wrr + (size_t)(u0 + uu) * R + k : nullptr;
        });
        loaded = true;
      }
      for (int b0 = 0; b0 < B; b0 += BROWS) {
        __syncthreads();
        // row t's truncation: s, the clip and the zeroing by its norm; a
        // warp sums a row's partial squared norms (lane-strided, then a
        // fixed shuffle tree)
        for (int bb = tid / 32; bb < BROWS; bb += THREADS / 32) {
          const int b = b0 + bb, lane = tid % 32;
          float nrm = 0.0f;
          if (b < B) {
            const float* p = a.parts + ((size_t)t * B + b) * NP;
            for (int q = lane; q < NP; q += 32) nrm += p[q];
          }
          for (int off = 16; off > 0; off >>= 1)
            nrm += __shfl_xor_sync(0xffffffffu, nrm, off);
          if (lane == 0) {
            float f = a.s;
            const float n = sqrtf(nrm);
            if (a.clip > 0.0f && n > a.clip) f *= a.clip / n;
            if (b < B && a.zthr > 0.0f && a.zi > 0 && n > a.zthr) {
              const int time = a.frame0 + t * a.frame_step - b;
              const int res = ((time % a.zi) + a.zi) % a.zi;
              if (res < a.rec) f = 0.0f;
            }
            fac[bb] = f;
          }
        }
        __syncthreads();
        copy_rows(drs, RS, BROWS, R, [&](int bb, int k) -> const float* {
          const int b = b0 + bb;
          return b < B ? a.g_r + ((size_t)b * T + t) * R + k : nullptr;
        });
        copy_rows(rrs, RS, BROWS, R, [&](int bb, int k) -> const float* {
          const int b = b0 + bb;
          return b < B ? a.rr + ((size_t)b * T + t) * R + k : nullptr;
        });
        __syncthreads();
        for (int i = tid; i < BROWS * R; i += THREADS) {  // dr_t, whole
          const int bb = i / R, k = i % R, b = b0 + bb;
          float* v = drs + bb * RS + k;
          *v += fac[bb] * rrs[bb * RS + k];
          if (tile == 0 && b < B) a.drt[((size_t)b * T + t) * R + k] = *v;
        }
        __syncthreads();
        const int bb = tid / UNITS, uu = tid % UNITS;
        const int b = b0 + bb, u = u0 + uu;
        float dcp = 0.0f;
        if (b < B && u < C) {
          const size_t row = (size_t)b * T + t;
          float dm = a.g_m[row * C + u];
          dm += dot4(drs + bb * RS, wrrs + uu * RS, R);
          const float* gr = a.gates + row * G;
          const float i = gr[u], f = gr[C + u], g = gr[2 * C + u],
                      o = gr[3 * C + u];
          const float cc = a.c[row * C + u];
          const float cp =
              has_prev ? a.s * a.c[((size_t)b * T + src) * C + u] : 0.0f;
          const float tc = tanhf(cc);
          const float dao = dm * tc * o * (1.0f - o);
          const float dct = fac[bb] * a.rc[row * C + u] +
                            dm * o * (1.0f - tc * tc) + dao * a.peep[2 * C + u];
          const float dai = dct * g * i * (1.0f - i);
          const float daf = dct * cp * f * (1.0f - f);
          const float dag = dct * i * (1.0f - g * g);
          float* dzr = a.dz + row * G;
          dzr[u] = dai;
          dzr[C + u] = daf;
          dzr[2 * C + u] = dag;
          dzr[3 * C + u] = dao;
          dcp = dct * f + dai * a.peep[u] + daf * a.peep[C + u];
          if (has_prev) a.rc[((size_t)b * T + src) * C + u] = dcp;
        }
        // the tile's part of row src's squared norm (8 lanes a sequence)
        float sq = dcp * dcp;
        sq += __shfl_xor_sync(0xffffffffu, sq, 4);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        if (uu == 0 && b < B && has_prev)
          a.parts[((size_t)src * B + b) * NP + tile] = sq;
      }
    }
    grid_sync(a.bar, target);
    // B. dr' = dz_t W_r^T into row src
    if (has_prev) {
      for (int tile = blockIdx.x; tile < n_row * n_col; tile += gridDim.x) {
        const int ct = tile % n_col;
        const int b0 = (tile / n_col) * RROWS, c0 = ct * COLS;
        const int row = tid / COLS, col = tid % COLS;
        float acc = 0.0f;
        for (int j0 = 0; j0 < G; j0 += KB) {
          __syncthreads();
          copy_rows(dzs, KB, RROWS, KB, [&](int rr, int jj) -> const float* {
            const int b = b0 + rr, j = j0 + jj;
            return (b < B && j < G) ? a.dz + ((size_t)b * T + t) * G + j
                                    : nullptr;
          });
          copy_rows(wts, KB + 4, COLS, KB, [&](int cc, int jj) -> const float* {
            const int n = c0 + cc, j = j0 + jj;
            return (n < R && j < G) ? a.wr + (size_t)n * G + j : nullptr;
          });
          __syncthreads();
          acc += dot4(dzs + row * KB, wts + col * (KB + 4), KB);
        }
        const int b = b0 + row, n = c0 + col;
        float sq = (b < B && n < R) ? acc * acc : 0.0f;
        if (b < B && n < R) a.rr[((size_t)b * T + src) * R + n] = acc;
        for (int off = 16; off > 0; off >>= 1)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (col == 0 && b < B)
          a.parts[((size_t)src * B + b) * NP + n_unit + ct] = sq;
      }
    }
    grid_sync(a.bar, target);
  }
}

__global__ void __launch_bounds__(THREADS) lstmp_bwd_kernel(Bwd a) {
  extern __shared__ __align__(16) float sm[];
  bwd_walk<false>(a, sm);
}

__global__ void __launch_bounds__(THREADS) lstmp_rev_bwd_kernel(Bwd a) {
  extern __shared__ __align__(16) float sm[];
  bwd_walk<true>(a, sm);
}

size_t fwd_smem(int R) {
  return sizeof(float) * ((size_t)GCOLS * pitch4(R) + BROWS * pitch4(R) +
                          BROWS * GCOLS + RROWS * KF + KF * COLS);
}

size_t bwd_smem(int R) {
  return sizeof(float) * ((size_t)UNITS * pitch4(R) + 2 * BROWS * pitch4(R) +
                          BROWS + RROWS * KB + COLS * (KB + 4));
}

// A cooperative launch of `kernel` with one block an SM at most, and no
// more blocks than the larger of the two phases has tiles.
template <typename Args>
int launch_coop(void (*kernel)(Args), Args args, size_t smem, int tiles,
                cudaStream_t stream) {
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int blocks = sms < tiles ? sms : tiles;
  if (blocks < 1) blocks = 1;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lstmp_forward(const float* z, const float* wr, const float* peep,
                             const float* wrr, const float* br, float* c,
                             float* m, float* r, float* gates, unsigned* bar,
                             int B, int T, int C, int R, int start, int D,
                             float s, int bf16, int reverse,
                             cudaStream_t stream) {
  if (B < 1 || T < 1 || C < 1 || R < 1 || R > MAX_R || D < 1 || C % 4 ||
      R % 4 || start < 0 || start >= T)
    return (int)cudaErrorInvalidValue;
  Fwd a{z, wr, peep, wrr, br, c, m, r, gates, bar,
        B, T, C, R, start, D, s, bf16};
  const int n_unit = (C + UNITS - 1) / UNITS;
  const int n_prod = ((B + RROWS - 1) / RROWS) * ((R + COLS - 1) / COLS);
  return launch_coop(reverse ? lstmp_rev_fwd_kernel : lstmp_fwd_kernel, a,
                     fwd_smem(R), n_unit > n_prod ? n_unit : n_prod, stream);
}

extern "C" int lstmp_backward(const float* gates, const float* c,
                              const float* wr, const float* peep,
                              const float* wrr, const float* g_r,
                              const float* g_m, float* dz, float* drt,
                              float* rc, float* rr, float* parts, unsigned* bar,
                              int B, int T, int C, int R, int start, int D,
                              int lo, int hi, float s, float clip, float zthr,
                              int zi, int rec, int frame0, int frame_step,
                              int reverse, cudaStream_t stream) {
  if (B < 1 || T < 1 || C < 1 || R < 1 || R > MAX_R || D < 1 || C % 4 ||
      R % 4 || start < 0 || start >= T || lo < 0 || hi >= T)
    return (int)cudaErrorInvalidValue;
  Bwd a{gates, c,  wr, peep, wrr,   g_r, g_m, dz,   drt,  rc, rr,
        parts, bar, B,  T,    C,     R,   start, D, lo, hi, s, clip,
        zthr,  zi,  rec, frame0, frame_step};
  const int n_unit = (C + UNITS - 1) / UNITS;
  const int n_prod = ((B + RROWS - 1) / RROWS) * ((R + COLS - 1) / COLS);
  return launch_coop(reverse ? lstmp_rev_bwd_kernel : lstmp_bwd_kernel, a,
                     bwd_smem(R), n_unit > n_prod ? n_unit : n_prod, stream);
}
