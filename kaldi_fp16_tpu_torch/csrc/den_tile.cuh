// The fp32 FFMA tile loop shared by den_matmul.cu and den_scan.cu.
//
// One block of NT threads computes one BM x BN tile of A @ B, where
// A = M or M^T for the constant [F, F] fp32 matrix M (read by strides,
// never transposed in memory) and B is a [F, n] operand that the caller
// supplies element by element through a functor, so a kernel can form B
// on the fly from its state (den_scan.cu) instead of reading a stored
// vector (den_matmul.cu).
//
//   * M and B tiles go through shared memory BK rows deep; every thread
//     keeps a TM x TN register tile of the output, strided by the thread
//     grid (rows ty + i*TY, columns tx + j*TX), so shared-memory reads
//     are conflict-free and stores coalesce;
//   * summation is blocked: each BK-deep stage sums into a fresh partial
//     that is then added to the accumulator, so the rounding error grows
//     with BK + F/BK terms instead of F;
//   * the M loader maps consecutive threads onto whichever index is
//     contiguous in memory, so both orientations load coalesced;
//   * F and n need not be multiples of anything: out-of-range elements of
//     both operands are zero-filled, and the functor is called only for
//     0 <= k < F, 0 <= j < n;
//   * there is no double buffering: a stage's loads, then its FMAs.
// The order of every sum is fixed by the tile shape alone: no split-K and
// no atomics, so a repeated call gives bit-identical results.

#pragma once

#include <cuda_runtime.h>

namespace den_tile {

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

struct Smem {
  // As[k][i] = A(row0 + i, k0 + k); the +1 keeps the transposing store of
  // the row-major load free of bank conflicts.
  float As[BK][BM + 1];
  float Bs[BK][BN];
};

// acc[i][j] = sum_k A(row0 + ty + i*TY, k) * B(k, col0 + tx + j*TX) with
// A = (TRANS ? M^T : M).  Every thread of the block must call it.
template <bool TRANS, class LoadB>
__device__ __forceinline__ void mm_tile(const float* __restrict__ M, int F,
                                        int n, int row0, int col0, Smem& s,
                                        const LoadB& load_b,
                                        float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  constexpr int LA = BM * BK / NT;      // A elements each thread loads
  constexpr int LB = BK * BN / NT;      // B elements each thread loads
  for (int k0 = 0; k0 < F; k0 += BK) {
    // every global load of the stage is issued before any shared store, so
    // the loads overlap (a functor may read through a generic pointer that
    // the compiler cannot prove distinct from the tiles)
    float ra[LA], rb[LB];
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int idx = tid + it * NT;
      // consecutive threads walk the index that is contiguous in memory
      const int r = TRANS ? idx % BM : idx / BK;
      const int c = TRANS ? idx / BM : idx % BK;
      const int gi = row0 + r;
      const int gk = k0 + c;
      ra[it] = 0.f;
      if (gi < F && gk < F)
        ra[it] = TRANS ? M[(size_t)gk * F + gi] : M[(size_t)gi * F + gk];
    }
#pragma unroll
    for (int it = 0; it < LB; ++it) {
      const int idx = tid + it * NT;
      const int gk = k0 + idx / BN;
      const int gj = col0 + idx % BN;
      rb[it] = (gk < F && gj < n) ? load_b(gk, gj) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int idx = tid + it * NT;
      const int r = TRANS ? idx % BM : idx / BK;
      const int c = TRANS ? idx / BM : idx % BK;
      s.As[c][r] = ra[it];
    }
#pragma unroll
    for (int it = 0; it < LB; ++it) {
      const int idx = tid + it * NT;
      s.Bs[idx / BN][idx % BN] = rb[it];
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
      for (int i = 0; i < TM; ++i) a[i] = s.As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.Bs[k][tx + j * TX];
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
}

}  // namespace den_tile
