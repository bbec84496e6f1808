// The tensor-core product tile shared by den_matmul.cu and den_scan.cu:
// (M or M^T) @ B for the constant [Fp, Fp] phone-LM residual M and a
// [Fp, np] operand B, in fp32 class from bf16 tensor-core products.
//
// Arithmetic (the TPU kernel's, kaldi_fp16_tpu/ops/pallas_den_matmul.py
// `_split3_kernel`, and pallas_den_scan.py `_dot6`): m = m0 + m1 + m2 and
// b = b0 + b1 + b2 in bf16 (each term the round-to-nearest bf16 of what the
// earlier terms left), and
//   TERMS = 1:                                  m0b0   (the fast den)
//   TERMS = 3:  m1b0 + m0b1                   + m0b0
//   TERMS = 6:  m1b0 + m0b1 + m1b1 + m2b0 + m0b2 + m0b0
// with exact bf16 x bf16 products accumulated in fp32.  The small cross
// products of a K stage go into its fresh partial first and the large
// m0b0 last, and each stage's partial is added into the running fp32
// total by an ordinary (round-to-nearest) add, so the tensor core's own
// accumulation rounding acts on a few products at a time and the error
// grows with the stage count, not with F.  TERMS = 1 through
// `product_block` reads only plane 0 of A and B but still loads and
// splits all three; `plane_product_block` (below) is the TERMS = 1 route
// that reads one bf16 plane of each, with the same arithmetic and bits.
//
// Layouts (all zero-padded, so no tile load is masked):
//   A (PRE = false)  M itself, fp32 [Fp, Fp] row-major; each thread splits
//                    its fragment in registers (split="kernel");
//   A (PRE = true)   M split once into three bf16 planes [3, Fp, Fp]
//                    (split="pre");
//   B                the operand split into bf16 "panels": for column tile
//                    ct (128 columns) and k-group kb (8 rows of K), plane p,
//                    16 core matrices of 8 columns x 8 k, each 8 rows of
//                    16 bytes (column n, k contiguous).  A BK-deep stage of
//                    one column tile is one contiguous 24 KB run; in shared
//                    memory it is the K-major, no-swizzle layout that
//                    `wgmma` reads through a matrix descriptor.
//   one plane        (plane_product_block) B as above with plane 0 alone,
//                    [np/128][Fp/8][16][8][8], and A = M's bf16 plane in
//                    the same layout with row tiles for column tiles
//                    (A[m][k] at [m/128][k/8][m%128/8][m%8][k%8]), made
//                    once per matrix (ops/den_scan.py `ScanPlane`).
// TRANS reads A = M^T from the one stored M (or planes): the tile loader
// copies rows of M (k) and the fragment loads transpose, with no
// transposed copy of M anywhere.
//
// Block: two warpgroups (256 threads), BM = 128 rows x BN = 128 columns;
// warpgroup w owns rows 64w..64w+63 and issues m64n128k16 `wgmma`s with A
// from registers and B from shared memory.  Loads run STAGES deep, A by
// cp.async and B by one bulk copy per stage, so the copy of stage i + 3
// overlaps the products of stage i.
// K is split into S slices (blockIdx.z) so that the grid covers the SMs;
// every slice writes its fp32 partial tile to a workspace, and the
// caller's next launch adds the S partials in slice order (den_matmul.cu,
// den_scan.cu).  No float atomics: repeated calls are bit-identical.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace den_mma {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;      // output rows per block (two warpgroups)
constexpr int BN = 128;      // output columns per block (one n128 wgmma)
constexpr int BK = 32;       // K depth of one pipeline stage (two k16 steps)
constexpr int STAGES = 4;    // shared-memory ring depth
constexpr int NT = 256;      // threads per block
constexpr int CORE = 64;     // bf16 per 8 x 8 core matrix
constexpr int PLANE_KB = (BN / 8) * CORE;      // bf16 per (plane, k-group)
constexpr int PANEL = 3 * PLANE_KB;            // bf16 per (tile, k-group)
constexpr int B_BYTES = (BK / 8) * PANEL * 2;  // bytes of B per stage
// wgmma descriptor strides of the B stage, in bytes: the next core matrix
// along K is one (k-group) panel on, along N the next 128-byte block
constexpr int B_K_STRIDE = PANEL * 2;
constexpr int B_N_STRIDE = CORE * 2;

// Shared-memory A tile of one stage.  The pitches keep the fragment loads
// free of bank conflicts and every row 16-byte aligned for cp.async.
template <bool TRANS, bool PRE> struct ATile;
template <> struct ATile<false, false> {        // fp32 [BM][BK + 8]
  static constexpr int PITCH = BK + 8, BYTES = BM * PITCH * 4;
};
template <> struct ATile<true, false> {         // fp32 [BK][BM + 4]
  static constexpr int PITCH = BM + 4, BYTES = BK * PITCH * 4;
};
template <> struct ATile<false, true> {         // bf16 [3][BM][BK + 8]
  static constexpr int PITCH = BK + 8, PLANE = BM * PITCH,
                       BYTES = 3 * PLANE * 2;
};
template <> struct ATile<true, true> {          // bf16 [3][BK][BM + 8]
  static constexpr int PITCH = BM + 8, PLANE = BK * PITCH,
                       BYTES = 3 * PLANE * 2;
};

template <bool TRANS, bool PRE>
__host__ __device__ constexpr int stage_bytes() {
  return ATile<TRANS, PRE>::BYTES + B_BYTES;
}
template <bool TRANS, bool PRE>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<TRANS, PRE>();
}


struct Operands {
  const void* A;       // fp32 M [Fp, Fp], bf16 planes [3, Fp, Fp], or
                       // one bf16 plane in panels (plane_product_block)
  const bf16* B;       // panels of the [Fp, np] operand
  float* ws;           // out: [S, Fp, np] slice partials
  int Fp;              // padded size, a multiple of BM
  int S;               // K slices, 1 <= S <= Fp / BK
};

// ---- small device helpers ---------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The B tile of a stage arrives by one bulk copy (the TMA engine), which
// signals an mbarrier in shared memory with the bytes it wrote.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// The one arrival of a stage's barrier phase, announcing the bytes that
// the phase's bulk copies will write.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  expect_bytes(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}
// Wait until the barrier's phase of parity `parity` has completed.  A copy
// that never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (spins > (1ll << 30)) __trap();
  }
}

// Wait until the launch before this one has finished and its writes are
// visible.  The one-plane scans launch each frame kernel as a programmatic
// dependent of the one before it (den_scan.cu `launch`): its blocks may
// start while that one drains, and wait here before their first read.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) -> three bf16 pairs, x in the low half: h0 = bf16(x), h1 =
// bf16(x - h0), h2 = bf16(x - h0 - h1).  Each difference is exact in fp32.
__device__ __forceinline__ void split3(float x, float y, uint32_t& h0,
                                       uint32_t& h1, uint32_t& h2) {
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(b0), ry = y - __high2float(b0);
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(rx - __low2float(b1),
                                                  ry - __high2float(b1));
  h0 = bits(b0);
  h1 = bits(b1);
  h2 = bits(b2);
}

// Split x[0..7] = B(kb*8 + j, n) and store it as one 16-byte core-matrix
// row in each of the three planes of the panels (KB = Fp / 8 k-groups).
__device__ __forceinline__ void store_split8(bf16* __restrict__ panels,
                                             int kb, int n, int KB,
                                             const float (&x)[8]) {
  uint32_t w[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    split3(x[2 * j], x[2 * j + 1], w[0][j], w[1][j], w[2][j]);
  const int ct = n / BN, nl = n % BN;
  const size_t base = ((size_t)(ct * KB + kb) * 3 * (BN / 8) + nl / 8) * CORE
                      + (nl % 8) * 8;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint4*>(panels + base + (size_t)p * PLANE_KB) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

// Store x[0..7] = B(kb*8 + j, n) rounded to bf16 (to nearest even: plane 0
// of `split3`) as one 16-byte core-matrix row of the one-plane panels
// [Fp/BN][KB][16][8][8] that `plane_product_block` reads.
__device__ __forceinline__ void store_plane8(bf16* __restrict__ panels,
                                             int kb, int n, int KB,
                                             const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = bits(__floats2bfloat162_rn(x[2 * j], x[2 * j + 1]));
  const int ct = n / BN, nl = n % BN;
  *reinterpret_cast<uint4*>(
      panels + ((size_t)(ct * KB + kb) * (BN / 8) + nl / 8) * CORE
      + (nl % 8) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// ---- the product ------------------------------------------------------

// Copy stage `ks` (K rows ks*BK ..) of the block's A rows and B columns.
template <bool TRANS, bool PRE>
__device__ __forceinline__ void load_stage(char* st, const Operands& op,
                                           int row0, int ct, int ks,
                                           uint64_t* bar) {
  using AT = ATile<TRANS, PRE>;
  const int tid = threadIdx.x;
  const int k0 = ks * BK;
  const int Fp = op.Fp;
  if constexpr (!PRE) {
    const float* M = static_cast<const float*>(op.A);
    float* As = reinterpret_cast<float*>(st);
#pragma unroll
    for (int it = 0; it < BM * BK / 4 / NT; ++it) {
      const int q = tid + it * NT;
      if constexpr (!TRANS) {   // BM rows of M, BK / 4 chunks each
        const int r = q / (BK / 4), c = q % (BK / 4);
        cp16(As + r * AT::PITCH + c * 4, M + (size_t)(row0 + r) * Fp + k0 + c * 4);
      } else {               // BK rows of M (k), BM / 4 chunks each
        const int r = q / (BM / 4), c = q % (BM / 4);
        cp16(As + r * AT::PITCH + c * 4, M + (size_t)(k0 + r) * Fp + row0 + c * 4);
      }
    }
  } else {
    const bf16* P = static_cast<const bf16*>(op.A);
    bf16* As = reinterpret_cast<bf16*>(st);
    const size_t plane = (size_t)Fp * Fp;
    constexpr int PER_PLANE = BM * BK / 8;   // 16-byte chunks per plane
#pragma unroll
    for (int it = 0; it < 3 * PER_PLANE / NT; ++it) {
      const int q = tid + it * NT;
      const int p = q / PER_PLANE, w = q % PER_PLANE;
      if constexpr (!TRANS) {
        const int r = w / (BK / 8), c = w % (BK / 8);
        cp16(As + p * AT::PLANE + r * AT::PITCH + c * 8,
             P + p * plane + (size_t)(row0 + r) * Fp + k0 + c * 8);
      } else {
        const int r = w / (BM / 8), c = w % (BM / 8);
        cp16(As + p * AT::PLANE + r * AT::PITCH + c * 8,
             P + p * plane + (size_t)(k0 + r) * Fp + row0 + c * 8);
      }
    }
  }
  if (tid == 0)
    bulk_load(st + AT::BYTES,
              op.B + ((size_t)ct * (Fp / 8) + (size_t)ks * (BK / 8)) * PANEL,
              B_BYTES, bar);
}

// The warp's A fragments (rows R..R+15 of the tile, k = kk..kk+15) in the
// m16n8k16 / wgmma register layout: a[p][q] holds plane p's pair at
// (row g + 8*(q&1), k 2t + 8*(q>>1)), g = lane / 4, t = lane % 4.
template <bool TRANS, bool PRE>
__device__ __forceinline__ void load_a(const char* st, int R, int kk,
                                       uint32_t (&a)[3][4]) {
  using AT = ATile<TRANS, PRE>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (!PRE) {
    const float* As = reinterpret_cast<const float*>(st);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = R + g + (q & 1) * 8, k = kk + 2 * t + (q >> 1) * 8;
      float x, y;
      if constexpr (!TRANS) {
        const float2 v = *reinterpret_cast<const float2*>(As + r * AT::PITCH + k);
        x = v.x;
        y = v.y;
      } else {
        x = As[k * AT::PITCH + r];
        y = As[(k + 1) * AT::PITCH + r];
      }
      split3(x, y, a[0][q], a[1][q], a[2][q]);
    }
  } else {
    const bf16* As = reinterpret_cast<const bf16*>(st);
    // lane supplies row (lane & 7) of matrix q = lane >> 3
    const int hi_row = (lane >> 3) & 1, hi_k = (lane >> 4) & 1;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if constexpr (TRANS)
        ldmatrix_x4(a[p], As + p * AT::PLANE
                    + (kk + hi_k * 8 + (lane & 7)) * AT::PITCH + R + hi_row * 8,
                    true);
      else
        ldmatrix_x4(a[p], As + p * AT::PLANE
                    + (R + hi_row * 8 + (lane & 7)) * AT::PITCH + kk + hi_k * 8,
                    false);
    }
  }
}

// No-swizzle K-major matrix descriptor of a B core-matrix block: start
// address, leading-dimension byte offset (between core matrices along K)
// and stride-dimension byte offset (along N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const char* p, int k_stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(k_stride >> 4) << 16)
         | ((uint64_t)(B_N_STRIDE >> 4) << 32);
}
__device__ __forceinline__ uint64_t b_desc(const char* p) {
  return smem_desc(p, B_K_STRIDE);
}

// d (+)= A (64 x 16, registers) @ B (16 x 128, shared memory).
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// One stage: issue part = sum over its two k16 steps of the TERMS cross
// products, the small ones first and m0b0 last.  The first product of the
// stage overwrites part (accumulate 0): part still holds the previous
// stage's sum, already added into the total.  At TERMS = 1 that first
// product is m0b0 itself.  Asynchronous: part and a stay in use until
// wgmma_wait_stage.
template <int TERMS>
__device__ __forceinline__ void issue_products(float (&part)[64],
                                               uint32_t (&a)[2][3][4],
                                               const char* bs) {
  static_assert(TERMS == 1 || TERMS == 3 || TERMS == 6, "TERMS: 1, 3 or 6");
  // (A plane, B plane) of correction product c: m1b0 m0b1 m1b1 m2b0 m0b2
  constexpr int NC = TERMS == 6 ? 5 : TERMS == 3 ? 2 : 0;
#define CM(c) ((c) == 0 ? 1 : (c) == 1 ? 0 : (c) == 2 ? 1 : (c) == 3 ? 2 : 0)
#define CB(c) ((c) == 0 ? 0 : (c) == 1 ? 1 : (c) == 2 ? 1 : (c) == 3 ? 0 : 2)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  int acc = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wgmma_128(part, a[j][CM(c)], b_desc(bs + (2 * j * 3 + CB(c)) * PLANE_KB * 2),
                acc);
      acc = 1;
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wgmma_128(part, a[j][0], b_desc(bs + 2 * j * 3 * PLANE_KB * 2), acc);
    acc = 1;
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#undef CM
#undef CB
}

// Wait for the stage issued last; part then holds its sum, and a is free.
__device__ __forceinline__ void wgmma_wait_stage(float (&part)[64],
                                                 uint32_t (&a)[2][3][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(part[i]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_reg(a[j][p][q]);
}

// Thread (warp w of warpgroup wg, lane 4g + t) holds, for i in 0..15,
// h, e in {0, 1}, the value of tile row frag_row(h), tile column
// frag_col(i, e) in v[4i + 2h + e].
__device__ __forceinline__ int frag_row(int h) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  return wg * 64 + w * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_col(int i, int e) {
  return 8 * i + 2 * (threadIdx.x & 3) + e;
}

// The block's fp32 tile acc (row tile blockIdx.x, column tile blockIdx.y)
// into its K slice's partial ws[blockIdx.z].
__device__ __forceinline__ void store_partial(const Operands& op,
                                              const float (&acc)[64]) {
  const int np = gridDim.y * BN;
  const int row0 = blockIdx.x * BM, ct = blockIdx.y;
  float* mine = op.ws + (size_t)blockIdx.z * op.Fp * np;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(mine + (size_t)(row0 + frag_row(h)) * np +
                                 ct * BN + frag_col(i, 0)) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// The whole block: the product of row tile blockIdx.x, column tile
// blockIdx.y over K slice blockIdx.z, written to ws[blockIdx.z].
template <bool TRANS, bool PRE, int TERMS>
__device__ __forceinline__ void product_block(const Operands& op) {
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t bars[STAGES];   // B tile of each buffer landed
  constexpr int SB = stage_bytes<TRANS, PRE>();
  const int row0 = blockIdx.x * BM, ct = blockIdx.y, s = blockIdx.z;
  const int ksteps = op.Fp / BK;
  const int ks0 = (int)((long long)s * ksteps / op.S);
  const int nk = (int)((long long)(s + 1) * ksteps / op.S) - ks0;
  const int R = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk)
      load_stage<TRANS, PRE>(smem + i * SB, op, row0, ct, ks0 + i, bars + i);
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    // A by cp.async (this thread's part of it), B by the bulk copy; the
    // barrier then makes all of A visible and frees the buffer read at
    // it - 1 for the refill
    cp_wait<STAGES - 2>();
    mbar_wait(bars + it % STAGES, (it / STAGES) & 1);
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < nk)
      load_stage<TRANS, PRE>(smem + (nx % STAGES) * SB, op, row0, ct,
                             ks0 + nx, bars + nx % STAGES);
    cp_commit();
    const char* st = smem + (it % STAGES) * SB;
    uint32_t a[2][3][4];
    load_a<TRANS, PRE>(st, R, 0, a[0]);
    load_a<TRANS, PRE>(st, R, 16, a[1]);
    issue_products<TERMS>(part, a, st + ATile<TRANS, PRE>::BYTES);
    wgmma_wait_stage(part, a);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_wait<0>();
  store_partial(op, acc);
}

// ---- the one-plane product (TERMS = 1) ---------------------------------
//
// The fast den's product m0b0 reads one bf16 plane of each operand and
// nothing else.  A is M's plane (M^T forward, M backward), laid out once
// per matrix in B's K-major no-swizzle core-matrix panels,
// [Fp/BM][Fp/8][16][8][8], so that a stage of A, like one of B, is one
// contiguous 8 KB run: both arrive by bulk copies on the stage's mbarrier,
// STAGES1 deep (16 KB a stage, 128 KB in all, against `product_block`'s
// 4 x 40 KB at TERMS = 1; 4 and 12 stages timed the same on an H100, as
// did two partials overlapping one stage's add with the next one's
// wgmma; an L2 evict_last policy on A's copies did not keep the plane in
// L2 -- tools/ablate_den_scan.py).  The A fragments come to registers by ldmatrix and each k16 step is the
// same m64n128k16 wgmma, on the same register operands and the same B
// values, as `product_block<.., .., 1>`: into the stage's fresh partial,
// which is added into the fp32 total in stage order.  So this route and
// the three-plane TERMS = 1 route give the same bits.
constexpr int STAGES1 = 8;                       // ring depth
constexpr int TILE1 = (BK / 8) * PLANE_KB * 2;   // bytes of A or B per stage
constexpr int SMEM1 = STAGES1 * 2 * TILE1;       // 128 KB
constexpr int B1_K_STRIDE = PLANE_KB * 2;        // next k-group, in bytes
static_assert(BM == BN, "A and B stages share the panel layout");

__device__ __forceinline__ void plane_product_block(const Operands& op) {
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t bars[STAGES1];   // A and B of each buffer landed
  const int s = blockIdx.z;
  const int ksteps = op.Fp / BK, KB = op.Fp / 8;
  const int ks0 = (int)((long long)s * ksteps / op.S);
  const int nk = (int)((long long)(s + 1) * ksteps / op.S) - ks0;
  // the slice's first stage of the block's A rows and B columns; stage i
  // is TILE1 bytes on from stage i - 1 in both
  const char* A = reinterpret_cast<const char*>(
      static_cast<const bf16*>(op.A)
      + ((size_t)blockIdx.x * KB + (size_t)ks0 * (BK / 8)) * PLANE_KB);
  const char* B = reinterpret_cast<const char*>(
      op.B + ((size_t)blockIdx.y * KB + (size_t)ks0 * (BK / 8)) * PLANE_KB);
  // this lane's row address for ldmatrix matrix q = lane / 8 of the warp's
  // k16 step: rows R + 8 (q & 1), the next k-group for q >= 2
  const int lane = threadIdx.x & 31;
  const int R = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const int a_off = ((((lane >> 4) & 1) * (BM / 8) + R / 8 + ((lane >> 3) & 1))
                     * CORE + (lane & 7) * 8) * 2;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES1; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  wait_prior_grid();                  // the operand launch's panels
  auto load = [&](int i) {            // stage i into buffer i % STAGES1
    char* st = smem + (i % STAGES1) * 2 * TILE1;
    uint64_t* bar = bars + i % STAGES1;
    expect_bytes(bar, 2 * TILE1);
    bulk_copy(st, A + (size_t)i * TILE1, TILE1, bar);
    bulk_copy(st + TILE1, B + (size_t)i * TILE1, TILE1, bar);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES1 && i < nk; ++i) load(i);
  for (int it = 0; it < nk; ++it) {
    mbar_wait(bars + it % STAGES1, (it / STAGES1) & 1);
    const char* st = smem + (it % STAGES1) * 2 * TILE1;
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)          // k16 step j: k-groups 2j, 2j + 1
      ldmatrix_x4(a[j], st + a_off + j * 2 * PLANE_KB * 2, false);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_128(part, a[j],
                smem_desc(st + TILE1 + j * 2 * PLANE_KB * 2, B1_K_STRIDE), j);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(part[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_reg(a[j][q]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    // every warp is done with this buffer: refill it
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES1 < nk) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(it + STAGES1);
    }
  }
  store_partial(op, acc);
}

// The product for rows r, column c: sum of the S slice partials, in order.
__device__ __forceinline__ float slice_sum(const float* __restrict__ ws,
                                           int S, size_t slice, size_t o) {
  float v = ws[o];
  for (int s = 1; s < S; ++s) v += ws[s * slice + o];
  return v;
}

// K slices for a grid of (Fp / BM) x (np / BN) tiles on the current
// device: as many as fill its SMs once, each at least 8 stages deep.
inline int choose_slices(int Fp, int np) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (Fp / BM) * (np / BN);
  int S = sms / (tiles > 0 ? tiles : 1);
  if (S > Fp / BK / 8) S = Fp / BK / 8;
  return S < 1 ? 1 : S;
}

}  // namespace den_mma
