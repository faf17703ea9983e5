// Split-TF32 tensor-core products for K5's f32 kernels: flash attention's
// forward (flash_attention.cu, namespace tf) and backward
// (flash_attention_bwd.cu, namespace tf).  The method of CUTLASS's
// OpMultiplyAddFastF32 (cutlass/gemm/warp/mma_tensor_op_fast_f32.h): each
// f32 operand x is split in registers into a TF32 high part and a TF32
// remainder,
//   hi = rna(x),  lo = rna(x - hi)  (rna: cvt.rna.tf32.f32's rounding),
// and a product a b is three mma.sync m16n8k8 TF32 products with f32
// accumulators, the small terms first: lo(a) hi(b), hi(a) lo(b), hi(a)
// hi(b).  The dropped lo(a) lo(b) and the remainders' rounding leave about
// 2^-21 of each term, against f32's 2^-24: f32 accuracy at the tensor
// cores' rate (three TF32 products at 495 TFLOP/s, about 165 TFLOP/s of f32
// work, against the CUDA cores' 67).
//
// mma.sync rather than wgmma: TF32 wgmma reads its B operand K-major only,
// from shared memory, and PV's V and the backward's dO, Q and K operands are
// MN-major there; each such tile would need a transposed and split copy in
// shared memory, where mma.sync splits a fragment in registers after its
// load.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t4.  A (16 x
// 8, row): a[0] = (row g, col t4), a[1] = (row g + 8, col t4), a[2] = (row
// g, col t4 + 4), a[3] = (row g + 8, col t4 + 4).  B (8 x 8, col): b[0] =
// (row t4, col g), b[1] = (row t4 + 4, col g).  An accumulator (16 x 8):
// c[0], c[1] = (row g, cols 2 t4, 2 t4 + 1), c[2], c[3] = (row g + 8, the
// same cols).
//
// An accumulator is not an A fragment (its lane holds columns 2 t4 and
// 2 t4 + 1, an A fragment t4 and t4 + 4), but a product sums over its
// contraction in any order: taking contraction index t4 as column 2 t4 and
// t4 + 4 as 2 t4 + 1 makes (c[0], c[2], c[1], c[3]) the A fragment, with no
// shuffle, as long as B's rows follow the same order (b[0] from row 2 t4,
// b[1] from row 2 t4 + 1: pair_b).  B's columns are free too: pair_b gives
// the four 8-column tiles h = 0..3 of a 32-column group the columns 4 g + h,
// so that one 16-byte load fetches a lane's B values of all four, and
// accumulator element e of tile h is column 8 t4 + 4 (e & 1) + h of the
// group (acc_col).
//
// Shared tiles of f32 rows with a stride of 4 mod 32 floats (LD = width +
// 4): ldmatrix's eight 16-byte rows, the 8 x 4 scalar reads of pair_b's
// 16-byte loads and a fragment's g x t4 pattern all fall in distinct banks.
// ldmatrix is a b16 instruction, but its 8 x 8 b16 matrix is 8 rows of four
// 32-bit words, and lane 4 g + t4 receives word t4 of row g: the A or B
// fragment element of an 8 x 4 block of f32.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma_tf32 {

using mma_bf16::cp_async16;
using mma_bf16::ldmatrix_x4;

// cvt.rna.tf32.f32 for finite x (round to nearest, ties away from zero):
// add half a TF32 ulp to the bits and clear the 13 bits TF32 drops.  Two
// integer instructions; ptxas compiles the PTX instruction to a sequence
// guarded for NaN and infinity that took about twice the issue slots of
// the kernels' products.  Every value split here is finite (Q, K, V, dO,
// and P and dS after the mask).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// (hi, lo) of x: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Split each of the four values of a fragment (as raw f32 bits).
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: lo(a) hi(b), hi(a) lo(b), then hi(a) hi(b).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment of rows row0..row0 + 15, columns c0..c0 + 7 of an f32
// tile with row stride LD (16-byte aligned rows), split.
template <int LD>
__device__ __forceinline__ void load_a(const float* tile, int row0, int c0,
                                       int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  uint32_t x[4];
  ldmatrix_x4(x, tile + (row0 + (lane & 15)) * LD + c0 + (lane >> 4) * 4);
  split4(x, hi, lo);
}

// The B fragments (contraction along the tile's columns) of the two
// 8-column tiles of rows row0..row0 + 15, columns c0..c0 + 7: b[0], b[1]
// of rows row0..row0 + 7 and b[2], b[3] of the next 8, split.
template <int LD>
__device__ __forceinline__ void load_b2(const float* tile, int row0, int c0,
                                        int lane, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  uint32_t x[4];
  ldmatrix_x4(x, tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
                     ((lane >> 3) & 1) * 4);
  split4(x, hi, lo);
}

// The B fragment of the one 8-column tile of rows row0..row0 + 7, columns
// c0..c0 + 7, split (ldmatrix .x2: lanes 0-15 give the rows' addresses).
template <int LD>
__device__ __forceinline__ void load_b1(const float* tile, int row0, int c0,
                                        int lane, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  uint32_t x[2];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(x[0]), "=r"(x[1])
      : "r"(mma_bf16::smem_u32(tile + (row0 + (lane & 7)) * LD + c0 +
                               ((lane >> 3) & 1) * 4)));
  split(__uint_as_float(x[0]), hi[0], lo[0]);
  split(__uint_as_float(x[1]), hi[1], lo[1]);
}

// The A fragment of an accumulator tile c (16 rows, 8 contraction
// columns), split, in the contraction order of the header.
__device__ __forceinline__ void acc_to_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// B values (contraction along the tile's rows) of the four 8-column tiles
// of group n4 (columns 32 n4..32 n4 + 31) against contraction rows row0..
// row0 + 7, in the header's order: rows row0 + 2 t4 and row0 + 2 t4 + 1,
// columns 32 n4 + 4 g + h, as two 16-byte loads.
template <int LD>
__device__ __forceinline__ void pair_b(const float* tile, int row0, int n4,
                                       int lane, float4& b0, float4& b1) {
  const float* p = tile + (row0 + 2 * (lane & 3)) * LD + 32 * n4 +
                   4 * (lane >> 2);
  b0 = *reinterpret_cast<const float4*>(p);
  b1 = *reinterpret_cast<const float4*>(p + LD);
}

// acc[h] += A B for the four tiles of a pair_b group, A split.
__device__ __forceinline__ void mma3_group(float (&acc)[4][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float4& b0,
                                           const float4& b1) {
  const float x0[4] = {b0.x, b0.y, b0.z, b0.w};
  const float x1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t h0, l0, h1, l1;
    split(x0[h], h0, l0);
    split(x1[h], h1, l1);
    mma3(acc[h], ah, al, h0, h1, l0, l1);
  }
}

// The column, within its 32-column group, of element e of tile h of a
// pair_b product (lane's t4).
__device__ __forceinline__ int acc_col(int t4, int h, int e) {
  return 8 * t4 + 4 * (e & 1) + h;
}

// x[NT] = A B^T for 16 rows (row0..) of tile a against the 8 NT rows of
// tile b, over W columns (both tiles' row stride LDA).
template <int NT, int W, int LDA>
__device__ __forceinline__ void product_t(float (&x)[NT][4], const float* a,
                                          int row0, const float* b,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < W / 8; ++c) {
    uint32_t ah[4], al[4];
    load_a<LDA>(a, row0, 8 * c, lane, ah, al);
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t bh[4], bl[4];
      load_b2<LDA>(b, 16 * j2, 8 * c, lane, bh, bl);
      mma3(x[2 * j2], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(x[2 * j2 + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
    if constexpr (NT % 2 != 0) {
      uint32_t bh[2], bl[2];
      load_b1<LDA>(b, 8 * (NT - 1), 8 * c, lane, bh, bl);
      mma3(x[NT - 1], ah, al, bh[0], bh[1], bl[0], bl[1]);
    }
  }
}

// acc[n] = alpha acc[n] + A B over the contraction tiles kc < KT of A
// (accumulator tiles a, split once) against B's rows 8 kc.. of `tile` (row
// stride LDB), for every 32-column group n < NG of B; alpha_a scales rows
// g, alpha_b rows g + 8.  Each group's product is summed over the KT tiles
// apart and added to acc with one f32 rounding (fmaf), so that no
// tensor-core accumulation runs over more than one tile.
template <int KT, int NG, int LDB>
__device__ __forceinline__ void add_product(float (&acc)[NG][4][4],
                                            const float (&a)[KT][4],
                                            const float* tile, int lane,
                                            float alpha_a = 1.0f,
                                            float alpha_b = 1.0f) {
  uint32_t ah[KT][4], al[KT][4];
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) acc_to_a(a[kc], ah[kc], al[kc]);
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    float t[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      float4 b0, b1;
      pair_b<LDB>(tile, 8 * kc, n, lane, b0, b1);
      mma3_group(t, ah[kc], al[kc], b0, b1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][j][e] = fmaf(acc[n][j][e], e < 2 ? alpha_a : alpha_b, t[j][e]);
  }
}

// `rows` rows of a row-major (n_rows, d) f32 source, from row0 on, into
// dst (row stride LD), DP columns, zeros past n_rows and past d, by the
// block's THREADS threads.  With `vec` (d a multiple of 4, 16-byte aligned
// rows) by cp.async (commit and wait are the caller's), else by plain loads
// and stores.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int n_rows,
                                          int d, bool vec) {
  constexpr int kChunks = DP / 4;
  for (int e = threadIdx.x; e < rows * kChunks; e += THREADS) {
    const int r = e / kChunks, c = (e % kChunks) * 4, g = row0 + r;
    float* to = dst + r * LD + c;
    const float* from = src + static_cast<long long>(g) * d + c;
    const int n = g < n_rows ? max(0, min(4, d - c)) : 0;
    if (vec) {
      cp_async16(to, n ? from : src, 4 * n);
    } else {
      float4 t;
      t.x = n > 0 ? from[0] : 0.0f;
      t.y = n > 1 ? from[1] : 0.0f;
      t.z = n > 2 ? from[2] : 0.0f;
      t.w = n > 3 ? from[3] : 0.0f;
      *reinterpret_cast<float4*>(to) = t;
    }
  }
}

}  // namespace mma_tf32
