// Warp-level bf16 tensor-core helpers shared by flash attention's forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels:
// cp.async 16-byte copies into shared memory, ldmatrix fragment loads and
// the mma.sync m16n8k16 bf16 product with f32 accumulators (Ampere's
// warp-level instructions, which sm_90a runs).
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t4.  A 16 x 16
// A fragment holds a[0] = (row g, cols 2 t4, 2 t4 + 1), a[1] = (row g + 8,
// same cols), a[2] = (row g, cols 2 t4 + 8, + 9), a[3] = (row g + 8, those);
// an accumulator d[0], d[1] = (row g, cols 2 t4, 2 t4 + 1) and d[2], d[3] =
// (row g + 8, the same cols) of its 8 columns.  So the accumulators of two
// neighbouring 8-column tiles, rounded to bf16 in pairs, are the A fragment
// of the 16 x 16 chunk they cover: a product's output feeds the next
// product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into dst, of which the first `bytes` are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.  Not
// volatile: registers only, so the compiler may interleave the products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16 x 16 chunk kc of a 16-row accumulator tile s
// (8-column tiles 2 kc and 2 kc + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(float (&s)[N][4], int kc,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// `rows` rows of a row-major (n_rows, d) bf16 source, from row0 on, into
// dst (row stride LD), DP columns, zeros past n_rows and past d, by the
// block's THREADS threads.  With `vec` (d a multiple of 8, 16-byte aligned
// rows) by cp.async (commit and wait are the caller's), else by plain
// loads and stores.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int n_rows,
                                          int d, bool vec) {
  constexpr int kChunks = DP / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += THREADS) {
    const int r = e / kChunks, c = (e % kChunks) * 8, g = row0 + r;
    bf16* to = dst + r * LD + c;
    const bf16* from = src + static_cast<long long>(g) * d + c;
    const int n = g < n_rows ? max(0, min(8, d - c)) : 0;
    if (vec) {
      cp_async16(to, n ? from : src, 2 * n);
    } else {
      alignas(16) bf16 t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        t[i] = i < n ? from[i] : __float2bfloat16(0.0f);
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(t);
    }
  }
}

}  // namespace mma_bf16
