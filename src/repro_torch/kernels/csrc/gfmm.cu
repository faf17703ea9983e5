// GF(p) matrix product C = (A @ B) mod p for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/gfmm.py (_gfmm_kernel,
// gf_matmul): the product of two matrices over the integers mod p, reduced
// after each K tile so that the sums stay inside the accumulator's type,
// for inputs already reduced to [0, p).  The TPU kernel has two modes
// (int32 on its matrix unit, p = 1009, or f32, p = 251); both return the
// same integers, and this kernel computes both in integers.
//
// What bounds it on the H100: operations.  A 4114^2 product (the Cheung
// propagation matrix of sf(q=11)) is 2 M K N = 1.4e11 operations against
// 3 * 68 MB of int32.  The card can do them exactly on the fp64 tensor
// cores (67 TFLOP/s; sums stay exact while k (p - 1)^2 < 2^53), which is
// the bound: about 2.1 ms.  This kernel runs them as int32 on the CUDA
// cores, a slower route (int8 tensor cores cannot hold residues of
// p = 1009 without splitting them); an fp64 tensor-core kernel is later
// work.
//
// What the design does about it: each 256-thread block owns a 64x64 output
// tile (4x4 outputs a thread, every loaded A and B value reused four
// times) and walks K in 32-wide steps staged through shared memory.  After
// each step the 32 products are added to the residue and reduced mod p.
// 32 (p - 1)^2 + p < 2^31 holds for p <= 8192, so the step sums stay in
// int32; a larger p takes the WIDE instance, which sums in int64.  Rows,
// columns and K entries beyond the edge load 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;
constexpr int kSide = 16;
constexpr int kPer = kTile / kSide;
constexpr int kStep = 32;

template <bool WIDE>
__global__ void __launch_bounds__(kSide * kSide)
gfmm_kernel(const int* __restrict__ a, const int* __restrict__ b,
            int* __restrict__ c, int m, int k, int n, int p) {
  using Acc = typename std::conditional<WIDE, long long, int>::type;
  __shared__ int as[kTile][kStep + 1];
  __shared__ int bs[kStep][kTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  int acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kStep) {
    for (int e = tid; e < kTile * kStep; e += kSide * kSide) {
      const int r = e / kStep, ka = e % kStep;
      const int gr = row0 + r, ga = k0 + ka;
      as[r][ka] = gr < m && ga < k ? a[static_cast<long long>(gr) * k + ga]
                                   : 0;
      const int kb = e / kTile, cb = e % kTile;
      const int gb = k0 + kb, gc = col0 + cb;
      bs[kb][cb] = gb < k && gc < n ? b[static_cast<long long>(gb) * n + gc]
                                    : 0;
    }
    __syncthreads();
    Acc part[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) part[i][j] = 0;
#pragma unroll 8
    for (int kk = 0; kk < kStep; ++kk) {
      Acc bv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) bv[j] = bs[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const Acc av = as[ty + kSide * i][kk];
#pragma unroll
        for (int j = 0; j < kPer; ++j) part[i][j] += av * bv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        acc[i][j] = static_cast<int>((acc[i][j] + part[i][j]) % p);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc < n) c[static_cast<long long>(gr) * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// A (m, k) and B (k, n) row-major int32 with entries in [0, p); C (m, n)
// int32 = (A @ B) mod p.  wide != 0 sums each 32-wide step in int64 (needed
// when 32 (p - 1)^2 + p >= 2^31).  Returns cudaGetLastError().
int gfmm_launch(const void* a, const void* b, void* c, int m, int k, int n,
                int p, int wide, void* stream) {
  if (m < 1 || n < 1 || k < 1 || p < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kSide, kSide);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  const int* ia = static_cast<const int*>(a);
  const int* ib = static_cast<const int*>(b);
  int* ic = static_cast<int*>(c);
  if (wide)
    gfmm_kernel<true><<<grid, block, 0, s>>>(ia, ib, ic, m, k, n, p);
  else
    gfmm_kernel<false><<<grid, block, 0, s>>>(ia, ib, ic, m, k, n, p);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
