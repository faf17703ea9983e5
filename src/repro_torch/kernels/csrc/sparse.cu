// Block-sparse semiring product C = A (x) B for Hopper (sm_90a), on CUDA
// cores, skipping every tile pair that holds only the additive identity.
//
// Replaces the TPU kernel src/repro/kernels/sparse.py
// (_sparse_semiring_kernel, _pallas_sparse_matmul, sparse_semiring_matmul):
// the semiring product of semiring.py, gated per (bm, bk) x (bk, bn) tile
// pair on two occupancy bitmaps (pl.when(occupied)), in three semirings:
//   count   : C = min(acc + A@B, sat) in f32;
//   bool    : the count clamped to 1, returned as bytes C > 0.5;
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
// Skipping is exact: a skipped pair would add 0 to a count and +inf to a
// min.  The skip decides the time, never the result.
//
// What bounds it on the H100: operations, over the occupied tile pairs
// only (2 M K N f32 operations scaled by the occupied share, against
// 4 (M K + K N + M N) bytes).  No TF32 and no tensor cores: `count` must
// stay exact below 2^24, and minplus has no tensor-core form.
//
// What the design does about it: each 256-thread block owns a 64x64
// output tile (4x4 outputs a thread) and walks the K tiles of the caller's
// occupancy grid.  For each K tile it ORs the occupancy bits of the A
// tiles covering its rows and the B tiles covering its columns; if either
// side is empty, it skips the tile without reading it.  An occupied tile
// is read in 32-wide steps staged through shared memory.  The count and
// bool sums saturate after every 32-wide step, as the port's dense kernel
// (semiring.cu) does, and with a bk that is a multiple of 32 the steps
// fall where the dense kernel's do, so the two agree bitwise on any
// input.  Out-of-range rows, columns and K entries load the identity, so
// a ragged edge needs no padded copy of the operands.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;    // output rows and columns per block
constexpr int kSide = 16;    // threads per block side
constexpr int kPer = kTile / kSide;
constexpr int kStep = 32;    // K entries staged per pass

enum Mode { kCount = 0, kBool = 1, kMinPlus = 2 };  // ids of sparse.py's _MODE

template <int MODE>
struct Elem {
  using T = float;
};
template <>
struct Elem<kBool> {
  using T = uint8_t;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint8_t x) { return x ? 1.0f : 0.0f; }

template <int MODE>
__global__ void __launch_bounds__(kSide * kSide)
sparse_kernel(const typename Elem<MODE>::T* __restrict__ a,
              const typename Elem<MODE>::T* __restrict__ b,
              typename Elem<MODE>::T* __restrict__ c,
              const int* __restrict__ a_occ, const int* __restrict__ b_occ,
              int m, int k, int n, long long stride_a, long long stride_b,
              long long stride_ao, long long stride_bo, int bm, int bn,
              int bk, float sat) {
  __shared__ float as[kTile][kStep + 1];
  __shared__ float bs[kStep][kTile];
  const float zero = MODE == kMinPlus ? INFINITY : 0.0f;
  const float top = MODE == kBool ? 1.0f : sat;
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;
  a_occ += batch * stride_ao;
  b_occ += batch * stride_bo;

  const int kt_n = (k + bk - 1) / bk;
  const int nt_n = (n + bn - 1) / bn;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // Occupancy tiles covering this block's rows and columns.
  const int ti0 = row0 / bm, ti1 = (min(m, row0 + kTile) - 1) / bm;
  const int tj0 = col0 / bn, tj1 = (min(n, col0 + kTile) - 1) / bn;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = zero;

  for (int kt = 0; kt < kt_n; ++kt) {
    // Uniform across the block: every thread reads the same bits.
    int live_a = 0, live_b = 0;
    for (int i = ti0; i <= ti1 && !live_a; ++i)
      live_a = a_occ[static_cast<long long>(i) * kt_n + kt];
    for (int j = tj0; j <= tj1 && !live_b; ++j)
      live_b = b_occ[static_cast<long long>(kt) * nt_n + j];
    if (!live_a || !live_b) continue;
    const int kend = min(k, (kt + 1) * bk);
    for (int k0 = kt * bk; k0 < kend; k0 += kStep) {
      for (int e = tid; e < kTile * kStep; e += kSide * kSide) {
        const int r = e / kStep, ka = e % kStep;
        const int gr = row0 + r, ga = k0 + ka;
        as[r][ka] = gr < m && ga < kend
                        ? to_f(a[static_cast<long long>(gr) * k + ga])
                        : zero;
        const int kb = e / kTile, cb = e % kTile;
        const int gb = k0 + kb, gc = col0 + cb;
        bs[kb][cb] = gb < kend && gc < n
                         ? to_f(b[static_cast<long long>(gb) * n + gc])
                         : zero;
      }
      __syncthreads();
      if constexpr (MODE == kMinPlus) {
#pragma unroll 8
        for (int kk = 0; kk < kStep; ++kk) {
          float bv[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) bv[j] = bs[kk][tx + kSide * j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float av = as[ty + kSide * i][kk];
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              acc[i][j] = fminf(acc[i][j], av + bv[j]);
          }
        }
      } else {
        float part[kPer][kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) part[i][j] = 0.0f;
#pragma unroll 8
        for (int kk = 0; kk < kStep; ++kk) {
          float bv[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) bv[j] = bs[kk][tx + kSide * j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float av = as[ty + kSide * i][kk];
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              part[i][j] = fmaf(av, bv[j], part[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            acc[i][j] = fminf(acc[i][j] + part[i][j], top);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc >= n) continue;
      const long long at = static_cast<long long>(gr) * n + gc;
      if constexpr (MODE == kBool)
        c[at] = acc[i][j] > 0.5f ? 1 : 0;
      else
        c[at] = acc[i][j];
    }
  }
}

template <int MODE>
void launch(const void* a, const void* b, void* c, const void* a_occ,
            const void* b_occ, int batch, int m, int k, int n,
            long long stride_a, long long stride_b, long long stride_ao,
            long long stride_bo, int bm, int bn, int bk, float sat,
            cudaStream_t s) {
  using T = typename Elem<MODE>::T;
  const dim3 block(kSide, kSide);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  sparse_kernel<MODE><<<grid, block, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_occ), static_cast<const int*>(b_occ), m, k, n,
      stride_a, stride_b, stride_ao, stride_bo, bm, bn, bk, sat);
}

}  // namespace

extern "C" {

// mode: 0 count, 1 bool (byte operands and output), 2 minplus (f32).
// A is (batch, m, k) and B (batch, k, n), row-major, with the given batch
// strides (0 broadcasts one matrix).  a_occ is (batch, ceil(m/bm),
// ceil(k/bk)) and b_occ (batch, ceil(k/bk), ceil(n/bn)) int32 occupancy
// bits, with batch strides stride_ao and stride_bo (0 broadcasts).  The
// output is a dense (batch, m, n).  Returns cudaGetLastError().
int sparse_launch(int mode, const void* a, const void* b, void* c,
                  const void* a_occ, const void* b_occ, int batch, int m,
                  int k, int n, long long stride_a, long long stride_b,
                  long long stride_ao, long long stride_bo, int bm, int bn,
                  int bk, float sat, void* stream) {
  if (bm < 1 || bn < 1 || bk < 1 || m < 1 || n < 1 || k < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCount:
      launch<kCount>(a, b, c, a_occ, b_occ, batch, m, k, n, stride_a,
                     stride_b, stride_ao, stride_bo, bm, bn, bk, sat, s);
      break;
    case kBool:
      launch<kBool>(a, b, c, a_occ, b_occ, batch, m, k, n, stride_a,
                    stride_b, stride_ao, stride_bo, bm, bn, bk, sat, s);
      break;
    case kMinPlus:
      launch<kMinPlus>(a, b, c, a_occ, b_occ, batch, m, k, n, stride_a,
                       stride_b, stride_ao, stride_bo, bm, bn, bk, sat, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
