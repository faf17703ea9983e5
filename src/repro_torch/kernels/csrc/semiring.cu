// Semiring matrix product C = A (x) B for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/semiring.py
// (_semiring_kernel, _pallas_matmul, semiring_matmul): a tiled product with
// an optional leading batch dimension in three semirings,
//   count   : C = min(acc + A@B, sat) in f32, saturating after each K tile;
//   bool    : the count clamped to 1 after each K tile, returned as C > 0.5;
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
//
// bool.  With 0/1 operands the clamped count is exactly OR_k (a_ik AND
// b_kj).  What bounds it on the H100: bytes.  The main path multiplies
// (L, 722, 722) x (L, 722, 722) byte stacks; at the card's int8 tensor
// rate the 2 L N^3 operations take less time than moving the 3 L N^2
// bytes once.  What the design does about it: the operands are read once
// each and packed to bits along K (A by rows with one warp ballot per
// 32-wide word, B by columns), so a 722-wide K is 23 words; the product
// then ANDs and ORs 32-bit words, 4x4 outputs per thread from a 64x64
// tile whose packed rows and columns are staged through shared memory.
// The packed operands (1/8 of the bytes) stay in L2 across tiles.  The
// packing and the staged AND/OR live in semiring_common.cuh, shared with
// the block-sparse kernel.
//
// count and minplus.  What bounds them: operations (2 M K N f32 flops
// against 4 (M K + K N + M N) bytes).  No TF32 and no tensor cores:
// `count` must stay exact below 2^24, and minplus has no tensor-core
// form.  Each 256-thread block owns a 32x32 output tile and walks K in
// 32-wide tiles staged through shared memory (padded rows, so the column
// reads of B and the broadcast reads of A are free of bank conflicts);
// each thread keeps four outputs in registers and reuses every A value it
// loads across them.  Out-of-range rows, columns and K entries load the
// semiring's additive identity (0 or +inf), exactly as the TPU kernel
// pads its operands.
//
// In both, the batch rides on gridDim.z, with a zero batch stride for a
// 2-D operand.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "semiring_common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;                  // threadIdx.y extent
constexpr int kPerThread = kTile / kRows;  // outputs per thread

enum Mode { kCount = 0, kMinPlus = 2 };  // ids of semiring.py's _MODE

template <int MODE>
__global__ void __launch_bounds__(kTile * kRows)
semiring_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int k, int n,
                long long stride_a, long long stride_b, float sat) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const float zero = MODE == kMinPlus ? INFINITY : 0.0f;
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tx;

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = zero;

  for (int k0 = 0; k0 < k; k0 += kTile) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int r = ty + kRows * i;
      const int gr = row0 + r;
      const int ga = k0 + tx;
      as[r][tx] = gr < m && ga < k ? a[static_cast<long long>(gr) * k + ga]
                                   : zero;
      const int gb = k0 + r;
      bs[r][tx] = gb < k && col < n ? b[static_cast<long long>(gb) * n + col]
                                    : zero;
    }
    __syncthreads();
    if (MODE == kMinPlus) {
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const float bv = bs[kk][tx];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          acc[i] = fminf(acc[i], as[ty + kRows * i][kk] + bv);
      }
    } else {
      float part[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) part[i] = 0.0f;
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const float bv = bs[kk][tx];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          part[i] = fmaf(as[ty + kRows * i][kk], bv, part[i]);
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        acc[i] = fminf(acc[i] + part[i], sat);
    }
    __syncthreads();
  }

  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int gr = row0 + ty + kRows * i;
    if (gr < m) c[static_cast<long long>(gr) * n + col] = acc[i];
  }
}

// ---- bool: bit-packed along K (semiring_common.cuh) ----------------------

// C[r, c] = any_w (ap[r, w] & bp[w, c]) for one (batch) of the product.
__global__ void __launch_bounds__(kBoolSide * kBoolSide)
bool_product(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
             uint8_t* __restrict__ c, int m, int n, int kw,
             long long stride_ap, long long stride_bp) {
  __shared__ BoolStage st;
  const long long batch = blockIdx.z;
  ap += batch * stride_ap;
  bp += batch * stride_bp;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * kBoolTile;
  const int col0 = blockIdx.x * kBoolTile;
  uint32_t acc[kBoolPer][kBoolPer] = {};
  for (int w0 = 0; w0 < kw; w0 += kWords)
    bool_pass(ap, bp, m, n, kw, row0, col0, min(kWords, kw - w0),
              [w0](int i) { return w0 + i; }, st, acc);
  bool_store(c, m, n, row0, col0, acc);
}

}  // namespace

extern "C" {

// mode: 0 count, 2 minplus (f32 in, f32 out).  Operands are row-major
// (batch, m, k) and (batch, k, n) with the given batch strides (0
// broadcasts one matrix); the output is a dense (batch, m, n).  Returns
// cudaGetLastError().
int semiring_launch(int mode, const void* a, const void* b, void* c,
                    int batch, int m, int k, int n, long long stride_a,
                    long long stride_b, float sat, void* stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  switch (mode) {
    case kCount:
      semiring_kernel<kCount><<<grid, block, 0, s>>>(
          fa, fb, fc, m, k, n, stride_a, stride_b, sat);
      break;
    case kMinPlus:
      semiring_kernel<kMinPlus><<<grid, block, 0, s>>>(
          fa, fb, fc, m, k, n, stride_a, stride_b, sat);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bool semiring on byte operands (0 or not 0): A (batch_a, m, k) and
// B (batch_b, k, n), each of batch_a, batch_b either 1 (broadcast) or
// batch.  Scratch: ap holds batch_a * m * kw words, bp batch_b * kw * n
// words, kw = ceil(k / 32).  Output: dense (batch, m, n) bytes, 0 or 1.
// Returns cudaGetLastError().
int semiring_bool_launch(const void* a, const void* b, void* c, void* ap,
                         void* bp, int batch, int batch_a, int batch_b,
                         int m, int k, int n, void* stream) {
  if (k < 1 || (batch_a != 1 && batch_a != batch) ||
      (batch_b != 1 && batch_b != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kw = (k + 31) / 32;
  uint32_t* pa = static_cast<uint32_t*>(ap);
  uint32_t* pb = static_cast<uint32_t*>(bp);
  pack_operands(a, b, pa, pb, batch_a, batch_b, m, k, n, s);
  const dim3 block(kBoolSide, kBoolSide);
  const dim3 grid((n + kBoolTile - 1) / kBoolTile,
                  (m + kBoolTile - 1) / kBoolTile, batch);
  bool_product<<<grid, block, 0, s>>>(
      pa, pb, static_cast<uint8_t*>(c), m, n, kw,
      batch_a == 1 ? 0 : static_cast<long long>(m) * kw,
      batch_b == 1 ? 0 : static_cast<long long>(kw) * n);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
