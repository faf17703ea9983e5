// Semiring matrix product C = A (x) B for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/semiring.py
// (_semiring_kernel, _pallas_matmul, semiring_matmul): a tiled product with
// an optional leading batch dimension in three semirings,
//   count   : C = min(A @ B, sat) in f32;
//   bool    : OR_k (a_ik AND b_kj);
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
// The tile products live in semiring_common.cuh, shared with the
// block-sparse kernel (sparse.cu).
//
// bool.  What bounds it on the H100: bytes.  The main path multiplies
// (L, 722, 722) x (L, 722, 722) byte stacks; at the card's int8 tensor
// rate the 2 L N^3 operations take less time than moving the 3 L N^2
// bytes once.  What the design does about it: the operands are read once
// each and packed to bits along K (A by rows with one warp ballot per
// 32-wide word, B by columns), so a 722-wide K is 23 words; the product
// then ANDs and ORs 32-bit words, 4x4 outputs per thread from a 64x64
// tile whose packed rows and columns are staged through shared memory.
// The packed operands (1/8 of the bytes) stay in L2 across tiles.
//
// count.  What bounds it: operations, 2 M K N at 67 TFLOP/s (the fp64
// tensor cores' peak, equal to f32's on the CUDA cores).  The path's
// count calls are single 722^2 products (walk counts of sf(q=19)), which
// as 64x64 tiles give the card 144 blocks for 132 SMs: too few to hide
// latency.  What the design does about it: the sums are exact (fp64
// tensor cores, mma.sync m16n8k8; see semiring_common.cuh), so the order
// of the K reduction is free, and K is split across blocks.  Each 128-
// thread block owns a 64x64 output tile and a share of K (the split and
// the share, `chunk`, are semiring.py's count_split of the shapes: three
// blocks fit an SM, and the split fills one wave of them); with split > 1
// it writes its fp64 partial sums to scratch, and a second pass adds the
// partials of each output in split order, rounds once and saturates.  No
// atomics: two launches give the same bits.
//
// minplus.  What bounds it: operations (2 M K N at the f32 rate; no
// tensor-core form).  The ksp scheme's calls are (8, 722, 722) squarings,
// 8 x 144 blocks of 64x64, enough to fill the card.  Each block runs the
// shared register-tiled (min, +) product over all of K: 8x4 outputs a
// thread, 32 K entries a step through a three-stage cp.async ring.
// Out-of-range rows, columns and K entries are the identity (+inf).
//
// In all three, the batch rides on gridDim.z, with a zero batch stride
// for a 2-D operand.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "semiring_common.cuh"

namespace {

enum Mode { kCount = 0, kMinPlus = 2 };  // ids of semiring.py's _MODE

constexpr int kCountBM = 64;   // the dense count product's tile rows

// ---- count: exact fp64 sums, K split across blocks -------------------------

// Block (x, y, z): output tile (y, x) of batch entry z / split, over K
// entries [s chunk, (s + 1) chunk) with s = z % split.  With split 1 it
// writes the outputs; otherwise its fp64 partial sums into part (split,
// batch, m, n), which count_reduce adds.
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, double* __restrict__ part, int m, int k,
             int n, long long stride_a, long long stride_b, int split,
             int chunk, float sat, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int batch = blockIdx.z / split, s = blockIdx.z % split;
  const int batches = gridDim.z / split;
  a += batch * stride_a;
  b += batch * stride_b;
  const long long mn = static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * kCountBM, col0 = blockIdx.x * kCountBN;
  CountAcc<kCountBM> acc = {};
  const KRange walk{s * chunk, min(k, (s + 1) * chunk)};
  count_tile<kCountBM>(a, b, m, k, n, row0, col0, walk, vec, smem, acc);
  if (split == 1) {
    float* out = c + batch * mn;
    count_outputs<kCountBM>(m, n, row0, col0, acc,
                            [&](int r, int col, double v) {
                              out[static_cast<long long>(r) * n + col] =
                                  count_value(v, sat);
                            });
  } else {
    double* out = part + (static_cast<long long>(s) * batches + batch) * mn;
    count_outputs<kCountBM>(m, n, row0, col0, acc,
                            [&](int r, int col, double v) {
                              out[static_cast<long long>(r) * n + col] = v;
                            });
  }
}

// c[i] = min((float) sum_s part[s][i], sat), the partials added in split
// order.
__global__ void count_reduce(const double* __restrict__ part,
                             float* __restrict__ c, long long size,
                             int split, float sat) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  double sum = part[i];
  for (int s = 1; s < split; ++s) sum += part[s * size + i];
  c[i] = count_value(sum, sat);
}

// ---- minplus: the shared register-tiled product over all of K -------------

template <class T>
__global__ void __launch_bounds__(T::kThreads)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int k, int n,
               long long stride_a, long long stride_b, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * T::kBM, col0 = blockIdx.x * T::kBN;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = INFINITY;
  minplus_tile<T>(a, b, m, k, n, row0, col0, KRange{0, k}, vec, smem, acc);
  minplus_store<T>(c, m, n, row0, col0, acc);
}

template <class T>
int launch_minplus(const float* a, const float* b, float* c, int batch,
                   int m, int k, int n, long long stride_a,
                   long long stride_b, cudaStream_t s) {
  const dim3 grid((n + T::kBN - 1) / T::kBN, (m + T::kBM - 1) / T::kBM,
                  batch);
  return launch_dynamic(minplus_kernel<T>, grid, T::kThreads, T::kSmem, s, a,
                        b, c, m, k, n, stride_a, stride_b,
                        copy_vec(a, b, k, n, k));
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
// broadcasts one matrix); the output is a dense (batch, m, n).  count
// splits K into `split` shares of `chunk` entries (a multiple of 32,
// split = ceil(k / chunk)); with split > 1, part is scratch for split *
// batch * m * n doubles (else unused).  minplus ignores split, chunk and
// part.  Returns cudaGetLastError() (or the error of raising a block's
// shared memory limit).
int semiring_launch(int mode, const void* a, const void* b, void* c,
                    void* part, int batch, int m, int k, int n,
                    long long stride_a, long long stride_b, int split,
                    int chunk, float sat, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  switch (mode) {
    case kCount: {
      if (split < 1 || chunk < 1 || chunk % kStep != 0 ||
          static_cast<long long>(split - 1) * chunk >= k ||
          static_cast<long long>(split) * chunk < k ||
          static_cast<long long>(batch) * split > 65535 ||
          (split > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid((n + kCountBN - 1) / kCountBN,
                      (m + kCountBM - 1) / kCountBM, batch * split);
      double* pp = static_cast<double*>(part);
      const int err = launch_dynamic(
          count_kernel, grid, kCountThreads, CountRing<kCountBM>::kSmem, s,
          fa, fb, fc, pp, m, k, n, stride_a, stride_b, split, chunk, sat,
          copy_vec(fa, fb, k, n, chunk));
      if (err != 0 || split == 1) return err;
      const long long size = static_cast<long long>(batch) * m * n;
      count_reduce<<<blocks_for(size, 256), 256, 0, s>>>(pp, fc, size, split,
                                                         sat);
      return static_cast<int>(cudaGetLastError());
    }
    case kMinPlus:
      if (wide_tiles(batch, m, n))
        return launch_minplus<MinPlusWide>(fa, fb, fc, batch, m, k, n,
                                           stride_a, stride_b, s);
      return launch_minplus<MinPlusNarrow>(fa, fb, fc, batch, m, k, n,
                                           stride_a, stride_b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
