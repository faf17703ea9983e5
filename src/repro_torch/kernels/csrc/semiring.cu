// Semiring matrix product C = A (x) B for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/semiring.py
// (_semiring_kernel, _pallas_matmul, semiring_matmul): a tiled product with
// an optional leading batch dimension in three semirings,
//   count   : C = min(A @ B, sat) in f32;
//   bool    : OR_k (a_ik AND b_kj);
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
// The count and minplus tile products and the bool packing live in
// semiring_common.cuh, shared with the block-sparse kernel (sparse.cu).
//
// bool.  What bounds it on the H100: bytes, if its products ran at the
// int8 tensor rate.  The main path multiplies (L, 722, 722) x (L, 722,
// 722) byte stacks.  Two launches a call.  One packs both operands to bits
// along K (A by rows with one warp ballot a 32-wide word, B by columns),
// so a 722-wide K is 23 words and the packed operands (1/8 of the bytes)
// stay in L2 across tiles.  The other runs the product on the tensor
// cores' single-bit form, mma.sync m16n8k256 .and.popc: each output sums
// popc(a AND b) over K and is true where the sum is not zero.  Its 64x64
// tiles copy their words with cp.async, every copy in flight at once, and
// step only through the words K has.  Its time at the path's shapes is
// not the products' (an AND/OR product on the CUDA cores took about as
// long at K 722); what binds it is not measured.  (A one-launch product of
// the bytes on the int8 tensor cores was built and timed slower at every
// path shape: staging the unaligned byte rows bound it.)
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

// ---- bool: bit-packed along K (packed by semiring_common.cuh) ------------

// The dense product's stage of one 64x64 output tile, in packed words:
// A's rows with their words contiguous, B's words with their columns
// contiguous.  The pads put the eight rows (A) or the four words (B) a
// fragment load spans in different banks.
struct BoolDenseStage {
  uint32_t as[kBoolTile][kWords + 4];
  uint32_t bs[kWords][kBoolTile + 8];
};

// d += popc(a AND b) over 256 K entries: one m16n8k256 product of packed
// bits on the tensor cores.  a holds rows (g, g + 8) x K bits [32 t, 32 t
// + 32) and [128 + 32 t, ...), b the same K bits of column g, with g =
// lane / 4 and t = lane % 4; d holds rows (g, g + 8) x columns (2 t, 2 t
// + 1).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One packed word, global to shared, or zero where `live` is false.
__device__ __forceinline__ void stage_word(uint32_t* dst, const uint32_t* src,
                                           bool live) {
  if (live)
    cp_async<1>(reinterpret_cast<float*>(dst),
                reinterpret_cast<const float*>(src));
  else
    *dst = 0u;
}

constexpr int kBoolThreads = 256;  // eight warps: 4 along M, 2 along N
constexpr int kBoolMinBlocks = 4;  // blocks resident an SM (registers)
constexpr int kBoolWarpN = 32;     // output columns of a warp (4 n8 tiles)

// C[r, c] = (sum_w popc(ap[r, w] & bp[w, c])) != 0 for one (batch) of the
// product.  Warp v owns rows 16 (v % 4) and columns 32 (v / 4) of the
// 64x64 tile: four m16n8k256 products a 256-entry K step.  A pass copies
// up to 32 words of each operand with cp.async (zeros past the pass's
// count), all in flight at once, then steps through the words the pass
// holds, rounded up to eight.  A count is at most K, so no sum wraps.
__global__ void __launch_bounds__(kBoolThreads, kBoolMinBlocks)
bool_product(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
             uint8_t* __restrict__ c, int m, int n, int kw,
             long long stride_ap, long long stride_bp) {
  __shared__ __align__(16) BoolDenseStage st;
  const long long batch = blockIdx.z;
  ap += batch * stride_ap;
  bp += batch * stride_bp;
  c += batch * static_cast<long long>(m) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % 4), wc = kBoolWarpN * (warp / 4);
  const int row0 = blockIdx.y * kBoolTile;
  const int col0 = blockIdx.x * kBoolTile;
  int acc[kBoolWarpN / 8][4] = {};
  for (int w0 = 0; w0 < kw; w0 += kWords) {
    const int count = min(kWords, kw - w0);
#pragma unroll
    for (int j = 0; j < kBoolTile * kWords / kBoolThreads; ++j) {
      const int e = tid + kBoolThreads * j;
      const int r = e / kWords, i = e % kWords;
      stage_word(&st.as[r][i], ap + static_cast<long long>(row0 + r) * kw +
                                   w0 + i,
                 row0 + r < m && i < count);
    }
#pragma unroll
    for (int j = 0; j < kWords * kBoolTile / kBoolThreads; ++j) {
      const int e = tid + kBoolThreads * j;
      const int i = e / kBoolTile, cb = e % kBoolTile;
      stage_word(&st.bs[i][cb], bp + static_cast<long long>(w0 + i) * n +
                                    col0 + cb,
                 i < count && col0 + cb < n);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int ks = 0; ks < count; ks += 8) {
      const uint32_t a[4] = {st.as[wr + g][ks + t], st.as[wr + g + 8][ks + t],
                             st.as[wr + g][ks + 4 + t],
                             st.as[wr + g + 8][ks + 4 + t]};
#pragma unroll
      for (int nt = 0; nt < kBoolWarpN / 8; ++nt) {
        const int col = wc + 8 * nt + g;
        mma_and_popc(acc[nt], a, st.bs[ks + t][col], st.bs[ks + 4 + t][col]);
      }
    }
    __syncthreads();
  }
  // Each thread's two adjacent outputs of a row in one store where the
  // pair is whole and aligned.
#pragma unroll
  for (int nt = 0; nt < kBoolWarpN / 8; ++nt) {
    const int gc = col0 + wc + 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wr + g + 8 * h;
      if (gr >= m || gc >= n) continue;
      uint8_t* out = c + static_cast<long long>(gr) * n + gc;
      const uint8_t lo = acc[nt][2 * h] != 0, hi = acc[nt][2 * h + 1] != 0;
      if (gc + 1 < n && (reinterpret_cast<uintptr_t>(out) & 1) == 0) {
        *reinterpret_cast<uint16_t*>(out) =
            static_cast<uint16_t>(lo | (hi << 8));
      } else {
        out[0] = lo;
        if (gc + 1 < n) out[1] = hi;
      }
    }
  }
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
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((n + kBoolTile - 1) / kBoolTile,
                  (m + kBoolTile - 1) / kBoolTile, batch);
  bool_product<<<grid, kBoolThreads, 0, s>>>(
      pa, pb, static_cast<uint8_t*>(c), m, n, kw,
      batch_a == 1 ? 0 : static_cast<long long>(m) * kw,
      batch_b == 1 ? 0 : static_cast<long long>(kw) * n);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
