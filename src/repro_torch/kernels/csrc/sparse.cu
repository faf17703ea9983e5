// Block-sparse semiring product C = A (x) B for Hopper (sm_90a), skipping
// every tile pair that holds only the additive identity.
//
// Replaces the TPU kernel src/repro/kernels/sparse.py
// (_sparse_semiring_kernel, _pallas_sparse_matmul, sparse_semiring_matmul):
// the semiring product of semiring.py, gated per (bm, bk) x (bk, bn) tile
// pair on two occupancy bitmaps (pl.when(occupied)), in three semirings:
//   count   : C = min(A @ B, sat) in f32, summed exactly in fp64;
//   bool    : OR_k (a_ik AND b_kj) on bool bytes;
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
// Skipping is exact: a skipped pair would add 0 to a count, nothing to an
// OR and +inf to a min.  The skip decides the time, never the result.
//
// What bounds it on the H100: for count and minplus, operations over the
// occupied tile pairs only (2 M K N operations scaled by the occupied
// share, at 67 TFLOP/s: the fp64 tensor cores for count, the f32 CUDA
// cores for minplus, which has no tensor-core form); for bool, bytes (the
// int8 tensor rate would do the operations faster than the operands can
// be read).
//
// What the design does about it.  One call is three steps on the stream:
//
// 1. Occupancy, one pass over both operands (occupancy_kernel): four
//    256-thread blocks per tile of A or of B read the tile once, a warp
//    per row with every load in flight together, and each writes one byte
//    of the tile's int32 bit.  Each product block then evaluates its K
//    tiles' liveness once, in parallel, into bit flags in shared memory,
//    and walks only the live K tiles (Live, a K walk of
//    semiring_common.cuh).
// 2. bool: the operands are packed to bits along K (semiring_common.cuh,
//    shared with the dense kernel), and each 64x64 output block ANDs and
//    ORs the 32-bit words that meet an occupied tile pair of its rows and
//    columns.  A warp gathers those words' indices (ballot, popc) 32 at a
//    time, so a pass stages only live words.  A word whose K range is
//    partly in an empty tile is still exact: its zero bits add nothing,
//    so bk need not be a multiple of 32.
// 3. count: the dense kernel's exact fp64 tile product
//    (semiring_common.cuh: mma.sync m16n8k8 f64 on f32 operands widened
//    as their fragments are read from shared memory), 64x64 tiles of 128
//    threads, or 32x64 when 64x64 would give fewer than four blocks an SM,
//    walked over the live K tiles 32 entries a step through the shared
//    three-stage cp.async ring.  A skipped pair would add exact
//    zeros, and every sum of integer-valued operands is exact, so the
//    result is bitwise the dense kernel's (which splits K instead) on any
//    such input.
//    minplus: the shared register-tiled product (8x4 outputs a thread in
//    64x64 tiles, 4x4 in 32x64 ones, 32 K entries a step through a
//    three-stage cp.async ring), walked over the live K tiles; min is
//    order-free.
//    Out-of-range rows, columns and K entries (and entries past the K
//    tile's end) are the identity, so a ragged edge needs no padded copy
//    of the operands.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "semiring_common.cuh"

namespace {

enum Mode { kCount = 0, kBool = 1, kMinPlus = 2 };  // ids of sparse.py's _MODE

constexpr int kOccThreads = 256;
constexpr int kOccParts = 4;      // blocks per tile, one byte of its bit each

// ---- 1. occupancy ----------------------------------------------------------

// One operand's (batch, rows, cols) tiles of (tr, tc): occ[b, i, j] != 0 iff
// tile (i, j) of batch entry b holds a live entry.
struct OccJob {
  const void* x;
  int* occ;
  int batch, rows, cols, tr, tc, n_tr, n_tc;
  __host__ __device__ int blocks() const { return batch * n_tr * n_tc; }
};

template <int MODE>
__device__ __forceinline__ bool live_at(const void* x, long long i) {
  if constexpr (MODE == kBool) {
    return static_cast<const uint8_t*>(x)[i] != 0;
  } else if constexpr (MODE == kMinPlus) {
    return static_cast<const float*>(x)[i] < INFINITY;
  } else {
    return static_cast<const float*>(x)[i] != 0.0f;
  }
}

// kOccParts blocks per tile: blocks [0, kOccParts a.blocks()) take A's
// tiles, the rest B's.  Part p reads rows p * 8 + warp + 32 i of the tile
// and writes byte p of the tile's int32, so the int is non-zero iff some
// part saw a live entry (no atomics, no zeroing pass).
template <int MODE>
__global__ void __launch_bounds__(kOccThreads)
occupancy_kernel(OccJob a, OccJob b) {
  const int part = blockIdx.x % kOccParts;
  const int blk = blockIdx.x / kOccParts;
  const bool on_a = blk < a.blocks();
  const OccJob job = on_a ? a : b;
  const int t = on_a ? blk : blk - a.blocks();
  const int j = t % job.n_tc;
  const int i = (t / job.n_tc) % job.n_tr;
  const long long bb = t / (job.n_tc * job.n_tr);
  const int r0 = i * job.tr, c0 = j * job.tc;
  const int h = min(job.tr, job.rows - r0), w = min(job.tc, job.cols - c0);
  const long long base = (bb * job.rows + r0) * job.cols + c0;
  // A warp per row, a lane per column; unrolled both ways, so that many
  // independent loads are in flight (no early exit to serialise them).
  constexpr int kWarpsPerBlock = kOccThreads / 32;
  constexpr int kRowStep = kWarpsPerBlock * kOccParts;
  const int lane = threadIdx.x & 31;
  bool live = false;
#pragma unroll 4
  for (int r = part * kWarpsPerBlock + (threadIdx.x >> 5); r < h;
       r += kRowStep) {
    const long long row = base + static_cast<long long>(r) * job.cols;
#pragma unroll 4
    for (int c = lane; c < w; c += 32) live |= live_at<MODE>(job.x, row + c);
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0)
    reinterpret_cast<uint8_t*>(job.occ + t)[part] = live ? 1 : 0;
}

// ---- shared by the products: which K tiles meet an occupied pair -----------

constexpr int kFlagWords = 64;   // words of K-tile flags in shared memory

// The occupancy grid as one output block of rows [row0, row0 + rows_blk)
// and columns [col0, col0 + cols_blk) sees it: K tile kt is live when an
// A tile of the block's rows and a B tile of its columns are both
// occupied there.  stage() evaluates every K tile once, in parallel, into
// bit flags in shared memory (up to 32 kFlagWords tiles; beyond that
// each query reads the bitmaps again).  As a K walk (semiring_common.cuh)
// its segments are the live K tiles.
struct Live {
  const int* a_occ;  // (ceil(m / bm), kt_n) of this batch entry
  const int* b_occ;  // (kt_n, ceil(n / bn))
  int k, bk, kt_n, nt_n, ti0, ti1, tj0, tj1;
  uint32_t* flags;   // kFlagWords words in shared memory

  __device__ Live(const int* ao, const int* bo, int m, int n, int k_, int bm,
                  int bn, int bk_, int row0, int col0, int rows_blk,
                  int cols_blk, uint32_t* fl)
      : a_occ(ao), b_occ(bo), k(k_), bk(bk_), kt_n((k_ + bk_ - 1) / bk_),
        nt_n((n + bn - 1) / bn), ti0(row0 / bm),
        ti1((min(m, row0 + rows_blk) - 1) / bm), tj0(col0 / bn),
        tj1((min(n, col0 + cols_blk) - 1) / bn), flags(fl) {}

  // No early exit: the loads are independent and go out together.
  __device__ bool tile(int kt) const {
    bool la = false, lb = false;
    for (int i = ti0; i <= ti1; ++i)
      la |= a_occ[static_cast<long long>(i) * kt_n + kt] != 0;
    for (int j = tj0; j <= tj1; ++j)
      lb |= b_occ[static_cast<long long>(kt) * nt_n + j] != 0;
    return la && lb;
  }

  __device__ bool staged() const { return kt_n <= 32 * kFlagWords; }

  // Every thread of the block calls it; ends with a barrier.
  __device__ void stage(int tid, int threads) const {
    if (staged()) {
      for (int kt0 = tid & ~31; kt0 < kt_n; kt0 += threads & ~31) {
        const int kt = kt0 + (tid & 31);
        const uint32_t bits =
            __ballot_sync(0xffffffffu, kt < kt_n && tile(kt));
        if ((tid & 31) == 0) flags[kt0 / 32] = bits;
      }
    }
    __syncthreads();
  }

  // Uniform across the block: every thread reads the same bits.
  __device__ bool on(int kt) const {
    return staged() ? (flags[kt / 32] >> (kt % 32)) & 1u : tile(kt);
  }

  // The K walk: the live tiles in order, each [kt bk, min(k, (kt + 1) bk)).
  __device__ int next(int kt) const {
    do {
      ++kt;
    } while (kt < kt_n && !on(kt));
    return kt;
  }
  __device__ int first() const { return next(-1); }
  __device__ int count() const { return kt_n; }
  __device__ int begin(int kt) const { return kt * bk; }
  __device__ int end(int kt) const { return min(k, (kt + 1) * bk); }
};

// ---- 2. bool on packed words -----------------------------------------------

__global__ void __launch_bounds__(kBoolSide * kBoolSide)
sparse_bool_kernel(const uint32_t* __restrict__ ap,
                   const uint32_t* __restrict__ bp, uint8_t* __restrict__ c,
                   const int* __restrict__ a_occ,
                   const int* __restrict__ b_occ, int m, int k, int n,
                   long long stride_ap, long long stride_bp,
                   long long stride_ao, long long stride_bo, int bm, int bn,
                   int bk) {
  __shared__ BoolStage st;
  __shared__ int words[kWords];
  __shared__ int n_words, next;
  __shared__ uint32_t flags[kFlagWords];
  const long long batch = blockIdx.z;
  const int kw = (k + 31) / 32;
  ap += batch * stride_ap;
  bp += batch * stride_bp;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * kBoolTile;
  const int col0 = blockIdx.x * kBoolTile;
  const Live live(a_occ + batch * stride_ao, b_occ + batch * stride_bo, m, n,
                  k, bm, bn, bk, row0, col0, kBoolTile, kBoolTile, flags);
  const int tid = threadIdx.y * kBoolSide + threadIdx.x;
  live.stage(tid, kBoolSide * kBoolSide);
  const int lane = tid & 31;
  uint32_t acc[kBoolPer][kBoolPer] = {};

  int cursor = 0;
  for (;;) {
    if (tid < 32) {
      // Gather up to kWords live words from `cursor` on.
      int count = 0, cur = cursor;
      while (count < kWords && cur < kw) {
        const int w = cur + lane;
        bool on = false;
        if (w < kw) {
          const int kt_a = 32 * w / bk;
          const int kt_b = (min(32 * w + 31, k - 1)) / bk;
          for (int kt = kt_a; kt <= kt_b && !on; ++kt) on = live.on(kt);
        }
        uint32_t mask = __ballot_sync(0xffffffffu, on);
        const int take = min(__popc(mask), kWords - count);
        const int rank = __popc(mask & ((1u << lane) - 1u));
        if (on && rank < take) words[count + rank] = w;
        count += take;
        if (take < __popc(mask)) {
          for (int i = 0; i < take; ++i) mask &= mask - 1u;
          cur += __ffs(mask) - 1;   // the first live word not taken
        } else {
          cur += 32;
        }
      }
      if (lane == 0) {
        n_words = count;
        next = cur;
      }
    }
    __syncthreads();
    const int count = n_words;
    cursor = next;
    if (count == 0) break;
    bool_pass(ap, bp, m, n, kw, row0, col0, count,
              [&](int i) { return words[i]; }, st, acc);
  }
  bool_store(c, m, n, row0, col0, acc);
}

// ---- 3. count and minplus ---------------------------------------------------

template <int BM>
__global__ void __launch_bounds__(kCountThreads)
sparse_count_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ c, const int* __restrict__ a_occ,
                    const int* __restrict__ b_occ, int m, int k, int n,
                    long long stride_a, long long stride_b,
                    long long stride_ao, long long stride_bo, int bm, int bn,
                    int bk, float sat, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t flags[kFlagWords];
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kCountBN;
  const Live live(a_occ + batch * stride_ao, b_occ + batch * stride_bo, m, n,
                  k, bm, bn, bk, row0, col0, BM, kCountBN, flags);
  live.stage(threadIdx.x, kCountThreads);
  CountAcc<BM> acc = {};
  count_tile<BM>(a, b, m, k, n, row0, col0, live, vec, smem, acc);
  count_outputs<BM>(m, n, row0, col0, acc, [&](int r, int col, double v) {
    c[static_cast<long long>(r) * n + col] = count_value(v, sat);
  });
}

template <class T>
__global__ void __launch_bounds__(T::kThreads)
sparse_minplus_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ c,
                      const int* __restrict__ a_occ,
                      const int* __restrict__ b_occ, int m, int k, int n,
                      long long stride_a, long long stride_b,
                      long long stride_ao, long long stride_bo, int bm,
                      int bn, int bk, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t flags[kFlagWords];
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * T::kBM, col0 = blockIdx.x * T::kBN;
  const Live live(a_occ + batch * stride_ao, b_occ + batch * stride_bo, m, n,
                  k, bm, bn, bk, row0, col0, T::kBM, T::kBN, flags);
  live.stage(threadIdx.x, T::kThreads);
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = INFINITY;
  minplus_tile<T>(a, b, m, k, n, row0, col0, live, vec, smem, acc);
  minplus_store<T>(c, m, n, row0, col0, acc);
}

// The operands and occupancy bitmaps of one product, as the launches
// below pass them on.
struct Product {
  const float* a;
  const float* b;
  float* c;
  const int* a_occ;
  const int* b_occ;
  int batch, m, k, n;
  long long stride_a, stride_b, stride_ao, stride_bo;
  int bm, bn, bk;
};

template <int BM>
int launch_count(const Product& p, float sat, cudaStream_t s) {
  const dim3 grid((p.n + kCountBN - 1) / kCountBN, (p.m + BM - 1) / BM,
                  p.batch);
  return launch_dynamic(sparse_count_kernel<BM>, grid, kCountThreads,
                        CountRing<BM>::kSmem, s, p.a, p.b, p.c, p.a_occ,
                        p.b_occ, p.m, p.k, p.n, p.stride_a, p.stride_b,
                        p.stride_ao, p.stride_bo, p.bm, p.bn, p.bk, sat,
                        copy_vec(p.a, p.b, p.k, p.n, p.bk));
}

template <class T>
int launch_minplus(const Product& p, cudaStream_t s) {
  const dim3 grid((p.n + T::kBN - 1) / T::kBN, (p.m + T::kBM - 1) / T::kBM,
                  p.batch);
  return launch_dynamic(sparse_minplus_kernel<T>, grid, T::kThreads,
                        T::kSmem, s, p.a, p.b, p.c, p.a_occ, p.b_occ, p.m,
                        p.k, p.n, p.stride_a, p.stride_b, p.stride_ao,
                        p.stride_bo, p.bm, p.bn, p.bk,
                        copy_vec(p.a, p.b, p.k, p.n, p.bk));
}

template <int MODE>
void launch_occupancy(OccJob ja, OccJob jb, cudaStream_t s) {
  occupancy_kernel<MODE><<<kOccParts * (ja.blocks() + jb.blocks()),
                           kOccThreads, 0, s>>>(ja, jb);
}

}  // namespace

extern "C" {

// mode: 0 count, 1 bool (byte operands and output), 2 minplus (f32).
// A is (batch_a, m, k) and B (batch_b, k, n), row-major, each of batch_a
// and batch_b either 1 (broadcast) or batch.  Scratch the caller
// allocates: a_occ holds batch_a * ceil(m/bm) * ceil(k/bk) and b_occ
// batch_b * ceil(k/bk) * ceil(n/bn) int32 occupancy bits (written here);
// for bool, ap holds batch_a * m * kw and bp batch_b * kw * n packed words,
// kw = ceil(k / 32) (null otherwise).  The output is a dense (batch, m, n).
// Returns cudaGetLastError() (or the error of raising a block's shared
// memory limit).
int sparse_launch(int mode, const void* a, const void* b, void* c,
                  void* a_occ, void* b_occ, void* ap, void* bp, int batch,
                  int batch_a, int batch_b, int m, int k, int n, int bm,
                  int bn, int bk, float sat, void* stream) {
  if (bm < 1 || bn < 1 || bk < 1 || m < 1 || n < 1 || k < 1 || batch < 1 ||
      (batch_a != 1 && batch_a != batch) ||
      (batch_b != 1 && batch_b != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt_n = (k + bk - 1) / bk;
  const int mt_n = (m + bm - 1) / bm, nt_n = (n + bn - 1) / bn;
  const OccJob ja{a, static_cast<int*>(a_occ), batch_a, m, k, bm, bk, mt_n,
                  kt_n};
  const OccJob jb{b, static_cast<int*>(b_occ), batch_b, k, n, bk, bn, kt_n,
                  nt_n};
  const long long stride_ao = batch_a == 1 ? 0 : ja.blocks() / batch_a;
  const long long stride_bo = batch_b == 1 ? 0 : jb.blocks() / batch_b;
  const long long stride_a = batch_a == 1 ? 0 : static_cast<long long>(m) * k;
  const long long stride_b = batch_b == 1 ? 0 : static_cast<long long>(k) * n;
  const int* ao = static_cast<const int*>(a_occ);
  const int* bo = static_cast<const int*>(b_occ);
  const Product p{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<float*>(c), ao, bo, batch, m, k, n, stride_a,
                  stride_b, stride_ao, stride_bo, bm, bn, bk};
  const bool wide = wide_tiles(batch, m, n);
  switch (mode) {
    case kCount:
      launch_occupancy<kCount>(ja, jb, s);
      return wide ? launch_count<64>(p, sat, s) : launch_count<32>(p, sat, s);
    case kMinPlus:
      launch_occupancy<kMinPlus>(ja, jb, s);
      return wide ? launch_minplus<MinPlusWide>(p, s)
                  : launch_minplus<MinPlusNarrow>(p, s);
    case kBool: {
      launch_occupancy<kBool>(ja, jb, s);
      const int kw = (k + 31) / 32;
      uint32_t* pa = static_cast<uint32_t*>(ap);
      uint32_t* pb = static_cast<uint32_t*>(bp);
      pack_operands(a, b, pa, pb, batch_a, batch_b, m, k, n, s);
      const dim3 block(kBoolSide, kBoolSide);
      const dim3 grid((n + kBoolTile - 1) / kBoolTile,
                      (m + kBoolTile - 1) / kBoolTile, batch);
      sparse_bool_kernel<<<grid, block, 0, s>>>(
          pa, pb, static_cast<uint8_t*>(c), ao, bo, m, k, n,
          batch_a == 1 ? 0 : static_cast<long long>(m) * kw,
          batch_b == 1 ? 0 : static_cast<long long>(kw) * n, stride_ao,
          stride_bo, bm, bn, bk);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
