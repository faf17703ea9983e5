// Block-sparse semiring product C = A (x) B for Hopper (sm_90a), on CUDA
// cores, skipping every tile pair that holds only the additive identity.
//
// Replaces the TPU kernel src/repro/kernels/sparse.py
// (_sparse_semiring_kernel, _pallas_sparse_matmul, sparse_semiring_matmul):
// the semiring product of semiring.py, gated per (bm, bk) x (bk, bn) tile
// pair on two occupancy bitmaps (pl.when(occupied)), in three semirings:
//   count   : C = min(acc + A@B, sat) in f32;
//   bool    : OR_k (a_ik AND b_kj) on bool bytes;
//   minplus : C = min_k (a_ik + b_kj), +inf being the additive identity.
// Skipping is exact: a skipped pair would add 0 to a count, nothing to an
// OR and +inf to a min.  The skip decides the time, never the result.
//
// What bounds it on the H100: for count and minplus, operations over the
// occupied tile pairs only (2 M K N f32 operations scaled by the occupied
// share); for bool, bytes (the int8 tensor rate would do the operations
// faster than the operands can be read).  No TF32 and no tensor cores:
// `count` must stay exact below 2^24, and minplus has no tensor-core form.
//
// What the design does about it.  One call is three steps on the stream:
//
// 1. Occupancy, one pass over both operands (occupancy_kernel): four
//    256-thread blocks per tile of A or of B read the tile once, a warp
//    per row with every load in flight together, and each writes one byte
//    of the tile's int32 bit.  It replaces the live-mask, pad and
//    reductions the wrapper ran before as PyTorch ops.  Each product block
//    then evaluates its K tiles' liveness once, in parallel, into bit
//    flags in shared memory.
// 2. bool: the operands are packed to bits along K (semiring_common.cuh,
//    shared with the dense kernel), and each 64x64 output block ANDs and
//    ORs the 32-bit words that meet an occupied tile pair of its rows and
//    columns.  A warp gathers those words' indices (ballot, popc) 32 at a
//    time, so a pass stages only live words.  A word whose K range is
//    partly in an empty tile is still exact: its zero bits add nothing,
//    so bk need not be a multiple of 32.
// 3. count and minplus (f32_kernel): each thread keeps 4x4 outputs in
//    registers, 256 threads on a 64x64 block tile, or 128 on a 32x64 one
//    when 64x64 would give fewer than four blocks an SM (a single 722^2
//    product then runs 276 blocks, not 144).  Larger register tiles (8x8, 8x4)
//    were tried and ran no faster at these shapes: with one product of
//    722^2 the card holds few blocks, and latency, not issue, bounds it.
//    The K walk visits only the occupied K tiles of the block's rows and
//    columns, 32 entries a step; each step is copied into shared memory
//    by cp.async in 16-, 8- or 4-byte pieces (the widest the operands'
//    alignment allows) through a three-stage ring, two steps ahead of the
//    products, and read back as float4 (A row-major with its 32 K
//    entries, B by rows).  Each output keeps the dense kernel's sum
//    order: a sequential fmaf over the 32 entries of a step, steps
//    starting at kt * bk + 32 j, and the saturating min(acc + part, sat)
//    after every step.  With bk a multiple of 32 the steps fall where the
//    dense kernel's do, so the two agree bitwise on any input.
//    Out-of-range rows, columns and K entries (and entries past the K
//    tile's end) are the identity, so a ragged edge needs no padded copy
//    of the operands.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "semiring_common.cuh"

namespace {

enum Mode { kCount = 0, kBool = 1, kMinPlus = 2 };  // ids of sparse.py's _MODE

constexpr int kStep = 32;         // K entries per saturation step
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
// each query reads the bitmaps again).
struct Live {
  const int* a_occ;  // (ceil(m / bm), kt_n) of this batch entry
  const int* b_occ;  // (kt_n, ceil(n / bn))
  int kt_n, nt_n, ti0, ti1, tj0, tj1;
  uint32_t* flags;   // kFlagWords words in shared memory

  __device__ Live(const int* ao, const int* bo, int m, int n, int k, int bm,
                  int bn, int bk, int row0, int col0, int rows_blk,
                  int cols_blk, uint32_t* fl)
      : a_occ(ao), b_occ(bo), kt_n((k + bk - 1) / bk),
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

// ---- 3. count and minplus on f32 -------------------------------------------

// V floats (4 V bytes, aligned so) from global to shared memory.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(4 * V));
}

// `rows` x `cols` floats of a row-major source (row stride ld) into dst
// (row stride ldd), copied V at a time; entries outside [0, row_end) x
// [0, col_end) of the source are `zero`.  Needs V-aligned cols, ld, the
// column origin and the source base.
template <int V, int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, int ldd,
                                           const float* src, long long ld,
                                           int row0, int col0, int rows,
                                           int cols, int row_end,
                                           int col_end, float zero) {
  for (int e = threadIdx.x; e < rows * (cols / V); e += THREADS) {
    const int r = e / (cols / V), cc = (e % (cols / V)) * V;
    const int gr = row0 + r, gc = col0 + cc;
    float* to = dst + r * ldd + cc;
    const float* from = src + gr * ld + gc;
    if (gr < row_end && gc + V <= col_end) {
      cp_async<V>(to, from);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (gr < row_end && gc + u < col_end)
          cp_async<1>(to + u, from + u);
        else
          to[u] = zero;
      }
    }
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A BM x BN output tile, TM x TN outputs a thread, an S-stage ring.
template <int BM, int BN>
struct F32Tile {
  static constexpr int TM = 4, TN = 4;
  static constexpr int S = 3;
  static constexpr int TX = BN / TN;      // threads along the columns
  static constexpr int TY = BM / TM;      // threads along the rows
  static constexpr int kThreads = TX * TY;
  static constexpr int LDA = kStep + 4;   // A stage: BM rows of 32 (+4)
  static constexpr int LDB = BN + 4;      // B stage: 32 rows of BN (+4)
  static constexpr int kStage = BM * LDA + kStep * LDB;  // floats
  static constexpr size_t kSmem = S * kStage * sizeof(float);
};

template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(F32Tile<BM, BN>::kThreads)
f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, const int* __restrict__ a_occ,
           const int* __restrict__ b_occ, int m, int k, int n,
           long long stride_a, long long stride_b, long long stride_ao,
           long long stride_bo, int bm, int bn, int bk, float sat, int vec) {
  using T = F32Tile<BM, BN>;
  constexpr int TM = T::TM, TN = T::TN, TX = T::TX, TY = T::TY, S = T::S;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t flags[kFlagWords];
  const float zero = MODE == kMinPlus ? INFINITY : 0.0f;
  const long long batch = blockIdx.z;
  a += batch * stride_a;
  b += batch * stride_b;
  c += batch * static_cast<long long>(m) * n;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const Live live(a_occ + batch * stride_ao, b_occ + batch * stride_bo, m, n,
                  k, bm, bn, bk, row0, col0, BM, BN, flags);
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  live.stage(tid, T::kThreads);

  // The K walk: steps [k0, min(k0 + 32, kend)) over the live K tiles.
  auto tile_end = [&](int kt) { return min(k, (kt + 1) * bk); };
  auto next_live = [&](int kt) {
    do {
      ++kt;
    } while (kt < live.kt_n && !live.on(kt));
    return kt;
  };
  // Step [k0, kend) of A's rows and B's columns into stage `st`, V
  // floats a copy (V = vec, which the launch chose by alignment).
  auto load = [&](int st, int k0, int kend) {
    float* as = smem + st * T::kStage;
    float* bs = as + BM * T::LDA;
    constexpr int N = T::kThreads;
    if (vec == 4) {
      stage_tile<4, N>(as, T::LDA, a, k, row0, k0, BM, kStep, m, kend, zero);
      stage_tile<4, N>(bs, T::LDB, b, n, k0, col0, kStep, BN, kend, n, zero);
    } else if (vec == 2) {
      stage_tile<2, N>(as, T::LDA, a, k, row0, k0, BM, kStep, m, kend, zero);
      stage_tile<2, N>(bs, T::LDB, b, n, k0, col0, kStep, BN, kend, n, zero);
    } else {
      stage_tile<1, N>(as, T::LDA, a, k, row0, k0, BM, kStep, m, kend, zero);
      stage_tile<1, N>(bs, T::LDB, b, n, k0, col0, kStep, BN, kend, n, zero);
    }
  };
  // The next step after (kt, k0): 32 further in K, or the next live tile.
  auto advance = [&](int& kt, int& k0) {
    k0 += kStep;
    if (k0 >= tile_end(kt)) {
      kt = next_live(kt);
      k0 = kt * bk;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = zero;

  // A ring of S stages: the loads run S - 1 steps ahead of the products.
  // Every slot commits one cp.async group (empty past the last step), so
  // once S - 2 groups at most are pending, step i has landed.  One
  // barrier a step: after it, step i is visible to every thread and every
  // thread is done with step i - 1, whose stage the next load takes.
  int ikt = next_live(-1), ik0 = ikt * bk;   // the next step to load
  int issued = 0;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (ikt < live.kt_n) {
      load(st, ik0, tile_end(ikt));
      advance(ikt, ik0);
      ++issued;
    }
    cp_async_commit();
  }
  int st = 0, st_load = S - 1;
  for (int step = 0; step < issued; ++step) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (ikt < live.kt_n) {
      load(st_load, ik0, tile_end(ikt));
      advance(ikt, ik0);
      ++issued;
    }
    cp_async_commit();
    const float* as = smem + st * T::kStage;
    const float* bs = as + BM * T::LDA;
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll 4
    for (int k4 = 0; k4 < kStep; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            as + (ty + TY * i) * T::LDA + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int j4 = 0; j4 < TN / 4; ++j4) {
          const float4 t = *reinterpret_cast<const float4*>(
              bs + (k4 + q) * T::LDB + j4 * 4 * TX + tx * 4);
          bv[4 * j4] = t.x;
          bv[4 * j4 + 1] = t.y;
          bv[4 * j4 + 2] = t.z;
          bv[4 * j4 + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                        : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (MODE == kMinPlus)
              acc[i][j] = fminf(acc[i][j], x + bv[j]);
            else
              part[i][j] = fmaf(x, bv[j], part[i][j]);
          }
        }
      }
    }
    if constexpr (MODE != kMinPlus) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j] + part[i][j], sat);
    }
    st = st + 1 == S ? 0 : st + 1;
    st_load = st_load + 1 == S ? 0 : st_load + 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + TY * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + (j / 4) * 4 * TX + tx * 4 + j % 4;
      if (gc < n) c[static_cast<long long>(gr) * n + gc] = acc[i][j];
    }
  }
}

template <int MODE, int BM, int BN>
int launch_f32(const float* a, const float* b, float* c, const int* a_occ,
               const int* b_occ, int batch, int m, int k, int n,
               long long stride_a, long long stride_b, long long stride_ao,
               long long stride_bo, int bm, int bn, int bk, float sat,
               cudaStream_t s) {
  using T = F32Tile<BM, BN>;
  auto kernel = f32_kernel<MODE, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Copies of 4 (or 2) floats where every row start, step start and
  // column origin is aligned to them.
  auto fits = [&](int v) {
    return k % v == 0 && n % v == 0 && bk % v == 0 &&
           reinterpret_cast<uintptr_t>(a) % (4 * v) == 0 &&
           reinterpret_cast<uintptr_t>(b) % (4 * v) == 0;
  };
  const int vec = fits(4) ? 4 : fits(2) ? 2 : 1;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(a, b, c, a_occ, b_occ, m, k, n,
                                             stride_a, stride_b, stride_ao,
                                             stride_bo, bm, bn, bk, sat,
                                             vec);
  return static_cast<int>(cudaGetLastError());
}


// 64x64 tiles, or 32x64 when those would give fewer than four blocks an
// SM (a single 722^2 product: 144 blocks of 64x64, 276 of 32x64).
template <int MODE>
int launch_f32_sized(const float* a, const float* b, float* c,
                     const int* a_occ, const int* b_occ, int batch, int m,
                     int k, int n, long long stride_a, long long stride_b,
                     long long stride_ao, long long stride_bo, int bm,
                     int bn, int bk, float sat, cudaStream_t s) {
  constexpr int kSms = 132;
  const long long blocks = static_cast<long long>((m + 63) / 64) *
                           ((n + 63) / 64) * batch;
  if (blocks >= 4 * kSms)
    return launch_f32<MODE, 64, 64>(a, b, c, a_occ, b_occ, batch, m, k, n,
                                    stride_a, stride_b, stride_ao, stride_bo,
                                    bm, bn, bk, sat, s);
  return launch_f32<MODE, 32, 64>(a, b, c, a_occ, b_occ, batch, m, k, n,
                                  stride_a, stride_b, stride_ao, stride_bo,
                                  bm, bn, bk, sat, s);
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
  switch (mode) {
    case kCount:
      launch_occupancy<kCount>(ja, jb, s);
      return launch_f32_sized<kCount>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), ao, bo, batch, m, k, n, stride_a, stride_b,
          stride_ao, stride_bo, bm, bn, bk, sat, s);
    case kMinPlus:
      launch_occupancy<kMinPlus>(ja, jb, s);
      return launch_f32_sized<kMinPlus>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), ao, bo, batch, m, k, n, stride_a, stride_b,
          stride_ao, stride_bo, bm, bn, bk, sat, s);
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
