// Shared by the dense (semiring.cu) and block-sparse (sparse.cu) semiring
// kernels: the tile products of the three semirings.  Each product takes
// a K walk (a sequence of K segments, below), so the dense kernel walks
// all of K (or its split's share of it) and the block-sparse one only the
// K tiles that meet an occupied tile pair.
//
// bool.  With 0/1 operands the clamped count of the bool semiring is
// exactly OR_k (a_ik AND b_kj).  A's rows and B's columns are packed along
// K into 32-bit words (bit j of word w is entry 32 w + j), so a product
// reads an eighth of the operand bytes and does one AND and one OR per 32
// terms.  One launch packs both operands (pack_operands); the dense
// product (semiring.cu) has its own tile product.  The block-sparse one
// stages 32 words at a time for a 64x64 output tile, each of the 256
// threads keeping 4x4 outputs, and stages only the words that meet an
// occupied tile pair.  A word that meets no occupied pair ANDs to zero, so
// staging or skipping it gives the same bits.
//
// count.  Exact sums on the fp64 tensor cores (mma.sync m16n8k8 f64, 67
// TFLOP/s on the H100, the same peak as f32 on the CUDA cores).  A and B
// are staged in shared memory as f32 and widened to fp64 as each fragment
// is read (staging them as fp64 through registers ran slower).  An
// f32 x f32 product is exact in fp64 (48 significant bits), and sums of
// integer-valued products are exact in fp64 below 2^53; so for the
// integer-valued operands of the port (walk counts and the 0/1 adjacency)
// every partial sum is exact, and min((float) sum, sat), rounded once, is
// the same whatever the tiling, the split of K or the skipped tile pairs.
// A sum past FLT_MAX rounds to inf, which the min takes to sat, as the
// plain min(A @ B, sat) does.  No TF32 and no f32 tensor-core path.
//
// minplus.  min_k (a_ik + b_kj) on the CUDA cores (no tensor-core form):
// each thread keeps 8x4 (or 4x4) outputs in registers.  min is
// order-free, so any tiling is bitwise the plain version.
//
// Both stage K 32 entries a step through one three-stage cp.async ring
// (ring_walk).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// In the unnamed namespace, which the including source's own unnamed
// namespace joins: each library keeps its own copy of the kernels.
namespace {

constexpr int kBoolTile = 64;   // output rows and columns per block
constexpr int kBoolSide = 16;   // threads per block side
constexpr int kBoolPer = kBoolTile / kBoolSide;  // outputs per thread side
constexpr int kWords = 32;      // packed K words staged per pass

unsigned blocks_for(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

constexpr int kPackThreads = 256;  // threads of a packing block

// Both operands packed in one launch.  Blocks [0, row_blocks) pack A
// (rows, k) bytes into (rows, kw) words, bit j of word w being src[r, 32 w
// + j]: one warp a row, lane l reads byte 32 w + l of word w, the ballot
// is the word, and lane w % 32 keeps it until up to 32 words of the row
// go out in one coalesced store (the 32 words' loads in flight together).
// The other blocks pack B (batches, k, n) bytes into (batches, kw, n)
// words, bit j of word [w, c] being src[32 w + j, c]: one thread a (word,
// column), its 32 byte loads independent, neighbouring threads on
// neighbouring columns.  Block indices are split with 32-bit arithmetic,
// once a block.
__global__ void __launch_bounds__(kPackThreads)
pack_bool(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          uint32_t* __restrict__ ap, uint32_t* __restrict__ bp, int rows_a,
          int k, int n, int kw, int row_blocks, int col_blocks) {
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int row = blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5);
    if (row >= rows_a) return;  // uniform across the warp
    const int lane = threadIdx.x & 31;
    const uint8_t* src = a + static_cast<long long>(row) * k;
    uint32_t* dst = ap + static_cast<long long>(row) * kw;
    for (int w0 = 0; w0 < kw; w0 += 32) {
      uint32_t mine = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // every load in flight together
        const int col = (w0 + i) * 32 + lane;
        const uint32_t word =
            __ballot_sync(0xffffffffu, col < k && src[col] != 0);
        if (lane == i) mine = word;
      }
      if (w0 + lane < kw) dst[w0 + lane] = mine;
    }
    return;
  }
  const int job = blockIdx.x - row_blocks;  // (batch kw + w) col_blocks + cb
  const int c = (job % col_blocks) * kPackThreads + threadIdx.x;
  if (c >= n) return;
  const int bw = job / col_blocks;
  const int k0 = (bw % kw) * 32;
  const long long batch = bw / kw;
  const uint8_t* src = b + (batch * k + k0) * n + c;
  uint32_t packed = 0;
  if (k0 + 32 <= k) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      packed |= static_cast<uint32_t>(src[static_cast<long long>(j) * n] != 0)
                << j;
  } else {
    for (int j = 0; j < k - k0; ++j)
      packed |= static_cast<uint32_t>(src[static_cast<long long>(j) * n] != 0)
                << j;
  }
  bp[static_cast<long long>(bw) * n + c] = packed;
}

// Pack both operands on s, in one launch: A (batch_a, m, k) bytes into ap
// (batch_a, m, kw) words, B (batch_b, k, n) bytes into bp (batch_b, kw, n).
void pack_operands(const void* a, const void* b, uint32_t* ap, uint32_t* bp,
                   int batch_a, int batch_b, int m, int k, int n,
                   cudaStream_t s) {
  const int kw = (k + 31) / 32;
  const int rows_a = batch_a * m;
  const int row_blocks = static_cast<int>(blocks_for(rows_a, kPackThreads / 32));
  const int col_blocks = static_cast<int>(blocks_for(n, kPackThreads));
  const long long total =
      row_blocks + static_cast<long long>(batch_b) * kw * col_blocks;
  // A grid past the kernel's int block index launches empty, which the
  // launch reports as an invalid configuration.
  const unsigned blocks = total > INT_MAX ? 0u : static_cast<unsigned>(total);
  pack_bool<<<blocks, kPackThreads, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), ap, bp,
      rows_a, k, n, kw, row_blocks, col_blocks);
}

// The packed operands' shared-memory stage of one 64x64 output tile.
struct BoolStage {
  uint32_t as[kBoolTile][kWords + 1];
  uint32_t bs[kWords][kBoolTile];
};

// acc |= AND over `count` (<= kWords) staged words: word i of the pass is
// word_of(i).  ap is (m, kw) and bp (kw, n) for this batch entry; the
// tile starts at (row0, col0).  Ends with a barrier, so the stage is free.
template <class WordOf>
__device__ __forceinline__ void bool_pass(
    const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp, int m,
    int n, int kw, int row0, int col0, int count, WordOf word_of,
    BoolStage& st, uint32_t (&acc)[kBoolPer][kBoolPer]) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBoolSide + tx;
  for (int e = tid; e < kBoolTile * kWords; e += kBoolSide * kBoolSide) {
    const int r = e / kWords, i = e % kWords;
    const int gr = row0 + r;
    st.as[r][i] = gr < m && i < count
                      ? ap[static_cast<long long>(gr) * kw + word_of(i)]
                      : 0u;
    const int ib = e / kBoolTile, cb = e % kBoolTile;
    const int gc = col0 + cb;
    st.bs[ib][cb] = ib < count && gc < n
                        ? bp[static_cast<long long>(word_of(ib)) * n + gc]
                        : 0u;
  }
  __syncthreads();
#pragma unroll 4
  for (int w = 0; w < kWords; ++w) {
    uint32_t av[kBoolPer], bv[kBoolPer];
#pragma unroll
    for (int i = 0; i < kBoolPer; ++i) av[i] = st.as[ty + kBoolSide * i][w];
#pragma unroll
    for (int j = 0; j < kBoolPer; ++j) bv[j] = st.bs[w][tx + kBoolSide * j];
#pragma unroll
    for (int i = 0; i < kBoolPer; ++i)
#pragma unroll
      for (int j = 0; j < kBoolPer; ++j) acc[i][j] |= av[i] & bv[j];
  }
  __syncthreads();
}

// The tile's outputs as bytes 0 or 1.
__device__ __forceinline__ void bool_store(
    uint8_t* __restrict__ c, int m, int n, int row0, int col0,
    const uint32_t (&acc)[kBoolPer][kBoolPer]) {
#pragma unroll
  for (int i = 0; i < kBoolPer; ++i) {
    const int gr = row0 + threadIdx.y + kBoolSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kBoolPer; ++j) {
      const int gc = col0 + threadIdx.x + kBoolSide * j;
      if (gc < n)
        c[static_cast<long long>(gr) * n + gc] = acc[i][j] != 0u ? 1 : 0;
    }
  }
}

// ---- K walks ---------------------------------------------------------------

// A walk visits segments s = first(), next(s), ... while s < count();
// segment s covers K entries [begin(s), end(s)).  KRange is one segment:
// all of K for the dense products, or one split's share of it.
struct KRange {
  int k0, k1;
  __device__ int first() const { return k0 < k1 ? 0 : 1; }
  __device__ int next(int) const { return 1; }
  __device__ int count() const { return 1; }
  __device__ int begin(int) const { return k0; }
  __device__ int end(int) const { return k1; }
};

// ---- the staging ring, shared by the count and minplus products ----------

// V floats (4 V bytes, aligned so) from global to shared memory.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(4 * V));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

constexpr int kStep = 32;   // K entries staged per step
constexpr int kStages = 3;  // the ring's depth

// The f32 slices of one step: A's BM rows by 32 K entries (row stride
// LDA), then 32 K rows of B by BN columns (row stride LDB).
template <int BM, int BN, int PADA, int PADB>
struct Ring {
  static constexpr int LDA = kStep + PADA;
  static constexpr int LDB = BN + PADB;
  static constexpr int kStage = BM * LDA + kStep * LDB;  // floats
  static constexpr size_t kSmem = kStages * kStage * sizeof(float);
};

// Walk the K segments 32 entries a step through a kStages-deep ring of
// R-shaped stages in smem (R::kSmem bytes): load(as, bs, k0, kend) stages
// step [k0, kend) of A's rows and B's columns with cp.async, and
// on_step(as, bs) runs the products on a staged step.  Every thread
// of the block calls it.  The loads run kStages - 1 steps ahead of the
// products; every slot commits one cp.async group (empty past the last
// step), so once kStages - 2 groups at most are pending, the step has
// landed.  One barrier a step: after it, the step is visible to every
// thread and every thread is done with the step before, whose stage the
// next load takes.
template <class R, int BM, class Walk, class Load, class OnStep>
__device__ __forceinline__ void ring_walk(const Walk& walk, float* smem,
                                          Load load, OnStep on_step) {
  auto stage = [&](int st) { return smem + st * R::kStage; };
  // The next step after (seg, k0): 32 further in K, or the next segment.
  auto advance = [&](int& seg, int& k0) {
    k0 += kStep;
    if (k0 >= walk.end(seg)) {
      seg = walk.next(seg);
      k0 = seg < walk.count() ? walk.begin(seg) : 0;
    }
  };
  int iseg = walk.first();                   // the next step to load
  int ik0 = iseg < walk.count() ? walk.begin(iseg) : 0;
  int issued = 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (iseg < walk.count()) {
      load(stage(st), stage(st) + BM * R::LDA, ik0, walk.end(iseg));
      advance(iseg, ik0);
      ++issued;
    }
    cp_async_commit();
  }
  int st = 0, st_load = kStages - 1;
  for (int step = 0; step < issued; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (iseg < walk.count()) {
      load(stage(st_load), stage(st_load) + BM * R::LDA, ik0,
           walk.end(iseg));
      advance(iseg, ik0);
      ++issued;
    }
    cp_async_commit();
    on_step(stage(st), stage(st) + BM * R::LDA);
    st = st + 1 == kStages ? 0 : st + 1;
    st_load = st_load + 1 == kStages ? 0 : st_load + 1;
  }
}

// ---- count: fp64 tensor cores ---------------------------------------------

constexpr int kCountThreads = 128;  // four warps, 2 x 2 over the tile
constexpr int kCountBN = 64;        // output columns per block

// A BM x 64 tile: A rows padded to 36 floats and B rows to 72, so that
// each fragment load of a warp (rows g, K entries t, g = lane / 4,
// t = lane % 4) falls in 32 distinct banks.
template <int BM>
using CountRing = Ring<BM, kCountBN, 4, 8>;

// Each warp's outputs: (BM / 2) x 32, as BM / 32 row tiles of 16 and four
// column tiles of 8 (m16n8 accumulators of four doubles).
template <int BM>
using CountAcc = double[BM / 32][4][4];

// d += a (16x8, row) * b (8x8, col) in fp64.  Fragments (g = lane / 4,
// t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].  Not volatile: registers only, so the compiler may
// interleave the products.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Stage `rows` x `cols` floats (a step of A or B) with the widest copies
// `vec` allows; out-of-range entries are `zero`.
template <int THREADS>
__device__ __forceinline__ void stage_vec(int vec, float* dst, int ldd,
                                          const float* src, long long ld,
                                          int row0, int col0, int rows,
                                          int cols, int row_end, int col_end,
                                          float zero) {
  if (vec == 4)
    stage_tile<4, THREADS>(dst, ldd, src, ld, row0, col0, rows, cols,
                           row_end, col_end, zero);
  else if (vec == 2)
    stage_tile<2, THREADS>(dst, ldd, src, ld, row0, col0, rows, cols,
                           row_end, col_end, zero);
  else
    stage_tile<1, THREADS>(dst, ldd, src, ld, row0, col0, rows, cols,
                           row_end, col_end, zero);
}

// acc += A[row0 : row0 + BM, walk] @ B[walk, col0 : col0 + 64], exactly
// for integer-valued operands (sums below 2^53).  a is (m, k) and b (k, n),
// row-major, of this batch entry; smem holds CountRing<BM>::kSmem bytes.
// Every thread of the kCountThreads-thread block calls it.  The f32
// operands are staged by the ring in `vec`-float copies (stage_vec) and
// widened to fp64 as each fragment is read from shared memory.
template <int BM, class Walk>
__device__ __forceinline__ void count_tile(
    const float* __restrict__ a, const float* __restrict__ b, int m, int k,
    int n, int row0, int col0, const Walk& walk, int vec, float* smem,
    CountAcc<BM>& acc) {
  using R = CountRing<BM>;
  constexpr int MI = BM / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * 32;
  ring_walk<R, BM>(
      walk, smem,
      [&](float* as, float* bs, int k0, int kend) {
        stage_vec<kCountThreads>(vec, as, R::LDA, a, k, row0, k0, BM, kStep,
                                 m, kend, 0.0f);
        stage_vec<kCountThreads>(vec, bs, R::LDB, b, n, k0, col0, kStep,
                                 kCountBN, kend, n, 0.0f);
      },
      [&](const float* as, const float* bs) {
#pragma unroll
        for (int kk = 0; kk < kStep; kk += 8) {
          double af[MI][4], bf[4][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float* r = as + (wm + 16 * i + g) * R::LDA + kk + t;
            af[i][0] = r[0];
            af[i][1] = r[8 * R::LDA];
            af[i][2] = r[4];
            af[i][3] = r[8 * R::LDA + 4];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* c = bs + (kk + t) * R::LDB + wn + 8 * j + g;
            bf[j][0] = c[0];
            bf[j][1] = c[4 * R::LDB];
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], af[i], bf[j]);
        }
      });
}

// Hand each accumulator to store(row, col, value), the tile's outputs in
// range only.
template <int BM, class Store>
__device__ __forceinline__ void count_outputs(int m, int n, int row0,
                                              int col0,
                                              const CountAcc<BM>& acc,
                                              Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + (warp >> 1) * (BM / 2) + (lane >> 2);
  const int c0 = col0 + (warp & 1) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + 16 * i + 8 * (v >> 1), c = c0 + 8 * j + (v & 1);
        if (r < m && c < n) store(r, c, acc[i][j][v]);
      }
}

// The rounded, saturated output of an exact sum.
__device__ __forceinline__ float count_value(double sum, float sat) {
  return fminf(static_cast<float>(sum), sat);
}

// ---- minplus: register tiles on the CUDA cores -----------------------------

// A BM x BN output tile, TM x TN outputs a thread (TN a multiple of 4);
// A rows padded to 36 floats and B rows to BN + 4.
template <int BM, int BN, int TM_ = 4, int TN_ = 4>
struct MinPlusTile {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;      // threads along the columns
  static constexpr int TY = BM / TM;      // threads along the rows
  static constexpr int kThreads = TX * TY;
  using R = Ring<BM, BN, 4, 4>;
  static constexpr size_t kSmem = R::kSmem;
};

// acc = min(acc, A[row0 : row0 + BM, walk] (min, +) B[walk, col0 : col0 +
// BN]) over the walk's segments, for the tile T = MinPlusTile<BM, BN, ...>;
// smem holds T::kSmem bytes.  Every thread of the block calls it.  Each staged step is read
// back as float4 (A row-major with its 32 K entries, B by rows).
template <class T, class Walk>
__device__ __forceinline__ void minplus_tile(
    const float* __restrict__ a, const float* __restrict__ b, int m, int k,
    int n, int row0, int col0, const Walk& walk, int vec, float* smem,
    float (&acc)[T::TM][T::TN]) {
  using R = typename T::R;
  constexpr int BM = T::kBM, BN = T::kBN;
  constexpr int TM = T::TM, TN = T::TN, TX = T::TX, TY = T::TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  constexpr int N = T::kThreads;
  ring_walk<R, BM>(
      walk, smem,
      [&](float* as, float* bs, int k0, int kend) {
        stage_vec<N>(vec, as, R::LDA, a, k, row0, k0, BM, kStep, m, kend,
                     INFINITY);
        stage_vec<N>(vec, bs, R::LDB, b, n, k0, col0, kStep, BN, kend, n,
                     INFINITY);
      },
      [&](const float* as, const float* bs) {
#pragma unroll 4
        for (int k4 = 0; k4 < kStep; k4 += 4) {
          float4 av[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            av[i] = *reinterpret_cast<const float4*>(
                as + (ty + TY * i) * R::LDA + k4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float bv[TN];
#pragma unroll
            for (int j4 = 0; j4 < TN / 4; ++j4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  bs + (k4 + q) * R::LDB + j4 * 4 * TX + tx * 4);
              bv[4 * j4] = v.x;
              bv[4 * j4 + 1] = v.y;
              bv[4 * j4 + 2] = v.z;
              bv[4 * j4 + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                            : q == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fminf(acc[i][j], x + bv[j]);
            }
          }
        }
      });
}

// The tile's outputs into c (m, n) of this batch entry.
template <class T>
__device__ __forceinline__ void minplus_store(
    float* __restrict__ c, int m, int n, int row0, int col0,
    const float (&acc)[T::TM][T::TN]) {
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gr = row0 + ty + T::TY * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int gc = col0 + (j / 4) * 4 * T::TX + tx * 4 + j % 4;
      if (gc < n) c[static_cast<long long>(gr) * n + gc] = acc[i][j];
    }
  }
}

// The products' copies: 4 (or 2) floats where every row start, step start
// (bk: the walk's segment granularity) and column origin is aligned to
// them.
inline int copy_vec(const void* a, const void* b, int k, int n, int bk) {
  auto fits = [&](int v) {
    return k % v == 0 && n % v == 0 && bk % v == 0 &&
           reinterpret_cast<uintptr_t>(a) % (4 * v) == 0 &&
           reinterpret_cast<uintptr_t>(b) % (4 * v) == 0;
  };
  return fits(4) ? 4 : fits(2) ? 2 : 1;
}

// The (min, +) tiles: wide for grids of at least four 64x64 blocks an SM
// (8x4 outputs a thread, 128 threads; 4x4 and 8x8 ran slower on the ksp
// cell's squarings), narrow below (wide_tiles).
using MinPlusWide = MinPlusTile<64, 64, 8, 4>;
using MinPlusNarrow = MinPlusTile<32, 64>;

// 64-row tiles, or 32-row ones when 64x64 tiles would give fewer than four
// blocks an SM (a single 722^2 product: 144 blocks of 64x64, 276 of
// 32x64).
inline bool wide_tiles(int batch, int m, int n) {
  constexpr int kSms = 132;
  const long long blocks = static_cast<long long>((m + 63) / 64) *
                           ((n + 63) / 64) * batch;
  return blocks >= 4 * kSms;
}

// Raise the kernel's dynamic shared memory limit to `bytes` and launch it.
template <class... Params, class... Args>
int launch_dynamic(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t bytes, cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
