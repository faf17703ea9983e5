// Shared by the dense (semiring.cu) and block-sparse (sparse.cu) semiring
// kernels: the bool semiring on operands bit-packed along K.
//
// With 0/1 operands the clamped count of the bool semiring is exactly
// OR_k (a_ik AND b_kj).  A's rows and B's columns are packed along K into
// 32-bit words (bit j of word w is entry 32 w + j), so a product reads an
// eighth of the operand bytes and does one AND and one OR per 32 terms.
// The product stages 32 words at a time for a 64x64 output tile; each of
// the 256 threads keeps 4x4 outputs.  Which words a pass stages is the
// caller's: every word for the dense product, only the words that meet an
// occupied tile pair for the block-sparse one.  A word that meets no
// occupied pair ANDs to zero, so staging or skipping it gives the same
// bits.

#pragma once

#include <cuda_runtime.h>
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

// (rows, k) bytes -> (rows, kw) words: bit j of word w is src[r, 32 w + j].
// One warp per word: each lane reads one byte, the ballot packs them.
__global__ void pack_rows(const uint8_t* __restrict__ src,
                          uint32_t* __restrict__ dst, long long rows, int k,
                          int kw) {
  const long long word =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (word >= rows * kw) return;  // uniform across the warp
  const long long r = word / kw;
  const int col = static_cast<int>(word % kw) * 32 + lane;
  const bool bit = col < k && src[r * k + col] != 0;
  const uint32_t packed = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) dst[word] = packed;
}

// (batches, k, n) bytes -> (batches, kw, n) words: bit j of word [w, c]
// is src[32 w + j, c].  Neighbouring threads take neighbouring columns, so
// reads and writes are coalesced.
__global__ void pack_cols(const uint8_t* __restrict__ src,
                          uint32_t* __restrict__ dst, int batches, int k,
                          int n, int kw) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batches) * kw * n) return;
  const int c = static_cast<int>(idx % n);
  const long long bw = idx / n;  // batch * kw + w
  const int w = static_cast<int>(bw % kw);
  const long long b = bw / kw;
  const int k0 = w * 32;
  const int len = min(32, k - k0);
  const uint8_t* s = src + (b * k + k0) * n + c;
  uint32_t packed = 0;
  for (int j = 0; j < len; ++j)
    packed |= static_cast<uint32_t>(s[static_cast<long long>(j) * n] != 0)
              << j;
  dst[idx] = packed;
}

// Launch both packing passes on s: A (batch_a, m, k) bytes into ap
// (batch_a, m, kw) words, B (batch_b, k, n) bytes into bp (batch_b, kw, n).
void pack_operands(const void* a, const void* b, uint32_t* ap, uint32_t* bp,
                   int batch_a, int batch_b, int m, int k, int n,
                   cudaStream_t s) {
  const int kw = (k + 31) / 32;
  const long long rows_a = static_cast<long long>(batch_a) * m;
  pack_rows<<<blocks_for(rows_a * kw * 32, 256), 256, 0, s>>>(
      static_cast<const uint8_t*>(a), ap, rows_a, k, kw);
  pack_cols<<<blocks_for(static_cast<long long>(batch_b) * kw * n, 256), 256,
              0, s>>>(static_cast<const uint8_t*>(b), bp, batch_b, k, n, kw);
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

}  // namespace
