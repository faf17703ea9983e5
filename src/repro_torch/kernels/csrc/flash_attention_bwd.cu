// The backward pass of flash attention (K5) for Hopper (sm_90a): dQ, dK
// and dV from the forward's saved output O and per-row log-sum-exp.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention.py (_flash_kernel) has no backward.  Its counterpart is
// the JAX package's custom VJP of flash_chunked, _flash_chunked_bwd
// (src/repro/models/attention.py:251), which recomputes each chunk's
// probabilities from the saved lse instead of keeping them:
//   delta = rowsum(dO * O)
//   P     = exp(S - lse) under the mask, S = q k^T * scale (capped)
//   dV    = P^T dO
//   dS    = P (dO V^T - delta), times 1 - (S / softcap)^2 under a cap
//   dQ    = dS K * scale,  dK = dS^T Q * scale
// with GQA's grouped query heads summed onto their KV head, causal and
// window masks and query and key positions counted from 0, as the forward
// (flash_attention.cu).  A fully masked row has P = 0 and gives 0.  f32 or
// bf16 in, f32 throughout, each gradient in the input's type; D <= 256,
// and V, O, dO and dV may be Dv <= D wide (multi-head latent attention's
// 128 against q and k's 192): they load Dv columns and zeros past them
// into the padded tiles, so dO V^T and the padded columns of P^T dO sum
// zeros, and dV stores its Dv columns.
//
// What bounds it on the H100: operations, 5 products per unmasked (q, k)
// pair and head, S = q k^T, dP = dO v^T, dV, dQ, dK: 2 (3 D + 2 Dv) flops
// (10 D when Dv = D), at the bf16 tensor-core rate for bf16 inputs and for
// f32 at three TF32 products' (165 TFLOP/s of f32 work, the floor of an
// f32-accurate product on the tensor cores; the CUDA cores' 67 TFLOP/s is
// the rate the f32 kernels had before).  Seven products are run (S and dP
// are recomputed by the dQ pass), so 7/5 of that bound is this design's
// floor.
//
// Three launches, no atomics, every sum in a fixed order: the gradients
// are the same bits from run to run.  1. The row statistics: delta =
// rowsum(dO * O) in f32, one warp a row (and, for the wgmma kernels, lse
// log2 e beside it, both in rows padded to 128 with zeros).  2. dK and dV,
// one block per (batch, KV head, key tile), the group's query heads summed
// inside the block.  3. dQ, one block per (batch, head, query tile).  The
// wrapper names the route of 2 and 3 by a rule on (dtype, D, Dv,
// alignment): f32 always takes tf32x3, bf16 the rest:
//
// wgmma (bf16, D <= 192; namespace wg).  Hopper's full tensor-core rate
// needs warpgroup products (wgmma) and loads that overlap them.  A block is
// one producer warp and two consumer warpgroups.  The producer fills a ring
// of 2 to 4 stages guarded by mbarriers (full: the tile arrived; empty:
// both consumers are done with it) while the consumers compute on the
// stages that arrived.  With route wgmma-tma one thread issues TMA loads of
// 64-column boxes, 128-byte swizzled, whose zero fill pads rows past S and
// columns past D (or Dv), and bulk copies of the tile's statistics; shapes
// TMA cannot describe (a row that is no multiple of 16 bytes, a base off
// 16-byte alignment) take route wgmma-ldst, where the producer warp copies
// with plain loads into the same swizzled layout.  Heads are padded to DP
// in {64, 128, 192}, V, dO and dV to DVP (DP, or 128 for Dv <= 128 at DP
// 192).  ptxas gives a thread of these 288-thread blocks at most 168
// registers (a producer warpgroup with setmaxnreg 24 / 240 spilled as
// much), so the tiles are sized to that and every kernel is free of spills:
//   dK/dV: 64 keys a block, their K and V kept in shared memory; the ring
//   carries the group's query tiles of BQ rows (64, 32 at D 192) with
//   their statistics.  The consumers split the work, not the keys:
//   consumer 0 computes S^T = K Q^T, forms P^T in registers, hands P^T
//   (times the softcap's derivative) to consumer 1 through a double buffer
//   in shared memory, and adds dV += P^T dO; consumer 1 computes dP^T = V
//   dO^T, forms dS^T and adds dK += dS^T Q.  Each holds one gradient in f32
//   registers across the group and runs two of the four products (balanced
//   at Dv = D and at MLA's 192 / 128).  P^T and dS^T, rounded to bf16, are
//   the register A operand of the gradient products, dO and Q read
//   MN-major through the descriptor.  At D 64 two blocks share a
//   multiprocessor.
//   dQ: 128 queries a block, 64 a consumer; Q, dO and the statistics stay
//   in shared memory; the ring carries key tiles of BK keys (64; 32 at D
//   192 for the 96 registers of dQ, and at D 64 where two blocks share a
//   multiprocessor) of K and V: S = Q K^T, dP = dO V^T, then dQ += dS K
//   with dS as the register A operand and K read MN-major.  The query
//   tiles run in reverse order, so under a causal mask the longest rows
//   start first.
// Tiles that no pair of the mask reaches are not loaded; a consumer skips a
// tile its rows see none of, and masks per element only on tiles that cross
// a mask's edge.  What holds them back (PERF.md): every product waits for
// its operands and the next waits for it, so the tensor cores are fed by
// at most two warpgroups a multiprocessor; and the dK/dV blocks read each
// query tile once per 64 keys.
//
// tf32x3 (f32 at every D <= 256; namespace tf): mma.sync products in split
// TF32 (mma_tf32.cuh: three m16n8k8 TF32 products a product, small terms
// first), held to the CUDA-core kernels' 1e-4 of each gradient's largest.
// 256-thread blocks of eight warps, two warps on each 16 rows of the
// products' M (keys in dK/dV, queries in dQ), f32 tiles in shared memory
// through a two-stage cp.async ring (plain loads for rows that are no
// multiple of 16 bytes or bases off 16-byte alignment), rows padded to 4
// mod 32 floats for conflict-free fragment loads; widths padded to 64,
// 128, 192 (V, dO and dV to 128) or 256.
//   dK/dV: 64 keys a block, their K and V kept in shared memory; the ring
//   carries the group's query tiles (32 queries, 16 at D 256) with lse
//   log2 e and delta.  The two warps of a key slice split the work as the
//   wgmma kernels' consumers do: one computes S^T = K Q^T, P^T and dV +=
//   P^T dO, and hands P^T dcap to the other through shared memory and a
//   named barrier of the pair; the other computes dP^T = V dO^T, dS^T and
//   dK += dS^T Q.  Each holds one gradient in f32 registers (the largest,
//   dK at D 256, 64 a thread) and runs two of the four products (balanced
//   at Dv = D and at 192 / 128).  P^T's and dS^T's accumulator fragments
//   are the gradient products' A fragments (mma_tf32.cuh's contraction
//   order).
//   dQ: 64 queries a block, their Q, dO and statistics in shared memory;
//   the ring carries key tiles (64 keys up to D 128, 32 at D 192, 16 at
//   D 256) of K and V, half of each to either warp of a row slice: S =
//   Q K^T, dP = dO V^T, dS, dQ += dS K; the two partial dQ are summed in
//   a fixed order at the end.  The query tiles run in reverse order.
// Each tile's gradient product is summed apart and added to the gradient
// with one f32 rounding, so that no tensor-core accumulation runs over more
// than one tile.  mma.sync rather than wgmma: TF32 wgmma reads B only
// K-major from shared memory, and dO, Q and K are MN-major B operands here.
//
// CUDA cores (bf16 at 192 < D <= 256): 256-thread blocks over 32 keys or
// queries, f32 shared tiles padded by one float a row; each thread
// recomputes 4 x 4 pairs of S and dO V^T with scalar fmaf, writes P and dS
// to shared memory, and adds P^T dO and dS^T Q (or dS K) into registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;

template <int DP>
struct Tile {
  static constexpr int BT = DP <= 128 ? 64 : 32;  // queries = keys a tile
  static constexpr int R = BT / kSide;            // tile rows per thread
  static constexpr int DC = DP / kSide;           // D columns per thread
  static constexpr int LD = DP + 1;               // shared row stride (D)
  static constexpr int LP = BT + 1;               // shared row stride (P)
  // dK/dV: K, V, Q, dO tiles; P, dS; lse, delta.  dQ: one float less a
  // row of P (it keeps dS only), the same bound.
  static constexpr size_t kSmem =
      sizeof(float) * (4 * BT * LD + 2 * BT * LP + 2 * BT);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// `rows` rows of a row-major (n_rows, d) source, from row0 on, into dst
// as f32 with row stride DP + 1; entries beyond n_rows or beyond d load 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int n_rows, int d) {
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP, c = e % DP, g = row0 + r;
    dst[r * (DP + 1) + c] =
        g < n_rows && c < d ? to_f32(src[static_cast<long long>(g) * d + c])
                            : 0.0f;
  }
}

// lse and delta of `rows` query rows from row0 on (0 past n_rows), by
// the block's THREADS threads.
template <int THREADS>
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int rows, int n_rows) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const int g = row0 + r;
    lse_s[r] = g < n_rows ? lse[g] : 0.0f;
    delta_s[r] = g < n_rows ? delta[g] : 0.0f;
  }
}

struct Mask {
  int sq, sk, causal, window;
  float scale, softcap;
};

// P and dS of the pair (qp, kp) from its two dot products q.k and dO.v.
__device__ __forceinline__ void p_and_ds(float qk, float dov, float lse,
                                         float delta, int qp, int kp,
                                         const Mask& m, float& p, float& ds) {
  float x = qk * m.scale;
  float dcap = 1.0f;
  if (m.softcap > 0.0f) {
    x = m.softcap * tanhf(x / m.softcap);
    const float t = x / m.softcap;
    dcap = 1.0f - t * t;
  }
  const bool live = qp < m.sq && kp < m.sk && (!m.causal || qp >= kp) &&
                    (m.window <= 0 || qp - kp < m.window);
  p = live ? expf(x - lse) : 0.0f;
  ds = p * (dov - delta) * dcap;
}

// The R x R dot products q.k and dO.v of this thread's rows ty + 16 i of
// (qs, dos) against rows tx + 16 j of (ks, vs), over the first d columns.
template <int DP, int R>
__device__ __forceinline__ void dots(const float* qs, const float* dos,
                                     const float* ks, const float* vs, int d,
                                     int tx, int ty, float (&s)[R][R],
                                     float (&dp)[R][R]) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int dd = 0; dd < d; ++dd) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + kSide * i) * LD + dd];
      ov[i] = dos[(ty + kSide * i) * LD + dd];
      kv[i] = ks[(tx + kSide * i) * LD + dd];
      vv[i] = vs[(tx + kSide * i) * LD + dd];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  o += row * d;
  dout += row * d;
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32)
    sum = fmaf(to_f32(o[c]), to_f32(dout[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int h, int hkv, int sq,
            int sk, int d, int dvw, Mask m) {
  using C = Tile<DP>;
  constexpr int BT = C::BT, R = C::R, DC = C::DC, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* ks = smem;               // BT x LD, the block's key tile
  float* vs = ks + BT * LD;       // BT x LD
  float* qs = vs + BT * LD;       // BT x LD, the current query tile
  float* dos = qs + BT * LD;      // BT x LD
  float* ps = dos + BT * LD;      // BT x LP: P[query][key]
  float* dss = ps + BT * LP;      // BT x LP: dS[query][key]
  float* lse_s = dss + BT * LP;   // BT
  float* delta_s = lse_s + BT;    // BT

  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int k0 = blockIdx.x * BT, kh = blockIdx.y, bb = blockIdx.z;
  const int group = h / hkv;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  load_tile<T, DP>(ks, k + k_row * d, k0, BT, sk, d);
  load_tile<T, DP>(vs, v + k_row * dvw, k0, BT, sk, dvw);

  // dK and dV of keys ty + 16 i, columns tx + 16 j.
  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // Queries that any key of this tile may be seen by.
  const int q_lo = m.causal ? k0 : 0;
  const int q_hi = m.window > 0 ? min(sq, k0 + BT - 1 + m.window) : sq;

  for (int g = 0; g < group; ++g) {
    const long long row_off = (static_cast<long long>(bb) * h +
                               kh * group + g) * sq;
    for (int q0 = (q_lo / BT) * BT; q0 < q_hi; q0 += BT) {
      __syncthreads();  // the last tile's reads are done
      load_tile<T, DP>(qs, q + row_off * d, q0, BT, sq, d);
      load_tile<T, DP>(dos, dout + row_off * dvw, q0, BT, sq, dvw);
      load_stats<kThreads>(lse_s, delta_s, lse + row_off, delta + row_off,
                           q0, BT, sq);
      __syncthreads();

      float s[R][R], dp[R][R];
      dots<DP, R>(qs, dos, ks, vs, d, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + kSide * i, c = tx + kSide * j;
          float p, ds;
          p_and_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], q0 + r, k0 + c,
                   m, p, ds);
          ps[r * LP + c] = p;
          dss[r * LP + c] = ds;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 2
      for (int qq = 0; qq < BT; ++qq) {
        float pk[R], dsk[R], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pk[i] = ps[qq * LP + ty + kSide * i];
          dsk[i] = dss[qq * LP + ty + kSide * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          ov[j] = dos[qq * LD + tx + kSide * j];
          qv[j] = qs[qq * LD + tx + kSide * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            acc_v[i][j] = fmaf(pk[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsk[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + kSide * i;
    if (key >= sk) continue;
    const long long row = k_row + key;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + kSide * j;
      if (c < d) dk[row * d + c] = from_f32<T>(acc_k[i][j] * m.scale);
      if (c < dvw) dv[row * dvw + c] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int h, int hkv, int sq, int sk, int d, int dvw,
          Mask m) {
  using C = Tile<DP>;
  constexpr int BT = C::BT, R = C::R, DC = C::DC, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* qs = smem;               // BT x LD, the block's query tile
  float* dos = qs + BT * LD;      // BT x LD
  float* ks = dos + BT * LD;      // BT x LD, the current key tile
  float* vs = ks + BT * LD;       // BT x LD
  float* dss = vs + BT * LD;      // BT x LP: dS[query][key]
  float* lse_s = dss + BT * LP;   // BT
  float* delta_s = lse_s + BT;    // BT

  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long row_off = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  load_tile<T, DP>(qs, q + row_off * d, q0, BT, sq, d);
  load_tile<T, DP>(dos, dout + row_off * dvw, q0, BT, sq, dvw);
  load_stats<kThreads>(lse_s, delta_s, lse + row_off, delta + row_off, q0,
                       BT, sq);

  // dQ of rows ty + 16 i, columns tx + 16 j.
  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;

  // Keys that any row of this tile may see.
  const int k_hi = m.causal ? min(sk, q0 + BT) : sk;
  const int k_lo = m.window > 0 ? max(0, q0 - m.window + 1) : 0;

  for (int k0 = (k_lo / BT) * BT; k0 < k_hi; k0 += BT) {
    __syncthreads();  // the last tile's reads are done (and Q is in)
    load_tile<T, DP>(ks, k + k_row * d, k0, BT, sk, d);
    load_tile<T, DP>(vs, v + k_row * dvw, k0, BT, sk, dvw);
    __syncthreads();

    float s[R][R], dp[R][R];
    dots<DP, R>(qs, dos, ks, vs, d, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + kSide * i, c = tx + kSide * j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], q0 + r, k0 + c, m,
                 p, ds);
        dss[r * LP + c] = ds;
      }
    __syncthreads();

    // dQ += dS K.
#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty + kSide * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = ks[kk * LD + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + kSide * i;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + kSide * j;
      if (c < d)
        dq[(row_off + r) * d + c] = from_f32<T>(acc[i][j] * m.scale);
    }
  }
}

// ---- bf16 on the tensor cores: wgmma fed by TMA (D <= 192) ------------------

namespace wg {

using namespace sm90;

constexpr int kConsumers = 2;  // consumer warpgroups, threads 0 to 255
constexpr int kProducer = 32;  // the producer warp, threads 256 to 287
constexpr int kThreads = 128 * kConsumers + kProducer;
constexpr int kKeys = 64;      // keys a dK/dV block
constexpr int kRows = 64 * kConsumers;  // queries a dQ block
constexpr int kSmemCap = 227 * 1024;
constexpr int kBarBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// The routes' codes, as the wrapper passes them.
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLdst = 2, kTf32x3 = 3 };

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }
// Ring stages (at most 4) that fit beside `fixed` bytes when `blocks`
// blocks share a multiprocessor (1 KB of it reserved a block; 1 KB of
// each block's for alignment, and its barriers).
constexpr int stages_for(int fixed, int stage, int blocks) {
  const int room =
      (kSmemCap - 1024 * blocks) / blocks - 1024 - kBarBytes - fixed;
  return room / stage < 4 ? room / stage : 4;
}

// dK/dV: the block's K (kKeys x DP) and V (kKeys x DVP), two buffers of
// P^T (times the softcap's derivative) in f32 handed from one consumer to
// the other, then the ring, each stage a query tile's Q (BQ x DP), dO (BQ
// x DVP), lse and delta.  BQ keeps a consumer's registers (its gradient,
// one 64 x BQ product and its bf16 copy) within ptxas's 168 a thread at
// one block a multiprocessor; at D 64 two blocks share one (96 each).
template <int DP, int DVP>
struct CfgKV {
  static constexpr int BQ = DP <= 128 ? 64 : 32, kBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kK = kKeys * DP * 2, kV = kKeys * DVP * 2;
  static constexpr int kP = BQ / 2 * 128 * 4;
  static constexpr int kQ = BQ * DP * 2, kO = BQ * DVP * 2;
  static constexpr int kStage = round1k(kQ + kO + 2 * BQ * 4);
  static constexpr int kFixed = kK + kV + 2 * kP;
  static constexpr int kStages = stages_for(kFixed, kStage, kBlocks);
  static constexpr int kSmem = 1024 + kFixed + kStages * kStage + kBarBytes;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// dQ: the block's Q (kRows x DP), dO (kRows x DVP), lse and delta, then
// the ring, each stage a key tile's K (BK x DP) and V (BK x DVP).  BK 32
// at D 192 (the dQ accumulator takes 96 registers) and at D 64 (two
// blocks a multiprocessor).
template <int DP, int DVP>
struct CfgQ {
  static constexpr int BK = DP == 128 ? 64 : 32, kBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kQ = kRows * DP * 2, kO = kRows * DVP * 2;
  static constexpr int kK = BK * DP * 2, kV = BK * DVP * 2;
  static constexpr int kStage = kK + kV;
  static constexpr int kFixed = round1k(kQ + kO + 2 * kRows * 4);
  static constexpr int kStages = stages_for(kFixed, kStage, kBlocks);
  static constexpr int kSmem = 1024 + kFixed + kStages * kStage + kBarBytes;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// `rows` rows of a row-major (n_rows, d) source, from row0 on, into a
// swizzled tile of COLS columns (sm90.cuh), zeros past n_rows and past d,
// by the producer's threads (this is thread t) with plain loads: any
// alignment.
template <int COLS>
__device__ __forceinline__ void copy_tile(void* dst, const bf16* src,
                                          int row0, int rows, int n_rows,
                                          int d, int t) {
  constexpr int kUnits = COLS / 8;  // 16-byte units a row
  unsigned char* out = static_cast<unsigned char*>(dst);
  for (int e = t; e < rows * kUnits; e += kProducer) {
    const int r = e / kUnits, u = e % kUnits, c = u * 8, g = row0 + r;
    const int n = g < n_rows ? max(0, min(8, d - c)) : 0;
    const bf16* from = src + static_cast<long long>(g) * d + c;
    alignas(16) bf16 t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      t[i] = i < n ? from[i] : __float2bfloat16(0.0f);
    *reinterpret_cast<uint4*>(out + (u >> 3) * rows * 128 + r * 128 +
                              (((u & 7) ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(t);
  }
}

// The statistics of the wgmma kernels: for every query head, lse log2 e
// (for exp2) and delta, each in rows padded to a multiple of kRows with
// zeros, so that a tile's are one aligned bulk copy.
__host__ __device__ constexpr long long padded_rows(int sq) {
  return (sq + kRows - 1) / kRows * kRows;
}

__global__ void __launch_bounds__(256)
stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ lse2,
             float* __restrict__ delta, long long rows, int sq, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long sqp = padded_rows(sq), hq = row / sqp;
  const int r = static_cast<int>(row - hq * sqp);
  float sum = 0.0f;
  if (r < sq) {
    const long long g = (hq * sq + r) * d;
    for (int c = lane; c < d; c += 32)
      sum = fmaf(to_f32(o[g + c]), to_f32(dout[g + c]), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    delta[row] = sum;
    lse2[row] = r < sq ? lse[hq * sq + r] * kLog2e : 0.0f;
  }
}

// `rows` rows of the padded statistics from row0 on, by the producer's
// thread t (plain loads).
__device__ __forceinline__ void copy_stats(float* lse_s, float* delta_s,
                                           const float* lse2,
                                           const float* delta, long long row0,
                                           int rows, int t) {
  for (int r = t; r < rows; r += kProducer) {
    lse_s[r] = lse2[row0 + r];
    delta_s[r] = delta[row0 + r];
  }
}

__device__ __forceinline__ bool live(int qp, int kp, const Mask& m) {
  return qp < m.sq && kp < m.sk && (!m.causal || qp >= kp) &&
         (m.window <= 0 || qp - kp < m.window);
}

// P of an unmasked pair from its q.k and its row's lse2 = lse log2 e, with
// dcap = d(capped S) / dS.
__device__ __forceinline__ float prob(float qk, float lse2, const Mask& m,
                                      float& dcap) {
  if (m.softcap > 0.0f) {
    const float t = tanhf(qk * m.scale / m.softcap);
    dcap = 1.0f - t * t;
    return exp2f(fmaf(m.softcap * t, kLog2e, -lse2));
  }
  dcap = 1.0f;
  return exp2f(fmaf(qk, m.scale * kLog2e, -lse2));
}

// The register A operand of the 16-column chunk kc of an accumulator.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&s)[N], int kc,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = mma_bf16::pack_bf16(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
}

// The descriptor of 16-column step kk of a K-major operand whose chunks
// hold `rows` rows, from the descriptor of the tile.
__device__ __forceinline__ uint64_t k_major(uint64_t tile, int rows, int kk) {
  return desc_add(tile, (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// Step kc (16 rows) of 64-column chunk n of an MN-major operand.
__device__ __forceinline__ uint64_t mn_major(uint64_t tile, int rows, int n,
                                             int kc) {
  return desc_add(tile, n * rows * 128 + kc * 2048);
}

// The shared memory of a block, rounded up to 1024 bytes (the swizzle's
// period).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, CfgKV<DP, DVP>::kBlocks)
dkdv_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int hkv,
               int sq, int sk, int d, int dvw, Mask m, int tma) {
  using C = CfgKV<DP, DVP>;
  constexpr int BQ = C::BQ, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* ks = base;                 // kKeys x DP
  unsigned char* vs = base + C::kK;         // kKeys x DVP
  float* pbuf = reinterpret_cast<float*>(base + C::kK + C::kV);  // 2 x kP
  unsigned char* ring = base + C::kFixed;   // S stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStage);
  uint64_t* empty = full + S;
  uint64_t* kv_full = empty + S;
  uint64_t* p_full = kv_full + 1;   // 2: P^T of a tile written
  uint64_t* p_empty = p_full + 2;   // 2: and read

  const int k0 = blockIdx.x * kKeys, kh = blockIdx.y, bb = blockIdx.z;
  const int group = h / hkv;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  // The query tiles that any key of the block may be seen by, for each
  // head of the group.
  const int q_lo = m.causal ? k0 : 0;
  const int q_hi = m.window > 0 ? min(sq, k0 + kKeys - 1 + m.window) : sq;
  const int t0 = q_lo / BQ;
  const int n_qt = q_hi > t0 * BQ ? (q_hi - t0 * BQ + BQ - 1) / BQ : 0;
  const int n_tiles = group * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, tma ? 1 : kProducer);
      mbar_init(empty + s, 128 * kConsumers);
    }
    mbar_init(kv_full, tma ? 1 : kProducer);
    for (int b = 0; b < 2; ++b) {
      mbar_init(p_full + b, 128);
      mbar_init(p_empty + b, 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The role, warp-uniform in the compiler's eyes: consumer 0 (S^T, P^T,
  // dV), consumer 1 (dP^T, dS^T, dK), or the producer.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (role == kConsumers) {
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma) {
      if (t == 0) {  // one thread issues every load
        const int kv_head = bb * hkv + kh;
        mbar_expect_tx(kv_full, C::kK + C::kV);
        for (int c = 0; c < DP / 64; ++c)
          tma_load_3d(ks + c * kKeys * 128, &tm_k, kv_full, 64 * c, k0,
                      kv_head);
        for (int c = 0; c < DVP / 64; ++c)
          tma_load_3d(vs + c * kKeys * 128, &tm_v, kv_full, 64 * c, k0,
                      kv_head);
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % S;
          mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          const int hq = bb * h + kh * group + it / n_qt;
          const int q0 = (t0 + it % n_qt) * BQ;
          unsigned char* st = ring + s * C::kStage;
          mbar_expect_tx(full + s, C::kQ + C::kO + 2 * BQ * 4);
          for (int c = 0; c < DP / 64; ++c)
            tma_load_3d(st + c * BQ * 128, &tm_q, full + s, 64 * c, q0, hq);
          for (int c = 0; c < DVP / 64; ++c)
            tma_load_3d(st + C::kQ + c * BQ * 128, &tm_do, full + s, 64 * c,
                        q0, hq);
          const long long row = hq * padded_rows(sq) + q0;
          bulk_load(st + C::kQ + C::kO, lse2 + row, BQ * 4, full + s);
          bulk_load(st + C::kQ + C::kO + BQ * 4, delta + row, BQ * 4,
                    full + s);
        }
      }
    } else {
      copy_tile<DP>(ks, k + k_row * d, k0, kKeys, sk, d, t);
      copy_tile<DVP>(vs, v + k_row * dvw, k0, kKeys, sk, dvw, t);
      fence_proxy_async();
      mbar_arrive(kv_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(empty + s, ((it / S) & 1) ^ 1);
        const int hq = bb * h + kh * group + it / n_qt;
        const long long row_off = static_cast<long long>(hq) * sq;
        const int q0 = (t0 + it % n_qt) * BQ;
        unsigned char* st = ring + s * C::kStage;
        float* ls = reinterpret_cast<float*>(st + C::kQ + C::kO);
        copy_tile<DP>(st, q + row_off * d, q0, BQ, sq, d, t);
        copy_tile<DVP>(st + C::kQ, dout + row_off * dvw, q0, BQ, sq, dvw, t);
        copy_stats(ls, ls + BQ, lse2, delta, hq * padded_rows(sq) + q0, BQ,
                   t);
        fence_proxy_async();
        mbar_arrive(full + s);
      }
    }
  } else {
    // The consumers share the block's 64 keys: consumer 0 computes S^T =
    // K Q^T, P^T and dV += P^T dO, and hands P^T (times the softcap's
    // derivative) to consumer 1 through shared memory; consumer 1
    // computes dP^T = V dO^T, dS^T and dK += dS^T Q.  Each holds one of
    // the two gradients and one BQ-wide product in registers, and each
    // runs two of the four products.  R, the role, is a constant in each
    // instance of the body.
    auto consume = [&](auto role_c) {
      constexpr int R = decltype(role_c)::value;
      constexpr int NA = (R == 0 ? DVP : DP) / 64;  // the gradient's chunks
      constexpr int KS = (R == 0 ? DP : DVP) / 16;  // the product's k-steps
      const int tid = threadIdx.x & 127;
      const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2;
      const int t4 = lane & 3;
      const int key_a = k0 + warp * 16 + g8, key_b = key_a + 8;
      const uint64_t kv_d = desc_sw128(smem_u32(R == 0 ? ks : vs));
      const uint32_t ring_a = smem_u32(ring);
      float acc[NA][32];
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.0f;

      mbar_wait(kv_full, 0);
      int n_live = 0;  // tiles computed, for the P^T buffers' phases
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(full + s, (it / S) & 1);
        const int q0 = (t0 + it % n_qt) * BQ;
        const bool skip = k0 >= sk || (m.causal && q0 + BQ - 1 < k0) ||
                          (m.window > 0 && q0 - (k0 + kKeys - 1) >= m.window);
        if (!skip) {
          const uint32_t st_a = ring_a + s * C::kStage;
          const uint64_t qs_d = desc_sw128(st_a);
          const uint64_t os_d = desc_sw128(st_a + C::kQ);
          const float* ls = reinterpret_cast<const float*>(
              ring + s * C::kStage + C::kQ + C::kO);
          const int b = n_live & 1;
          const uint32_t b_phase = (n_live >> 1) & 1;
          float* pb = pbuf + b * (BQ / 2) * 128 + tid;
          ++n_live;

          // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1): 64
          // keys x BQ queries.
          float x[BQ / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss<BQ>(x, k_major(kv_d, kKeys, kk),
                         k_major(R == 0 ? qs_d : os_d, BQ, kk), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(x);

          if constexpr (R == 0) {
            // P^T, masked only where the tile crosses an edge; P^T dcap
            // to consumer 1.
            const bool inside =
                k0 + kKeys - 1 < sk && q0 + BQ - 1 < sq &&
                (!m.causal || q0 >= k0 + kKeys - 1) &&
                (m.window <= 0 || q0 + BQ - 1 - k0 < m.window);
            mbar_wait(p_empty + b, b_phase ^ 1);
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) {
              const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);  // the query
              float dcap;
              float p = prob(x[i], ls[c], m, dcap);
              if (!inside && !live(q0 + c, (i & 2) ? key_b : key_a, m))
                p = 0.0f;
              x[i] = p;
              pb[i * 128] = p * dcap;
            }
            mbar_arrive(p_full + b);
          } else {
            // dS^T = P^T dcap (dP^T - delta).
            const float* dl = ls + BQ;
            mbar_wait(p_full + b, b_phase);
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) {
              const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
              x[i] = pb[i * 128] * (x[i] - dl[c]);
            }
            mbar_arrive(p_empty + b);
          }

          // dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1), with
          // P^T or dS^T rounded to bf16 as the register A operand.
          const uint64_t b_d = R == 0 ? os_d : qs_d;
          uint32_t xa[BQ / 16][4];
#pragma unroll
          for (int kc = 0; kc < BQ / 16; ++kc) acc_to_a(x, kc, xa[kc]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
            for (int n = 0; n < NA; ++n)
              wgmma_rs_n64_tb(acc[n], xa[kc], mn_major(b_d, BQ, n, kc));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int n = 0; n < NA; ++n) fence_regs(acc[n]);
#pragma unroll
          for (int kc = 0; kc < BQ / 16; ++kc) fence_regs(xa[kc]);
        }
        mbar_arrive(empty + s);
      }

      // Consumer 0 writes dV, consumer 1 dK (times the scale).
      bf16* out = R == 0 ? dv : dk;
      const int width = R == 0 ? dvw : d;
      const float mul = R == 0 ? 1.0f : m.scale;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = (i & 2) ? key_b : key_a;
        if (key >= sk) continue;
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
#pragma unroll
        for (int n = 0; n < NA; ++n)
          if (64 * n + c < width)
            out[(k_row + key) * width + 64 * n + c] =
                __float2bfloat16_rn(acc[n][i] * mul);
      }
    };
    if (role == 0)
      consume(std::integral_constant<int, 0>());
    else
      consume(std::integral_constant<int, 1>());
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, CfgQ<DP, DVP>::kBlocks)
dq_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             bf16* __restrict__ dq, int h, int hkv, int sq, int sk, int d,
             int dvw, Mask m, int tma) {
  using C = CfgQ<DP, DVP>;
  constexpr int S = C::kStages, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* qs = base;                 // kRows x DP
  unsigned char* os = base + C::kQ;         // kRows x DVP
  float* ls = reinterpret_cast<float*>(base + C::kQ + C::kO);  // kRows
  float* dl = ls + kRows;                                       // kRows
  unsigned char* ring = base + C::kFixed;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStage);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kv_head = bb * hkv + hh / (h / hkv);
  const long long row_off = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = static_cast<long long>(kv_head) * sk;
  const long long stat_row = (static_cast<long long>(bb) * h + hh) *
                                 padded_rows(sq) + q0;
  // The key tiles that any row of the block may see.
  const int k_hi = m.causal ? min(sk, q0 + kRows) : sk;
  const int k_lo = m.window > 0 ? max(0, q0 - m.window + 1) : 0;
  const int t0 = k_lo / BK;
  const int n_tiles = k_hi > t0 * BK ? (k_hi - t0 * BK + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, tma ? 1 : kProducer);
      mbar_init(empty + s, 128 * kConsumers);
    }
    mbar_init(q_full, tma ? 1 : kProducer);
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (role == kConsumers) {
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma) {
      if (t == 0) {  // one thread issues every load
        const int q_head = bb * h + hh;
        mbar_expect_tx(q_full, C::kQ + C::kO + 2 * kRows * 4);
        for (int c = 0; c < DP / 64; ++c)
          tma_load_3d(qs + c * kRows * 128, &tm_q, q_full, 64 * c, q0, q_head);
        for (int c = 0; c < DVP / 64; ++c)
          tma_load_3d(os + c * kRows * 128, &tm_do, q_full, 64 * c, q0,
                      q_head);
        bulk_load(ls, lse2 + stat_row, kRows * 4, q_full);
        bulk_load(dl, delta + stat_row, kRows * 4, q_full);
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % S, k0 = (t0 + it) * BK;
          mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          unsigned char* st = ring + s * C::kStage;
          mbar_expect_tx(full + s, C::kK + C::kV);
          for (int c = 0; c < DP / 64; ++c)
            tma_load_3d(st + c * BK * 128, &tm_k, full + s, 64 * c, k0,
                        kv_head);
          for (int c = 0; c < DVP / 64; ++c)
            tma_load_3d(st + C::kK + c * BK * 128, &tm_v, full + s, 64 * c,
                        k0, kv_head);
        }
      }
    } else {
      copy_tile<DP>(qs, q + row_off * d, q0, kRows, sq, d, t);
      copy_tile<DVP>(os, dout + row_off * dvw, q0, kRows, sq, dvw, t);
      copy_stats(ls, dl, lse2, delta, stat_row, kRows, t);
      fence_proxy_async();
      mbar_arrive(q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S, k0 = (t0 + it) * BK;
        mbar_wait(empty + s, ((it / S) & 1) ^ 1);
        unsigned char* st = ring + s * C::kStage;
        copy_tile<DP>(st, k + k_row * d, k0, BK, sk, d, t);
        copy_tile<DVP>(st + C::kK, v + k_row * dvw, k0, BK, sk, dvw, t);
        fence_proxy_async();
        mbar_arrive(full + s);
      }
    }
  } else {
    // A consumer: 64 queries, dQ of them in f32 registers.
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
    const int qw = q0 + 64 * role;  // the warpgroup's first query
    const int r_a = 64 * role + warp * 16 + g8, r_b = r_a + 8;  // block rows
    const uint64_t qs_d = desc_sw128(smem_u32(qs) + role * 64 * 128);
    const uint64_t os_d = desc_sw128(smem_u32(os) + role * 64 * 128);
    const uint32_t ring_a = smem_u32(ring);

    float dq_acc[DP / 64][32];
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[n][i] = 0.0f;

    mbar_wait(q_full, 0);
    const float lse_a = ls[r_a], lse_b = ls[r_b];
    const float dl_a = dl[r_a], dl_b = dl[r_b];
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S, k0 = (t0 + it) * BK;
      mbar_wait(full + s, (it / S) & 1);
      const bool skip = qw >= sq || (m.causal && k0 > qw + 63) ||
                        (m.window > 0 && qw - (k0 + BK - 1) >= m.window);
      if (!skip) {
        const uint64_t kt_d = desc_sw128(ring_a + s * C::kStage);
        const uint64_t vt_d = desc_sw128(ring_a + s * C::kStage + C::kK);

        // S = Q K^T and dP = dO V^T: 64 queries x BK keys.
        float sa[BK / 2], dpa[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BK>(sa, k_major(qs_d, kRows, kk), k_major(kt_d, BK, kk),
                        kk > 0);
#pragma unroll
        for (int kk = 0; kk < DVP / 16; ++kk)
          wgmma_ss<BK>(dpa, k_major(os_d, kRows, kk),
                        k_major(vt_d, BK, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(dpa);

        // dS (masked only where the tile crosses an edge) as the A
        // operand of dQ += dS K.
        const bool inside = qw + 63 < sq && k0 + BK - 1 < sk &&
                            (!m.causal || qw >= k0 + BK - 1) &&
                            (m.window <= 0 || qw + 63 - k0 < m.window);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const bool lower = (i & 2) != 0;
          const int kp = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          float dcap;
          float p = prob(sa[i], lower ? lse_b : lse_a, m, dcap);
          if (!inside && !live(q0 + (lower ? r_b : r_a), kp, m)) p = 0.0f;
          sa[i] = p * (dpa[i] - (lower ? dl_b : dl_a)) * dcap;
        }
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) acc_to_a(sa, kc, da[kc]);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
          for (int n = 0; n < DP / 64; ++n)
            wgmma_rs_n64_tb(dq_acc[n], da[kc], mn_major(kt_d, BK, n, kc));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < DP / 64; ++n) fence_regs(dq_acc[n]);
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) fence_regs(da[kc]);
      }
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = q0 + ((i & 2) ? r_b : r_a);
      if (r >= sq) continue;
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
#pragma unroll
      for (int n = 0; n < DP / 64; ++n)
        if (64 * n + c < d)
          dq[(row_off + r) * d + 64 * n + c] =
              __float2bfloat16_rn(dq_acc[n][i] * m.scale);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time: the build
// links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a contiguous (heads, rows, cols) bf16 tensor in boxes of 64
// columns x box_rows rows of one head, 128-byte swizzled, zeros out of
// range.  TMA wants a 16-byte aligned base and row (cols % 8 == 0).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int cols, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The statistics into `scratch` (2 b h padded_rows(sq) floats), then the
// dK/dV and dQ kernels.
template <int DP, int DVP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dout, float* scratch, bf16* dq,
           bf16* dk, bf16* dv, int b, int h, int hkv, int sq, int sk, int d,
           int dvw, const Mask& m, int route, cudaStream_t s) {
  using A = CfgKV<DP, DVP>;
  using B = CfgQ<DP, DVP>;
  // Zeros for wgmma-ldst, whose kernels read no map.
  CUtensorMap aq{}, ak{}, av{}, ao{}, bq{}, bk{}, bv{}, bo{};
  const int tma = route == kWgmmaTma;
  if (tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (!(make_map(enc, &aq, q, d, sq, b * h, A::BQ) &&
          make_map(enc, &ak, k, d, sk, b * hkv, kKeys) &&
          make_map(enc, &av, v, dvw, sk, b * hkv, kKeys) &&
          make_map(enc, &ao, dout, dvw, sq, b * h, A::BQ) &&
          make_map(enc, &bq, q, d, sq, b * h, kRows) &&
          make_map(enc, &bk, k, d, sk, b * hkv, B::BK) &&
          make_map(enc, &bv, v, dvw, sk, b * hkv, B::BK) &&
          make_map(enc, &bo, dout, dvw, sq, b * h, kRows)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(b) * h * padded_rows(sq);
  float* lse2 = scratch;
  float* delta = scratch + rows;
  stats_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      o, dout, lse, lse2, delta, rows, sq, dvw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_wg_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             A::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_wg_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_wg_kernel<DP, DVP><<<dim3((sk + kKeys - 1) / kKeys, hkv, b), kThreads,
                            A::kSmem, s>>>(aq, ak, av, ao, q, k, v, dout,
                                           lse2, delta, dk, dv, h, hkv, sq, sk,
                                           d, dvw, m, tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wg_kernel<DP, DVP><<<dim3((sq + kRows - 1) / kRows, h, b), kThreads,
                          B::kSmem, s>>>(bq, bk, bv, bo, q, k, v, dout, lse2,
                                         delta, dq, h, hkv, sq, sk, d, dvw, m,
                                         tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// delta = rowsum(dO * O) of every query row.
template <typename T>
cudaError_t launch_delta(const T* o, const T* dout, float* delta, int b,
                         int h, int sq, int d, cudaStream_t s) {
  const long long rows = static_cast<long long>(b) * h * sq;
  const long long rows_per_block = kThreads / 32;
  delta_kernel<T><<<static_cast<unsigned>((rows + rows_per_block - 1) /
                                          rows_per_block),
                    kThreads, 0, s>>>(o, dout, delta, rows, d);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- f32 on the tensor cores: split TF32 (route tf32x3) ---------------------

namespace tf {

using namespace mma_tf32;
using wg::live;
using wg::prob;
constexpr int kThreads = 256;  // eight warps, two of each 16-row slice
constexpr int kKeys = 64;      // keys a dK/dV block
constexpr int kRows = 64;      // queries a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// Named barrier `id` (1-4; 0 is __syncthreads') of one warp pair.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// dK/dV: the block's K (kKeys x DP) and V (kKeys x DVP), two stages, each
// a query tile's Q (BQ x DP), dO (BQ x DVP), lse log2 e and delta, and
// the four warp pairs' P^T dcap (16 x BQ each).  Rows padded to LD = DP +
// 4 and LDV = DVP + 4 floats (mma_tf32.cuh).  78, 144, 177, 209 and 204 KB
// of shared memory at DP / DVP 64, 128, 192 / 128 and 256 (BQ 16); two
// blocks an SM at DP 64, where 128 registers a thread are enough.
template <int DP, int DVP>
struct CfgKV {
  static constexpr int BQ = DP <= 192 ? 32 : 16, kBlocks = DP <= 64 ? 2 : 1;
  static constexpr int LD = DP + 4, LDV = DVP + 4;
  static constexpr int kStage = BQ * (LD + LDV) + 2 * BQ;  // floats
  static constexpr int kP = 4 * 16 * BQ;
  static constexpr size_t kSmem =
      sizeof(float) * (kKeys * (LD + LDV) + 2 * kStage + kP);
};

// dQ: the block's Q (kRows x DP), dO (kRows x DVP), lse log2 e and delta,
// then two stages of a key tile's K (BK x DP) and V (BK x DVP), half of
// its keys to each warp of a pair: 105, 203, 168 and 200 KB (BK 64 up to
// DP 128, 32 at 192, 16 at 256); two blocks an SM at DP 64.
template <int DP, int DVP>
struct CfgQ {
  static constexpr int BK = DP <= 128 ? 64 : DP <= 192 ? 32 : 16;
  static constexpr int kBlocks = DP <= 64 ? 2 : 1;
  static constexpr int LD = DP + 4, LDV = DVP + 4;
  static constexpr int kFixed = kRows * (LD + LDV) + 2 * kRows;  // floats
  static constexpr int kStage = BK * (LD + LDV);
  static constexpr size_t kSmem = sizeof(float) * (kFixed + 2 * kStage);
  static_assert(2 * kStage >= 64 * DP, "the ring holds the dQ partials");
};

// lse log2 e and delta of `rows` query rows from row0 on (0 past n_rows)
// into ls and ls + rows.
__device__ __forceinline__ void load_stats(float* ls, const float* lse,
                                           const float* delta, int row0,
                                           int rows, int n_rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int g = row0 + r;
    ls[r] = g < n_rows ? lse[g] * kLog2e : 0.0f;
    ls[rows + r] = g < n_rows ? delta[g] : 0.0f;
  }
}

// Warps w and w + 4 share the block's keys 16 (w % 4)..: warp w (role 0)
// computes S^T = K Q^T, P^T and dV += P^T dO, and hands P^T dcap to warp
// w + 4 (role 1) through shared memory and a named barrier of the pair;
// warp w + 4 computes dP^T = V dO^T, dS^T = P^T dcap (dP^T - delta) and
// dK += dS^T Q.  Each holds one gradient in f32 registers and runs two of
// the four products.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, CfgKV<DP, DVP>::kBlocks)
dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int h, int hkv, int sq, int sk,
                 int d, int dvw, Mask m, int vec) {
  using C = CfgKV<DP, DVP>;
  constexpr int BQ = C::BQ, LD = C::LD, LDV = C::LDV;
  constexpr int QT = BQ / 8;  // 8-query tiles of S^T
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;                  // kKeys x LD
  float* vs = ks + kKeys * LD;         // kKeys x LDV
  float* ring = vs + kKeys * LDV;      // two stages of C::kStage floats
  float* pbuf = ring + 2 * C::kStage;  // four pairs' 16 x BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3, wr = warp & 3;
  const int k0 = blockIdx.x * kKeys, kh = blockIdx.y, bb = blockIdx.z;
  const int group = h / hkv;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  const int kw = k0 + wr * 16;                     // the pair's first key
  const int key_a = kw + (lane >> 2), key_b = key_a + 8;  // this lane's
  // The query tiles that any key of the block may be seen by, for each
  // head of the group.
  const int q_lo = m.causal ? k0 : 0;
  const int q_hi = m.window > 0 ? min(sq, k0 + kKeys - 1 + m.window) : sq;
  const int t0 = q_lo / BQ;
  const int n_qt = q_hi > t0 * BQ ? (q_hi - t0 * BQ + BQ - 1) / BQ : 0;
  const int n_tiles = group * n_qt;

  load_rows<DP, LD, kThreads>(ks, k + k_row * d, k0, kKeys, sk, d, vec);
  load_rows<DVP, LDV, kThreads>(vs, v + k_row * dvw, k0, kKeys, sk, dvw,
                                vec);
  // Tile it of the ring: head it / n_qt of the group, query tile it % n_qt.
  auto load_tile = [&](int it) {
    float* st = ring + (it & 1) * C::kStage;
    const long long row_off =
        (static_cast<long long>(bb) * h + kh * group + it / n_qt) * sq;
    const int q0 = (t0 + it % n_qt) * BQ;
    load_rows<DP, LD, kThreads>(st, q + row_off * d, q0, BQ, sq, d, vec);
    load_rows<DVP, LDV, kThreads>(st + BQ * LD, dout + row_off * dvw, q0, BQ,
                                  sq, dvw, vec);
    load_stats(st + BQ * (LD + LDV), lse + row_off, delta + row_off, q0, BQ,
               sq);
  };
  if (n_tiles > 0) load_tile(0);
  mma_bf16::cp_async_commit();

  // R, the role, is a constant in each instance of the body.
  auto consume = [&](auto role_c) {
    constexpr int R = decltype(role_c)::value;
    constexpr int NG = (R == 0 ? DVP : DP) / 32;  // the gradient's groups
    float acc[NG][4][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][j][e] = 0.0f;
    float* pb = pbuf + wr * 16 * BQ + lane;  // in fragment order
    for (int it = 0; it < n_tiles; ++it) {
      mma_bf16::cp_async_wait_all();
      __syncthreads();  // tile it (and K, V) in; the other stage is free
      if (it + 1 < n_tiles) load_tile(it + 1);
      mma_bf16::cp_async_commit();
      const int q0 = (t0 + it % n_qt) * BQ;
      if (kw >= sk || (m.causal && q0 + BQ - 1 < kw) ||
          (m.window > 0 && q0 - (kw + 15) >= m.window))
        continue;  // the pair's keys see none of the tile's queries
      const float* qst = ring + (it & 1) * C::kStage;
      const float* ost = qst + BQ * LD;
      const float* ls = ost + BQ * LDV;
      float x[QT][4];
      if constexpr (R == 0) {
        // S^T = K Q^T: 16 keys x BQ queries; P^T (masked only where the
        // tile crosses an edge) in x, P^T dcap to the pair's other warp.
        const bool inside = kw + 15 < sk && q0 + BQ - 1 < sq &&
                            (!m.causal || q0 >= kw + 15) &&
                            (m.window <= 0 || q0 + BQ - 1 - kw < m.window);
        product_t<QT, DP, LD>(x, ks, wr * 16, qst, lane);
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t4 + (e & 1);  // the query
            float dcap;
            float p = prob(x[j][e], ls[c], m, dcap);
            if (!inside && !live(q0 + c, e < 2 ? key_a : key_b, m)) p = 0.0f;
            x[j][e] = p;
            pb[(4 * j + e) * 32] = p * dcap;
          }
        pair_arrive(1 + wr);
        add_product<QT, NG, LDV>(acc, x, ost, lane);  // dV += P^T dO
      } else {
        // dP^T = V dO^T, then dS^T = P^T dcap (dP^T - delta).
        const float* dl = ls + BQ;
        product_t<QT, DVP, LDV>(x, vs, wr * 16, ost, lane);
        pair_sync(1 + wr);
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = pb[(4 * j + e) * 32] *
                      (x[j][e] - dl[8 * j + 2 * t4 + (e & 1)]);
        add_product<QT, NG, LD>(acc, x, qst, lane);  // dK += dS^T Q
      }
    }
    mma_bf16::cp_async_wait_all();

    // Role 0 writes dV, role 1 dK (times the scale).
    float* out = R == 0 ? dv : dk;
    const int width = R == 0 ? dvw : d;
    const float mul = R == 0 ? 1.0f : m.scale;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = e < 2 ? key_a : key_b;
      if (key >= sk) continue;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 32 * n + acc_col(t4, j, e);
          if (c < width) out[(k_row + key) * width + c] = acc[n][j][e] * mul;
        }
    }
  };
  if (warp < 4)
    consume(std::integral_constant<int, 0>());
  else
    consume(std::integral_constant<int, 1>());
}

// Warps w and w + 4 share the block's query rows 16 (w % 4)..; each takes
// half of every key tile, and the two partial dQ are summed in a fixed
// order at the end.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, CfgQ<DP, DVP>::kBlocks)
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int h, int hkv, int sq, int sk, int d,
               int dvw, Mask m, int vec) {
  using C = CfgQ<DP, DVP>;
  constexpr int BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int KW = BK / 2;  // keys a warp of a tile
  constexpr int KT = KW / 8;  // its 8-key tiles of S
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                // kRows x LD
  float* os = qs + kRows * LD;       // kRows x LDV
  float* ls = os + kRows * LDV;      // kRows: lse log2 e
  float* dl = ls + kRows;            // kRows: delta
  float* ring = smem_f + C::kFixed;  // two stages of K (BK x LD), V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3, wr = warp & 3, half = warp >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long row_off = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  // The key tiles that any row of the block may see.
  const int k_hi = m.causal ? min(sk, q0 + kRows) : sk;
  const int k_lo = m.window > 0 ? max(0, q0 - m.window + 1) : 0;
  const int t0 = k_lo / BK;
  const int n_tiles = k_hi > t0 * BK ? (k_hi - t0 * BK + BK - 1) / BK : 0;

  load_rows<DP, LD, kThreads>(qs, q + row_off * d, q0, kRows, sq, d, vec);
  load_rows<DVP, LDV, kThreads>(os, dout + row_off * dvw, q0, kRows, sq, dvw,
                                vec);
  load_stats(ls, lse + row_off, delta + row_off, q0, kRows, sq);
  auto load_tile = [&](int it) {
    float* st = ring + (it & 1) * C::kStage;
    const int k0 = (t0 + it) * BK;
    load_rows<DP, LD, kThreads>(st, k + k_row * d, k0, BK, sk, d, vec);
    load_rows<DVP, LDV, kThreads>(st + BK * LD, v + k_row * dvw, k0, BK, sk,
                                  dvw, vec);
  };
  if (n_tiles > 0) load_tile(0);
  mma_bf16::cp_async_commit();

  const int l_a = wr * 16 + (lane >> 2), l_b = l_a + 8;  // block rows
  const int r_a = q0 + l_a, r_b = q0 + l_b;
  const int w_lo = q0 + wr * 16, w_hi = w_lo + 15;  // the warp's rows
  float acc[DP / 32][4][4];
#pragma unroll
  for (int n = 0; n < DP / 32; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    mma_bf16::cp_async_wait_all();
    __syncthreads();  // tile it (and Q, dO) in; the other stage is free
    if (it + 1 < n_tiles) load_tile(it + 1);
    mma_bf16::cp_async_commit();
    const int k0 = (t0 + it) * BK + half * KW;  // the warp's keys
    if (w_lo >= sq || (m.causal && k0 > w_hi) ||
        (m.window > 0 && w_lo - (k0 + KW - 1) >= m.window))
      continue;  // the warp's rows see none of its keys
    const bool inside = w_hi < sq && k0 + KW - 1 < sk &&
                        (!m.causal || w_lo >= k0 + KW - 1) &&
                        (m.window <= 0 || w_hi - k0 < m.window);
    const float* kst = ring + (it & 1) * C::kStage + half * KW * LD;
    const float* vst = ring + (it & 1) * C::kStage + BK * LD + half * KW * LDV;

    // S = Q K^T and dP = dO V^T: 16 rows x KW keys.
    float s[KT][4], dp[KT][4];
    product_t<KT, DP, LD>(s, qs, wr * 16, kst, lane);
    product_t<KT, DVP, LDV>(dp, os, wr * 16, vst, lane);
    const float lse_a = ls[l_a], lse_b = ls[l_b];
    const float dl_a = dl[l_a], dl_b = dl[l_b];
    // dS = P (dP - delta) dcap, masked only where the tile crosses an edge.
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
        float dcap;
        float p = prob(s[j][e], e < 2 ? lse_a : lse_b, m, dcap);
        if (!inside && !live(e < 2 ? r_a : r_b, kp, m)) p = 0.0f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl_a : dl_b)) * dcap;
      }
    // dQ += dS K.
    add_product<KT, DP / 32, LD>(acc, s, kst, lane);
  }
  mma_bf16::cp_async_wait_all();

  // The pair's two partial dQ, summed in a fixed order: the second
  // warp's through the ring, which every warp is done with.
  __syncthreads();
  float* part = ring + wr * 32 + lane;  // in fragment order
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < DP / 32; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((n * 4 + j) * 4 + e) * 128] = acc[n][j][e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = e < 2 ? r_a : r_b;
    if (r >= sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 32; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * n + acc_col(t4, j, e);
        if (c < d)
          dq[(row_off + r) * d + c] =
              (acc[n][j][e] + part[((n * 4 + j) * 4 + e) * 128]) * m.scale;
      }
  }
}

// delta into `delta` (b h sq floats), then the dK/dV and dQ kernels.
template <int DP, int DVP>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* delta, float* dq,
           float* dk, float* dv, int b, int h, int hkv, int sq, int sk, int d,
           int dvw, const Mask& m, cudaStream_t s) {
  using A = CfgKV<DP, DVP>;
  using B = CfgQ<DP, DVP>;
  cudaError_t err = launch_delta(o, dout, delta, b, h, sq, dvw, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_tf32_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(A::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_tf32_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(B::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte rows: d and dv multiples of 4 and aligned bases.
  const int vec = d % 4 == 0 && dvw % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  dkdv_tf32_kernel<DP, DVP><<<dim3((sk + kKeys - 1) / kKeys, hkv, b),
                              kThreads, A::kSmem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, h, hkv, sq, sk, d, dvw, m, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tf32_kernel<DP, DVP><<<dim3((sq + kRows - 1) / kRows, h, b), kThreads,
                            B::kSmem, s>>>(q, k, v, dout, lse, delta, dq, h,
                                           hkv, sq, sk, d, dvw, m, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

// f32 on the split-TF32 kernels: heads padded to 64, 128, 192 (V to 128)
// or 256 (D 129-192 with Dv above 128, which no model has).
int launch_tf32(const float* q, const float* k, const float* v,
                const float* o, const float* lse, const float* dout,
                float* delta, float* dq, float* dk, float* dv, int b, int h,
                int hkv, int sq, int sk, int d, int dvw, const Mask& m,
                cudaStream_t s) {
  if (d <= 64)
    return tf::launch<64, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h,
                              hkv, sq, sk, d, dvw, m, s);
  if (d <= 128)
    return tf::launch<128, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, b,
                                h, hkv, sq, sk, d, dvw, m, s);
  if (d <= 192 && dvw <= 128)
    return tf::launch<192, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, b,
                                h, hkv, sq, sk, d, dvw, m, s);
  return tf::launch<256, 256>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h,
                              hkv, sq, sk, d, dvw, m, s);
}

// The CUDA-core kernels at head width DP.
template <typename T, int DP>
int launch(const T* q, const T* k, const T* v, const T* o, const float* lse,
           const T* dout, float* delta, T* dq, T* dk, T* dv, int b, int h,
           int hkv, int sq, int sk, int d, int dvw, const Mask& m,
           cudaStream_t s) {
  using C = Tile<DP>;
  constexpr size_t smem = C::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_delta(o, dout, delta, b, h, sq, dvw, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((sk + C::BT - 1) / C::BT, hkv, b);
  dkdv_kernel<T, DP><<<kv_grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, h, hkv, sq, sk, d, dvw, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((sq + C::BT - 1) / C::BT, h, b);
  dq_kernel<T, DP><<<q_grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, h, hkv, sq, sk, d, dvw, m);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the wgmma kernels: heads padded to 64, 128 or 192, V to 128
// where it fits at 192.
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const float* lse, const bf16* dout, float* scratch, bf16* dq,
                 bf16* dk, bf16* dv, int b, int h, int hkv, int sq, int sk,
                 int d, int dvw, const Mask& m, int route, cudaStream_t s) {
  if (d <= 64)
    return wg::launch<64, 64>(q, k, v, o, lse, dout, scratch, dq, dk, dv, b,
                              h, hkv, sq, sk, d, dvw, m, route, s);
  if (d <= 128)
    return wg::launch<128, 128>(q, k, v, o, lse, dout, scratch, dq, dk, dv,
                                b, h, hkv, sq, sk, d, dvw, m, route, s);
  if (dvw <= 128)
    return wg::launch<192, 128>(q, k, v, o, lse, dout, scratch, dq, dk, dv,
                                b, h, hkv, sq, sk, d, dvw, m, route, s);
  return wg::launch<192, 192>(q, k, v, o, lse, dout, scratch, dq, dk, dv, b,
                              h, hkv, sq, sk, d, dvw, m, route, s);
}

// bf16 above 192 on the CUDA-core kernels, the head padded to 256.
int launch_cuda_cores(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      void* delta, void* dq, void* dk, void* dv, int b, int h,
                      int hkv, int sq, int sk, int d, int dvw, const Mask& m,
                      cudaStream_t s) {
  return launch<bf16, 256>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, h, hkv, sq, sk, d,
      dvw, m, s);
}

}  // namespace

extern "C" {

// q, dq (b, h, sq, d); o, dout (b, h, sq, dv); k, dk (b, hkv, sk, d); v,
// dv (b, hkv, sk, dv); lse f32 (b, h, sq); all contiguous.  delta is f32
// scratch, 16-byte aligned: b h sq floats on routes 0 and 3, 2 b h
// ceil(sq / 128) 128 on routes 1 and 2.  dtype 0 is f32, 1 bf16 (q, k, v,
// o, dout and the gradients share it).  h % hkv == 0, 1 <= dv <= d <= 256;
// causal, window, softcap and scale as the forward's flash_launch.  route
// picks the kernels: 0 the CUDA cores (bf16, any input), 1 wgmma fed by
// TMA (bf16, d <= 192, d and dv multiples of 8, q, k, v and dout 16-byte
// aligned), 2 wgmma fed by plain loads (bf16, d <= 192, any alignment), 3
// split TF32 on the tensor cores (f32, any input).  Which route
// a call takes is the rule of flash_attention._bwd_route, its one source;
// here a route is only refused for inputs its kernels cannot take.
// Returns cudaGetLastError() (or the error of
// raising a block's shared memory limit, cudaErrorInvalidValue for an
// argument out of bounds or a tensor map the driver refuses, and
// cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled).
int flash_bwd_launch(int dtype, const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* delta, void* dq, void* dk, void* dv, int b, int h,
                     int hkv, int sq, int sk, int d, int dvw, float scale,
                     int causal, int window, float softcap, int route,
                     void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256 || dvw < 1 || dvw > d || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1, wgmma_fits = bf && d <= 192;
  const bool tma_fits = wgmma_fits && d % 8 == 0 && dvw % 8 == 0 &&
                        aligned16(q) && aligned16(k) && aligned16(v) &&
                        aligned16(dout);
  if ((route == wg::kWgmmaTma && !tma_fits) ||
      (route == wg::kWgmmaLdst && !wgmma_fits) ||
      (route == wg::kCudaCores && !bf) || (route == wg::kTf32x3 && bf) ||
      route < 0 || route > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask m{sq, sk, causal, window, scale, softcap};
  if (route == wg::kTf32x3)
    return launch_tf32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(delta), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), b, h, hkv, sq, sk,
        d, dvw, m, s);
  if (route != wg::kCudaCores)
    return launch_wgmma(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, h, hkv, sq, sk, d,
        dvw, m, route, s);
  return launch_cuda_cores(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h,
                           hkv, sq, sk, d, dvw, m, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
