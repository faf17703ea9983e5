// The backward pass of flash attention (K5) for Hopper (sm_90a): dQ, dK
// and dV from the forward's saved output O and per-row log-sum-exp.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention.py (_flash_kernel) has no backward.  Its counterpart is
// the JAX package's custom VJP of flash_chunked, _flash_chunked_bwd
// (src/repro/models/attention.py:257), which recomputes each chunk's
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
// into the D-padded tiles, so dO V^T and the padded columns of P^T dO
// sum zeros, and dV stores its Dv columns.
//
// What bounds it on the H100: operations, 5 products per unmasked (q, k)
// pair and head, S = q k^T, dP = dO v^T, dV, dQ, dK: 2 (3 D + 2 Dv) flops
// (10 D when Dv = D), at the bf16 tensor-core rate for bf16 inputs, the
// CUDA cores' f32 rate for f32.
//
// Design: three launches, no atomics, so the gradients are the same bits
// from run to run.  bf16 at D <= 128 runs the tensor-core kernels (tc
// below); f32, and bf16 at D > 128, the CUDA-core kernels described here.
//   1. delta: one warp a row, rowsum(dO * O) in f32 into a scratch vector.
//   2. dK, dV: one 256-thread block per (batch, KV head, key tile).  K and
//      V of the tile stay in shared memory; the block loops over the G
//      query heads of its group and over the query tiles that can see the
//      tile (the causal and window bands set the loop's bounds), loads Q,
//      dO, lse and delta of each, recomputes S and dO V^T (each thread 4 x
//      4 pairs at D <= 128), writes P and dS to shared memory, then adds
//      P^T dO and dS^T Q into dV and dK held in registers (each thread 4
//      keys x D/16 columns of both).  The group's sum happens inside the
//      block, so dK and dV are written once.
//   3. dQ: one 256-thread block per (batch, head, query tile), the
//      forward's layout: Q, dO, lse and delta stay in shared memory, the
//      block loops over the key tiles its rows see, recomputes S and
//      dO V^T, writes dS to shared memory and adds dS K into dQ in
//      registers.  The query tiles run in reverse order, so under a causal
//      mask the longest rows start first.
// Tiles are 64 queries and 64 keys (32 at D 256, for shared memory: 166 KB
// a block at D 128, 140 KB at D 256); the head dimension is padded to 64,
// 128 or 256 in shared memory with zeros, rows padded by one float so
// that a column read hits 16 distinct banks.  S and dO V^T are recomputed
// by both kernels (7 products in all against the 5 of the math).
//
// bf16 at D <= 128 (tc): the same three launches on the tensor cores,
// FA2's warp layout with the forward's mma.sync m16n8k16 fragments
// (mma_bf16.cuh), f32 accumulators.  dK/dV: one 128-thread block per
// (batch, KV head, 64-key tile), each warp 16 keys; K and V stay in shared
// memory, and for each query tile of 32 (over the group's heads and the
// band's tiles) Q and dO arrive by cp.async, S^T = K Q^T and dP^T = V dO^T
// are two products into registers, P^T and dS^T are formed there and,
// rounded to bf16, are directly the A fragments of dV += P^T dO and
// dK += dS^T Q (dO and Q read transposed by ldmatrix.trans).  dQ: one
// block per (batch, head, 64-query tile), each warp 16 queries, over 32-key
// tiles: S = Q K^T, dP = dO V^T, then dQ += dS K.  A warp skips the tiles
// its 16 rows see none of.  Single-stage loads, no wgmma or TMA yet: those,
// and one fused pass for dK, dV and dQ, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

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
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
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

// ---- bf16 on the tensor cores (D <= 128) -----------------------------------

namespace tc {

using mma_bf16::acc_to_a;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait_all;
using mma_bf16::ldmatrix_x4;
using mma_bf16::ldmatrix_x4_trans;
using mma_bf16::load_rows;
using mma_bf16::mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // keys (dK/dV) or queries (dQ) a block
constexpr int kBT = 32;             // the inner tile: queries, or keys

// LD: the shared row stride in bf16 (16 bytes of padding: ldmatrix's eight
// rows start in eight distinct 4-bank groups).
template <int DP>
struct Cfg {
  static constexpr int LD = DP + 8;
  static constexpr int NC = DP / 16;  // 16-wide chunks of D
  static constexpr int NT = DP / 8;   // 8-wide column tiles of D
  static constexpr int KT = kBT / 8;  // 8-wide column tiles of the inner tile
  static constexpr size_t kSmem =
      sizeof(bf16) * LD * (2 * kRows + 2 * kBT) + sizeof(float) * 2 * kRows;
};

// The A fragment of rows (warp's 16) x chunk c of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int lane, int c) {
  ldmatrix_x4(a, tile + (warp * 16 + (lane & 15)) * LD + c * 16 +
                     (lane >> 4) * 8);
}

// B fragments of the 8-row column tiles 2 j2 and 2 j2 + 1 of a row-major
// tile whose rows are the product's columns, chunk c of D.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int lane, int j2, int c) {
  ldmatrix_x4(b, tile + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                     c * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of D's column tiles 2 n2 and 2 n2 + 1 of a row-major tile
// whose rows are the product's contraction (rows 16 kc to 16 kc + 15).
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int lane, int kc, int n2) {
  ldmatrix_x4_trans(b, tile + (kc * 16 + (lane & 15)) * LD + n2 * 16 +
                           (lane >> 4) * 8);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int hkv,
               int sq, int sk, int d, int dvw, Mask m, int vec) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, NC = C::NC, NT = C::NT, KT = C::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kRows x LD
  bf16* vs = ks + kRows * LD;                    // kRows x LD
  bf16* qs = vs + kRows * LD;                    // kBT x LD
  bf16* dos = qs + kBT * LD;                     // kBT x LD
  float* lse_s = reinterpret_cast<float*>(dos + kBT * LD);  // kBT
  float* delta_s = lse_s + kBT;                              // kBT

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int k0 = blockIdx.x * kRows, kh = blockIdx.y, bb = blockIdx.z;
  const int group = h / hkv;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  load_rows<DP, LD, kThreads>(ks, k + k_row * d, k0, kRows, sk, d, vec);
  load_rows<DP, LD, kThreads>(vs, v + k_row * dvw, k0, kRows, sk, dvw, vec);
  cp_async_commit();

  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;  // lane's keys
  const int w_lo = k0 + warp * 16, w_hi = w_lo + 15;        // warp's keys
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  // Queries that any key of this tile may be seen by.
  const int q_lo = m.causal ? k0 : 0;
  const int q_hi = m.window > 0 ? min(sq, k0 + kRows - 1 + m.window) : sq;

  for (int gi = 0; gi < group; ++gi) {
    const long long row_off = (static_cast<long long>(bb) * h +
                               kh * group + gi) * sq;
    for (int q0 = (q_lo / kBT) * kBT; q0 < q_hi; q0 += kBT) {
      __syncthreads();  // the last tile's reads are done
      load_rows<DP, LD, kThreads>(qs, q + row_off * d, q0, kBT, sq, d, vec);
      load_rows<DP, LD, kThreads>(dos, dout + row_off * dvw, q0, kBT, sq,
                                  dvw, vec);
      cp_async_commit();
      load_stats<kThreads>(lse_s, delta_s, lse + row_off, delta + row_off,
                           q0, kBT, sq);
      cp_async_wait_all();
      __syncthreads();
      // This warp's 16 keys against the tile: skip when all are masked.
      if (w_lo >= sk || (m.causal && q0 + kBT - 1 < w_lo) ||
          (m.window > 0 && q0 - w_hi >= m.window))
        continue;

      // S^T = K Q^T, dP^T = V dO^T: 16 keys x kBT queries.
      float st[KT][4], dpt[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, ks, warp, lane, c);
        load_a<LD>(va, vs, warp, lane, c);
#pragma unroll
        for (int j2 = 0; j2 < KT / 2; ++j2) {
          uint32_t qb[4], ob[4];
          load_b<LD>(qb, qs, lane, j2, c);
          load_b<LD>(ob, dos, lane, j2, c);
          mma(st[2 * j2], ka, qb[0], qb[1]);
          mma(st[2 * j2 + 1], ka, qb[2], qb[3]);
          mma(dpt[2 * j2], va, ob[0], ob[1]);
          mma(dpt[2 * j2 + 1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T in place of S^T and dP^T.
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t4 + (e & 1);  // the tile's query
          float p, ds;
          p_and_ds(st[j][e], dpt[j][e], lse_s[r], delta_s[r], q0 + r,
                   e < 2 ? key_a : key_b, m, p, ds);
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      // dV += P^T dO, dK += dS^T Q, over the tile's queries.
#pragma unroll
      for (int kc = 0; kc < kBT / 16; ++kc) {
        uint32_t pa[4], sa[4];
        acc_to_a(st, kc, pa);
        acc_to_a(dpt, kc, sa);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t ob[4], qb[4];
          load_bt<LD>(ob, dos, lane, kc, n2);
          load_bt<LD>(qb, qs, lane, kc, n2);
          mma(dv_acc[2 * n2], pa, ob[0], ob[1]);
          mma(dv_acc[2 * n2 + 1], pa, ob[2], ob[3]);
          mma(dk_acc[2 * n2], sa, qb[0], qb[1]);
          mma(dk_acc[2 * n2 + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key_b : key_a;
      if (key >= sk) continue;
      bf16* dkr = dk + (k_row + key) * d + c;
      bf16* dvr = dv + (k_row + key) * dvw + c;
      if (c < d) dkr[0] = __float2bfloat16_rn(dk_acc[j][2 * half] * m.scale);
      if (c + 1 < d)
        dkr[1] = __float2bfloat16_rn(dk_acc[j][2 * half + 1] * m.scale);
      if (c < dvw) dvr[0] = __float2bfloat16_rn(dv_acc[j][2 * half]);
      if (c + 1 < dvw) dvr[1] = __float2bfloat16_rn(dv_acc[j][2 * half + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int h, int hkv, int sq, int sk, int d,
             int dvw, Mask m, int vec) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, NC = C::NC, NT = C::NT, KT = C::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kRows x LD
  bf16* dos = qs + kRows * LD;                   // kRows x LD
  bf16* ks = dos + kRows * LD;                   // kBT x LD
  bf16* vs = ks + kBT * LD;                      // kBT x LD
  float* lse_s = reinterpret_cast<float*>(vs + kBT * LD);  // kRows
  float* delta_s = lse_s + kRows;                           // kRows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long row_off = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  load_rows<DP, LD, kThreads>(qs, q + row_off * d, q0, kRows, sq, d, vec);
  load_rows<DP, LD, kThreads>(dos, dout + row_off * dvw, q0, kRows, sq, dvw,
                              vec);
  cp_async_commit();
  load_stats<kThreads>(lse_s, delta_s, lse + row_off, delta + row_off, q0,
                       kRows, sq);

  const int r_a = warp * 16 + g, r_b = r_a + 8;      // lane's rows (tile)
  const int w_lo = q0 + warp * 16, w_hi = w_lo + 15;  // warp's queries
  float dq_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.0f;

  // Keys that any row of this tile may see.
  const int k_hi = m.causal ? min(sk, q0 + kRows) : sk;
  const int k_lo = m.window > 0 ? max(0, q0 - m.window + 1) : 0;

  for (int k0 = (k_lo / kBT) * kBT; k0 < k_hi; k0 += kBT) {
    __syncthreads();  // the last tile's reads are done
    load_rows<DP, LD, kThreads>(ks, k + k_row * d, k0, kBT, sk, d, vec);
    load_rows<DP, LD, kThreads>(vs, v + k_row * dvw, k0, kBT, sk, dvw, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (w_lo >= sq || (m.causal && k0 > w_hi) ||
        (m.window > 0 && w_lo - (k0 + kBT - 1) >= m.window))
      continue;

    // S = Q K^T, dP = dO V^T: 16 queries x kBT keys.
    float s[KT][4], dp[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, qs, warp, lane, c);
      load_a<LD>(oa, dos, warp, lane, c);
#pragma unroll
      for (int j2 = 0; j2 < KT / 2; ++j2) {
        uint32_t kb[4], vb[4];
        load_b<LD>(kb, ks, lane, j2, c);
        load_b<LD>(vb, vs, lane, j2, c);
        mma(s[2 * j2], qa, kb[0], kb[1]);
        mma(s[2 * j2 + 1], qa, kb[2], kb[3]);
        mma(dp[2 * j2], oa, vb[0], vb[1]);
        mma(dp[2 * j2 + 1], oa, vb[2], vb[3]);
      }
    }
    // dS in place of S.
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_a : r_b;
        float p, ds;
        p_and_ds(s[j][e], dp[j][e], lse_s[r], delta_s[r], q0 + r,
                 k0 + 8 * j + 2 * t4 + (e & 1), m, p, ds);
        s[j][e] = ds;
      }
    // dQ += dS K, over the tile's keys.
#pragma unroll
    for (int kc = 0; kc < kBT / 16; ++kc) {
      uint32_t sa[4];
      acc_to_a(s, kc, sa);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t kb[4];
        load_bt<LD>(kb, ks, lane, kc, n2);
        mma(dq_acc[2 * n2], sa, kb[0], kb[1]);
        mma(dq_acc[2 * n2 + 1], sa, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + (half ? r_b : r_a);
      if (r >= sq) continue;
      bf16* dst = dq + (row_off + r) * d + c;
      if (c < d) dst[0] = __float2bfloat16_rn(dq_acc[j][2 * half] * m.scale);
      if (c + 1 < d)
        dst[1] = __float2bfloat16_rn(dq_acc[j][2 * half + 1] * m.scale);
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* lse,
           const bf16* dout, const float* delta, bf16* dq, bf16* dk,
           bf16* dv, int b, int h, int hkv, int sq, int sk, int d, int dvw,
           const Mask& m, cudaStream_t s) {
  constexpr size_t smem = Cfg<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_tc_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte rows: d and dv multiples of 8 and aligned
  // bases.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 8 == 0 && dvw % 8 == 0 && aligned(q) && aligned(k) &&
                  aligned(v) && aligned(dout);
  dkdv_tc_kernel<DP><<<dim3((sk + kRows - 1) / kRows, hkv, b), kThreads,
                       smem, s>>>(q, k, v, dout, lse, delta, dk, dv, h, hkv,
                                  sq, sk, d, dvw, m, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<DP><<<dim3((sq + kRows - 1) / kRows, h, b), kThreads, smem,
                     s>>>(q, k, v, dout, lse, delta, dq, h, hkv, sq, sk, d,
                          dvw, m, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* delta, void* dq,
             void* dk, void* dv, int b, int h, int hkv, int sq, int sk, int d,
             int dvw, const Mask& m, cudaStream_t s) {
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* to = static_cast<const T*>(o);
  const auto* tdo = static_cast<const T*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* tdq = static_cast<T*>(dq);
  auto* tdk = static_cast<T*>(dk);
  auto* tdv = static_cast<T*>(dv);
  if constexpr (std::is_same<T, bf16>::value) {
    if (d <= 128) {
      const cudaError_t err = launch_delta(to, tdo, fd, b, h, sq, dvw, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (d <= 64)
        return tc::launch<64>(tq, tk, tv, fl, tdo, fd, tdq, tdk, tdv, b, h,
                              hkv, sq, sk, d, dvw, m, s);
      return tc::launch<128>(tq, tk, tv, fl, tdo, fd, tdq, tdk, tdv, b, h,
                             hkv, sq, sk, d, dvw, m, s);
    }
  }
  if (d <= 64)
    return launch<T, 64>(tq, tk, tv, to, fl, tdo, fd, tdq, tdk, tdv, b, h,
                         hkv, sq, sk, d, dvw, m, s);
  if (d <= 128)
    return launch<T, 128>(tq, tk, tv, to, fl, tdo, fd, tdq, tdk, tdv, b, h,
                          hkv, sq, sk, d, dvw, m, s);
  return launch<T, 256>(tq, tk, tv, to, fl, tdo, fd, tdq, tdk, tdv, b, h, hkv,
                        sq, sk, d, dvw, m, s);
}

}  // namespace

extern "C" {

// q, dq (b, h, sq, d); o, dout (b, h, sq, dv); k, dk (b, hkv, sk, d); v,
// dv (b, hkv, sk, dv); lse and the scratch delta f32 (b, h, sq); all
// contiguous.  dtype 0 is f32, 1 bf16 (q, k, v, o, dout and the gradients
// share it).  h % hkv == 0, 1 <= dv <= d <= 256 (the kernels are chosen by
// d; V, O and dO load their dv columns and zeros past them); causal,
// window, softcap and scale as the forward's flash_launch.  Returns cudaGetLastError() (or the error of raising a
// block's shared memory limit).
int flash_bwd_launch(int dtype, const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* delta, void* dq, void* dk, void* dv, int b, int h,
                     int hkv, int sq, int sk, int d, int dvw, float scale,
                     int causal, int window, float softcap, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256 || dvw < 1 || dvw > d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask m{sq, sk, causal, window, scale, softcap};
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h,
                           hkv, sq, sk, d, dvw, m, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h, hkv,
                          sq, sk, d, dvw, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
