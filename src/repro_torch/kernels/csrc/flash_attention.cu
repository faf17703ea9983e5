// Flash attention (online softmax) for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, flash_attention): softmax(q k^T * scale) v over
// (B, H, S, D) tensors with
//   - GQA: query head h reads KV head h / (H / Hkv);
//   - gemma2 soft-capping softcap * tanh(s / softcap), after the scale and
//     before the mask;
//   - masks kpos < Sk, causal qpos >= kpos, window qpos - kpos < window,
//     with query and key positions both counted from 0;
//   - rows whose keys are all masked: m stays -inf, p and alpha are
//     zeroed, and the output is 0, never NaN.
// Accumulation in f32, output in the input's type.  With a non-null `lse`
// pointer each row's f32 log-sum-exp of its (scaled, capped) logits is
// written too, m + log(l), the JAX package's _flash_fwd_scan rule: a fully
// masked row's is finfo(f32).min.  It is what the backward pass
// (flash_attention_bwd.cu) recomputes P from.  Each kernel is instantiated
// with and without that output (kLse), so that without it the code is the
// same as before it existed.
//
// What bounds it on the H100: operations (4 D flops per unmasked (q, k)
// pair and head; the tensor-core rate in bf16 is the bound's yardstick).
//
// bf16 (flash_tc_kernel): warp-level tensor-core products, FA2's layout.
// One 128-thread block per (b, h, 64-query tile); each warp owns 16 query
// rows, and its logits S and output O live in registers as mma.sync
// m16n8k16 accumulator fragments (bf16 in, f32 accumulate).  Q, K and V
// tiles reach shared memory by cp.async (16-byte copies that zero-fill
// past D and past the last row), K and V through a two-stage ring of
// 32-key tiles: the next tile's copy is in flight while the current one
// is multiplied.  Q is loaded once, and at D <= 128 its fragments stay in
// registers.  ldmatrix feeds the fragments (.trans for V), from rows
// padded by 16 bytes so that its eight row reads hit distinct banks.  The
// online softmax runs on the S fragments in f32 (row max and sum across
// the four lanes of a quad by shuffles; exp2 with log2(e) folded into the
// scale, the scale applied to the f32 logits; accurate tanhf for the
// cap).  P never leaves registers: the S fragment of 16 keys is the A
// fragment of PV once rounded to bf16.  Rounding P to bf16 alone errs by
// up to 2^-9 of each term, which in a row of a few keys with cancelling
// values exceeds bf16's output limit (1e-2 |exp| + 1e-3), so P is split
// into a bf16 high part and a bf16 remainder and PV takes two products:
// P's error drops to about 2^-17.  Key tiles outside the causal or window
// band of the whole block are never loaded, and a warp skips the tiles
// outside its own 16 rows' band; only tiles that cross the band's edge or
// Sk pay for the per-element mask.  The head dimension is zero-padded to
// 64, 128 or 256 in shared memory (any D <= 256, no padded copy in device
// memory).  32-key tiles keep the block at 52 KB of shared memory at
// D 128 (three blocks an SM) and O (128 f32 a thread at D 256) with S in
// registers.  The query tiles run in reverse order, so under a causal
// mask the longest rows start first.  mma.sync rather than wgmma: the
// warp-level fragments keep the softmax, the masks and the P re-use in
// plain registers, one warp per 16 rows; wgmma (64-row warpgroup products
// fed by TMA) is the next step for this kernel.
//
// f32 (flash_kernel): the CUDA cores in f32, held to rtol = atol = 1e-4,
// which TF32 tensor cores cannot meet.  One 256-thread block per (b, h,
// 64-query tile) keeps the query tile, one 64-key tile (K, then V in the
// same buffer), the probabilities and the running max, denominator and
// rescale factor of each row in shared memory, and loops over the key
// tiles inside the block (the TPU kernel's sequential KV grid axis and
// its VMEM scratch).  Each thread owns 4 rows x 4 keys of the logits and
// 4 rows x D/16 columns of the output accumulator in registers.  Key
// tiles that the causal or window mask empties for the whole query tile
// are not visited.  The head dimension is padded to 64, 128 or 256 inside
// shared memory, with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---- f32 on the CUDA cores -------------------------------------------------

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kBQ / kSide;      // rows per thread
constexpr int kKeys = kBK / kSide;      // logit columns per thread
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(f32).min
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DP + 1) + kBK * (DP + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

// `rows` rows of a row-major (n_rows, d) source, from row0 on, into dst
// with row stride DP + 1; entries beyond n_rows or beyond d load 0.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows, int n_rows,
                                          int d) {
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP, cc = e % DP, g = row0 + r;
    dst[r * (DP + 1) + cc] =
        g < n_rows && cc < d ? src[static_cast<long long>(g) * d + cc] : 0.0f;
  }
}

template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int h, int hkv,
             int sq, int sk, int d, float scale, int causal, int window,
             float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                        // kBQ x (DP + 1)
  float* kvs = qs + kBQ * (DP + 1);        // kBK x (DP + 1): K, then V
  float* ps = kvs + kBK * (DP + 1);        // kBQ x (kBK + 1): logits, then p
  float* row_m = ps + kBQ * (kBK + 1);     // running max
  float* row_l = row_m + kBQ;              // running denominator
  float* row_a = row_l + kBQ;              // this tile's rescale factor
  constexpr int kCols = DP / kSide;        // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long q_off = (static_cast<long long>(bb) * h + hh) * sq * d;
  const long long k_off = (static_cast<long long>(bb) * hkv + kh) * sk * d;
  q += q_off;
  o += q_off;
  k += k_off;
  v += k_off;
  if constexpr (kLse) lse += (static_cast<long long>(bb) * h + hh) * sq;

  load_tile<DP>(qs, q, q0, kBQ, sq, d);
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  // Keys that any row of this tile may see.
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  __syncthreads();

  for (int kt0 = (k_lo / kBK) * kBK; kt0 < k_hi; kt0 += kBK) {
    load_tile<DP>(kvs, k, kt0, kBK, sk, d);
    __syncthreads();

    // Logits of this thread's 4 rows x 4 keys.
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kSide * i) * (DP + 1) + dd];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = kvs[(tx + kSide * j) * (DP + 1) + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int r = ty + kSide * i, c = tx + kSide * j;
        const int qp = q0 + r, kp = kt0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool live = kp < sk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        ps[r * (kBK + 1) + c] = live ? x : -INFINITY;
      }
    __syncthreads();

    // Online softmax: four neighbouring lanes share a row.
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = ps + r * (kBK + 1);
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool dead = m_new == -INFINITY;   // no live key yet
      const float base = dead ? 0.0f : m_new;
      float sum = 0.0f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(row[c] - base);  // masked: exp(-inf) = 0
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = dead ? 0.0f : expf(m_prev - m_new);
      __syncwarp();
      if (part == 0) {
        row_m[r] = m_new;
        row_l[r] = alpha * row_l[r] + sum;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    load_tile<DP>(kvs, v, kt0, kBK, sk, d);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = row_a[ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kSide * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kvs[kk * (DP + 1) + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + kSide * i, gq = q0 + r;
    if (gq >= sq) continue;
    const float l = row_l[r];
    const float denom = l == 0.0f ? 1.0f : l;
    if constexpr (kLse) {
      if (tx == 0)
        lse[gq] = (row_m[r] == -INFINITY ? kNegInf : row_m[r]) + logf(denom);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + kSide * j;
      if (c < d) o[static_cast<long long>(gq) * d + c] = acc[i][j] / denom;
    }
  }
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               float* lse, int b, int h, int hkv, int sq, int sk, int d,
               float scale, int causal, int window, float softcap,
               cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DP>();
  const auto kernel = lse != nullptr ? flash_kernel<DP, true>
                                     : flash_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, s>>>(
      q, k, v, o, lse, h, hkv, sq, sk, d, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on the tensor cores ----------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;        // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// DP: head dimension padded to 64, 128 or 256; BK keys per tile; LD the
// shared row stride in bf16 (16 bytes of padding: ldmatrix's eight rows
// then start in eight distinct 4-bank groups).
template <int DP>
struct Cfg {
  static constexpr int BK = 32;
  static constexpr bool kQRegs = DP <= 128;  // Q fragments kept in registers
  static constexpr int LD = DP + 8;
  static constexpr size_t kSmem = sizeof(bf16) * LD * (kBQ + 4 * BK);
};

using mma_bf16::ldmatrix_x4;
using mma_bf16::ldmatrix_x4_trans;
using mma_bf16::mma;
using mma_bf16::pack_bf16;

// (hi, lo) bf16 pairs of two f32 values: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

template <int DP, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int n_rows,
                                          int d, bool vec) {
  mma_bf16::load_rows<DP, LD, kThreads>(dst, src, row0, rows, n_rows, d, vec);
}

template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int h, int hkv, int sq, int sk, int d,
                float scale, int causal, int window, float softcap, int vec) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK, LD = C::LD;
  constexpr int NC = DP / 16;   // 16-wide chunks of D (QK^T's K steps)
  constexpr int NT = DP / 8;    // 8-wide column tiles of O
  constexpr int KT = BK / 8;    // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * LD;     // two stages of BK x LD
  bf16* vs = ks + 2 * BK * LD;  // two stages of BK x LD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row and column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long q_off = (static_cast<long long>(bb) * h + hh) * sq * d;
  const long long k_off = (static_cast<long long>(bb) * hkv + kh) * sk * d;
  q += q_off;
  o += q_off;
  k += k_off;
  v += k_off;
  if constexpr (kLse) lse += (static_cast<long long>(bb) * h + hh) * sq;

  // Key tiles that any row of the block may see.
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  load_rows<DP, LD>(qs, q, q0, kBQ, sq, d, vec);
  if (t_lo < t_hi) {
    load_rows<DP, LD>(ks, k, t_lo * BK, BK, sk, d, vec);
    load_rows<DP, LD>(vs, v, t_lo * BK, BK, sk, d, vec);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // Q's A fragments, once, when Q is kept in registers.
  uint32_t qf[C::kQRegs ? NC : 1][4];
  if constexpr (C::kQRegs) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ldmatrix_x4(qf[c], qs + (warp * 16 + (lane & 15)) * LD + c * 16 +
                             (lane >> 4) * 8);
  }

  const int r_a = q0 + warp * 16 + g, r_b = r_a + 8;  // this lane's rows
  const int w_lo = q0 + warp * 16, w_hi = w_lo + 15;  // the warp's rows
  const bool warp_live = w_lo < sq;
  const float scale_log2 = scale * kLog2e;
  float o_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;   // running max (log2 units)
  float l_a = 0.0f, l_b = 0.0f;             // this lane's part of the sum

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is in; stage ^ 1 is free
    if (t + 1 < t_hi) {
      load_rows<DP, LD>(ks + (stage ^ 1) * BK * LD, k, (t + 1) * BK, BK, sk,
                        d, vec);
      load_rows<DP, LD>(vs + (stage ^ 1) * BK * LD, v, (t + 1) * BK, BK, sk,
                        d, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const int kt0 = t * BK;
    // This warp's rows against this tile: all masked, all live, or mixed.
    if (!warp_live || (causal && kt0 > w_hi) ||
        (window > 0 && w_lo - (kt0 + BK - 1) >= window))
      continue;
    const bool edge = kt0 + BK > sk || (causal && kt0 + BK - 1 > w_lo) ||
                      (window > 0 && w_hi - kt0 >= window);
    const bf16* kst = ks + stage * BK * LD;
    const bf16* vst = vs + stage * BK * LD;

    // S = Q K^T for 16 rows x BK keys.
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t qa[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[c][e];
      } else {
        ldmatrix_x4(qa, qs + (warp * 16 + (lane & 15)) * LD + c * 16 +
                            (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < KT / 2; ++j2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kst + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            c * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * j2], qa, kb[0], kb[1]);
        mma(s[2 * j2 + 1], qa, kb[2], kb[3]);
      }
    }

    // Scale (and cap), mask, and the online softmax in log2 units.
    if (softcap > 0.0f) {
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
    } else {
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kt0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = e < 2 ? r_a : r_b;
          const bool live = kp < sk && (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
          if (!live) s[j][e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // A row with no live key yet keeps m = -inf; its p and alpha are 0.
    const float base_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float alpha_a = mn_a == -INFINITY ? 0.0f : exp2f(m_a - mn_a);
    const float alpha_b = mn_b == -INFINITY ? 0.0f : exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - (e < 2 ? base_a : base_b));
        s[j][e] = p;
        if (e < 2) sum_a += p; else sum_b += p;
      }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o_acc[j][0] *= alpha_a;
      o_acc[j][1] *= alpha_a;
      o_acc[j][2] *= alpha_b;
      o_acc[j][3] *= alpha_b;
    }

    // O += P V, P = hi + lo in bf16, straight from the S fragments.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vst + (kc * 16 + (lane & 15)) * LD + n2 * 16 +
                                  (lane >> 4) * 8);
        mma(o_acc[2 * n2], ph, vb[0], vb[1]);
        mma(o_acc[2 * n2 + 1], ph, vb[2], vb[3]);
        mma(o_acc[2 * n2], pl, vb[0], vb[1]);
        mma(o_acc[2 * n2 + 1], pl, vb[2], vb[3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // O / l, the sum over the quad's four lanes; l = 0 (no live key) gives 0.
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a == 0.0f ? 0.0f : 1.0f / l_a;
  const float inv_b = l_b == 0.0f ? 0.0f : 1.0f / l_b;
  if (kLse && t4 == 0) {
    // m is in log2 units: lse = ln 2 (m + log2 l).
    if (r_a < sq)
      lse[r_a] = m_a == -INFINITY ? kNegInf
                                  : kLn2 * (m_a + log2f(l_a));
    if (r_b < sq)
      lse[r_b] = m_b == -INFINITY ? kNegInf
                                  : kLn2 * (m_b + log2f(l_b));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_b : r_a;
      const float inv = half ? inv_b : inv_a;
      if (r >= sq) continue;
      bf16* dst = o + static_cast<long long>(r) * d + c;
      if (c < d) dst[0] = __float2bfloat16_rn(o_acc[j][2 * half] * inv);
      if (c + 1 < d) dst[1] = __float2bfloat16_rn(o_acc[j][2 * half + 1] * inv);
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
           float* lse, int b, int h, int hkv, int sq, int sk, int d,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr size_t smem = Cfg<DP>::kSmem;
  const auto kernel = lse != nullptr ? flash_tc_kernel<DP, true>
                                     : flash_tc_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte rows: d a multiple of 8 and aligned bases.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, s>>>(
      q, k, v, o, lse, h, hkv, sq, sk, d, scale, causal, window, softcap,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q, o (b, h, sq, d) and k, v (b, hkv, sk, d), contiguous; dtype 0 is f32
// (the CUDA-core kernel), 1 bf16 (the tensor-core kernel).  h % hkv == 0,
// 1 <= d <= 256.  causal != 0 masks kpos > qpos, window > 0 masks
// qpos - kpos >= window, softcap > 0 caps the logits.  lse, when not null,
// is f32 (b, h, sq) and receives each row's log-sum-exp.  Returns
// cudaGetLastError() (or the error of raising the block's shared memory
// limit).
int flash_launch(int dtype, const void* q, const void* k, const void* v,
                 void* o, int b, int h, int hkv, int sq, int sk, int d,
                 float scale, int causal, int window, float softcap,
                 void* lse, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fl = static_cast<float*>(lse);
  if (dtype == 0) {
    const auto* fq = static_cast<const float*>(q);
    const auto* fk = static_cast<const float*>(k);
    const auto* fv = static_cast<const float*>(v);
    auto* fo = static_cast<float*>(o);
    if (d <= 64)
      return launch_f32<64>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d, scale,
                            causal, window, softcap, s);
    if (d <= 128)
      return launch_f32<128>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d, scale,
                             causal, window, softcap, s);
    return launch_f32<256>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d, scale,
                           causal, window, softcap, s);
  }
  if (dtype == 1) {
    using tc::bf16;
    const auto* bq = static_cast<const bf16*>(q);
    const auto* bk = static_cast<const bf16*>(k);
    const auto* bv = static_cast<const bf16*>(v);
    auto* bo = static_cast<bf16*>(o);
    if (d <= 64)
      return tc::launch<64>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, scale,
                            causal, window, softcap, s);
    if (d <= 128)
      return tc::launch<128>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, scale,
                             causal, window, softcap, s);
    return tc::launch<256>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, scale,
                           causal, window, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
