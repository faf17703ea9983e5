// Flash attention (online softmax) for Hopper (sm_90a): bf16 and f32 on the
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, flash_attention): softmax(q k^T * scale) v over
// (B, H, S, D) q and k and (B, Hkv, S, Dv) v, Dv <= D (multi-head latent
// attention's 192-wide q and k against 128-wide v), with
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
// same as before it existed, and with Dv = D and Dv < D (kDv): at Dv = D
// dv is d, which keeps that instantiation's results bitwise those of the
// kernel before V took its own width.  Its code is not the same: ptxas
// gives the bf16 kernel at D 128 166 registers (172 with the LSE) where
// it gave 164 (169), and the Dv < D form there 168 with 4 bytes spilled.
//
// What bounds it on the H100: operations (2 (D + Dv) flops per unmasked
// (q, k) pair and head; the yardstick is the tensor-core rate, 989 TFLOP/s
// in bf16, and in f32 three TF32 products at 495 TFLOP/s, 165 TFLOP/s of
// f32 work, the floor of an f32-accurate product on the tensor cores).
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
// memory); V's rows are Dv long and load the same way, their columns past
// Dv as zeros, so P V's padded columns are 0 and are not stored.  32-key
// tiles keep the block at 52 KB of shared memory at D 128 (three blocks an
// SM) and O (128 f32 a thread at D 256) with S in registers.  The query tiles run in reverse order, so under a causal
// mask the longest rows start first.  mma.sync rather than wgmma: the
// warp-level fragments keep the softmax, the masks and the P re-use in
// plain registers, one warp per 16 rows; wgmma (64-row warpgroup products
// fed by TMA) is the next step for this kernel.
//
// f32 (flash_tf32_kernel, namespace tf): the same layout on the tensor
// cores in split TF32 (mma_tf32.cuh: each f32 operand a TF32 high part and
// remainder, three m16n8k8 TF32 products for each f32 product, small terms
// first), held to rtol = atol = 1e-4 as the CUDA-core kernel it replaced
// (one TF32 product, 2^-11 of each term, cannot meet that; the split leaves
// about 2^-21).  One 128-thread block per (b, h, 64-query tile), each warp
// 16 query rows, S and O in registers as accumulator fragments; Q and two
// stages each of K and V in shared memory by cp.async (plain loads for rows
// that are no multiple of 16 bytes or bases off 16-byte alignment), rows
// padded to 4 mod 32 floats so that every fragment load hits distinct
// banks.  The S fragment becomes PV's A fragment in registers (its
// contraction taken in the order of mma_tf32.cuh), and V's B values come as
// 16-byte loads, four 8-column tiles at once.  Each tile's P V is summed
// apart and added to O with one f32 rounding (O = alpha O + P V in one
// fmaf), so that no tensor-core accumulation runs over more than one tile's
// keys.  Widths are padded to 64, 128, 192 (V to 128: multi-head latent
// attention's layout pays no padding) or 256; 32-key tiles up to D 128 and
// 16 from D 192 keep two blocks an SM (52, 101 and 92 KB of shared memory)
// except at D 256 (133 KB).  Masks, window,
// softcap, GQA, the LSE and the query tiles' reverse order are the bf16
// kernel's.  mma.sync rather than wgmma: see mma_tf32.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(f32).min
constexpr float kLn2 = 0.6931471805599453f;

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

template <int DP, bool kLse, bool kDv>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int h, int hkv, int sq, int sk, int d,
                int dv, float scale, int causal, int window, float softcap,
                int vec) {
  if constexpr (!kDv) dv = d;
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
  const long long q_row = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  q += q_row * d;
  o += q_row * dv;
  k += k_row * d;
  v += k_row * dv;
  if constexpr (kLse) lse += q_row;

  // Key tiles that any row of the block may see.
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  load_rows<DP, LD>(qs, q, q0, kBQ, sq, d, vec);
  if (t_lo < t_hi) {
    load_rows<DP, LD>(ks, k, t_lo * BK, BK, sk, d, vec);
    load_rows<DP, LD>(vs, v, t_lo * BK, BK, sk, dv, vec);
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
                        dv, vec);
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
      bf16* dst = o + static_cast<long long>(r) * dv + c;
      if (c < dv) dst[0] = __float2bfloat16_rn(o_acc[j][2 * half] * inv);
      if (c + 1 < dv)
        dst[1] = __float2bfloat16_rn(o_acc[j][2 * half + 1] * inv);
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
           float* lse, int b, int h, int hkv, int sq, int sk, int d, int dv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr size_t smem = Cfg<DP>::kSmem;
  const auto kernel =
      dv != d ? (lse != nullptr ? flash_tc_kernel<DP, true, true>
                                : flash_tc_kernel<DP, false, true>)
              : (lse != nullptr ? flash_tc_kernel<DP, true, false>
                                : flash_tc_kernel<DP, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte rows: d and dv multiples of 8 and aligned
  // bases.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 8 == 0 && dv % 8 == 0 && aligned(q) && aligned(k) &&
                  aligned(v);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, s>>>(
      q, k, v, o, lse, h, hkv, sq, sk, d, dv, scale, causal, window, softcap,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- f32 on the tensor cores: split TF32 -----------------------------------

namespace tf {

using namespace mma_tf32;
constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;        // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// DP: Q and K's width padded to 64, 128, 192 (with V's DVP 128) or 256
// (D 129-192 with Dv above 128, which no model has, pads to 256 as well);
// BK keys per tile; LD and LDV the shared row strides in floats (4 mod 32:
// see mma_tf32.cuh).  Q and two stages each of K and V: 52 KB at DP 64,
// 101 KB at DP 128, 92 KB at DP 192 / DVP 128 (two blocks an SM; BK 16
// from DP 192 on), 133 KB at DP 256.  One instance a width, the LSE
// written where its pointer is not null.  kBlocks, the blocks an SM that
// ptxas must leave room for: two from DP 128 on, where shared memory
// holds two anyway (up to 255 registers a thread: ptxas's own choice,
// about 176, ran slower at D 128 and 192); three at DP 64 (at most 170,
// three blocks as with its own choice).
template <int DP, int DVP>
struct Cfg {
  static constexpr int BK = DP <= 128 ? 32 : 16, kBlocks = DP <= 64 ? 3 : 2;
  static constexpr int LD = DP + 4, LDV = DVP + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * LD + 2 * BK * (LD + LDV));
};

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, Cfg<DP, DVP>::kBlocks)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int h, int hkv, int sq, int sk,
                  int d, int dv, float scale, int causal, int window,
                  float softcap, int vec) {
  using C = Cfg<DP, DVP>;
  constexpr int BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int KT = BK / 8;    // 8-key tiles of S
  constexpr int NG = DVP / 32;  // 32-column groups of O
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;
  float* ks = qs + kBQ * LD;     // two stages of BK x LD
  float* vs = ks + 2 * BK * LD;  // two stages of BK x LDV

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / hkv);
  const long long q_row = (static_cast<long long>(bb) * h + hh) * sq;
  const long long k_row = (static_cast<long long>(bb) * hkv + kh) * sk;
  q += q_row * d;
  o += q_row * dv;
  k += k_row * d;
  v += k_row * dv;

  // Key tiles that any row of the block may see.
  const int k_hi = causal ? min(sk, q0 + kBQ) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  load_rows<DP, LD, kThreads>(qs, q, q0, kBQ, sq, d, vec);
  if (t_lo < t_hi) {
    load_rows<DP, LD, kThreads>(ks, k, t_lo * BK, BK, sk, d, vec);
    load_rows<DVP, LDV, kThreads>(vs, v, t_lo * BK, BK, sk, dv, vec);
  }
  mma_bf16::cp_async_commit();

  const int r_a = q0 + warp * 16 + g, r_b = r_a + 8;  // this lane's rows
  const int w_lo = q0 + warp * 16, w_hi = w_lo + 15;  // the warp's rows
  const bool warp_live = w_lo < sq;
  const float scale_log2 = scale * kLog2e;
  float o_acc[NG][4][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][j][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;   // running max (log2 units)
  float l_a = 0.0f, l_b = 0.0f;             // this lane's part of the sum

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    mma_bf16::cp_async_wait_all();
    __syncthreads();  // tile t is in; stage ^ 1 is free
    if (t + 1 < t_hi) {
      load_rows<DP, LD, kThreads>(ks + (stage ^ 1) * BK * LD, k, (t + 1) * BK,
                                  BK, sk, d, vec);
      load_rows<DVP, LDV, kThreads>(vs + (stage ^ 1) * BK * LDV, v,
                                    (t + 1) * BK, BK, sk, dv, vec);
    }
    mma_bf16::cp_async_commit();
    const int kt0 = t * BK;
    // This warp's rows against this tile: all masked, all live, or mixed.
    if (!warp_live || (causal && kt0 > w_hi) ||
        (window > 0 && w_lo - (kt0 + BK - 1) >= window))
      continue;
    const bool edge = kt0 + BK > sk || (causal && kt0 + BK - 1 > w_lo) ||
                      (window > 0 && w_hi - kt0 >= window);
    const float* kst = ks + stage * BK * LD;
    const float* vst = vs + stage * BK * LDV;

    // S = Q K^T for 16 rows x BK keys.
    float s[KT][4];
    product_t<KT, DP, LD>(s, qs, warp * 16, kst, lane);

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

    // O = alpha O + P V, P straight from the S fragments.
    add_product<KT, NG, LDV>(o_acc, s, vst, lane, alpha_a, alpha_b);
  }
  mma_bf16::cp_async_wait_all();

  // O / l, the sum over the quad's four lanes; l = 0 (no live key) gives 0.
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a == 0.0f ? 0.0f : 1.0f / l_a;
  const float inv_b = l_b == 0.0f ? 0.0f : 1.0f / l_b;
  if (lse != nullptr && t4 == 0) {
    // m is in log2 units: lse = ln 2 (m + log2 l).
    if (r_a < sq)
      lse[q_row + r_a] =
          m_a == -INFINITY ? kNegInf : kLn2 * (m_a + log2f(l_a));
    if (r_b < sq)
      lse[q_row + r_b] =
          m_b == -INFINITY ? kNegInf : kLn2 * (m_b + log2f(l_b));
  }
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_a : r_b, c = 32 * n + acc_col(t4, j, e);
        if (r < sq && c < dv)
          o[static_cast<long long>(r) * dv + c] =
              o_acc[n][j][e] * (e < 2 ? inv_a : inv_b);
      }
}

template <int DP, int DVP>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int b, int h, int hkv, int sq, int sk, int d, int dv,
           float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr size_t smem = Cfg<DP, DVP>::kSmem;
  const auto kernel = flash_tf32_kernel<DP, DVP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte rows: d and dv multiples of 4 and aligned
  // bases.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 4 == 0 && dv % 4 == 0 && aligned(q) && aligned(k) &&
                  aligned(v);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, o, lse, h, hkv, sq, sk, d, dv,
                                      scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

}  // namespace

extern "C" {

// q (b, h, sq, d), k (b, hkv, sk, d), v (b, hkv, sk, dv) and o (b, h, sq,
// dv), contiguous; dtype 0 is f32 (split TF32 on the tensor cores), 1
// bf16 (bf16 tensor-core products).  h % hkv == 0, 1 <= dv <= d <= 256: V and O have
// their own row length, and the head dimension is padded to d's (V's
// columns past dv load as zeros and change no sum).  causal != 0 masks
// kpos > qpos, window > 0 masks qpos - kpos >= window, softcap > 0 caps
// the logits.  lse, when not null, is f32 (b, h, sq) and receives each
// row's log-sum-exp.  Returns cudaGetLastError() (or the error of raising
// the block's shared memory limit).
int flash_launch(int dtype, const void* q, const void* k, const void* v,
                 void* o, int b, int h, int hkv, int sq, int sk, int d,
                 int dv, float scale, int causal, int window, float softcap,
                 void* lse, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256 || dv < 1 || dv > d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fl = static_cast<float*>(lse);
  if (dtype == 0) {
    const auto* fq = static_cast<const float*>(q);
    const auto* fk = static_cast<const float*>(k);
    const auto* fv = static_cast<const float*>(v);
    auto* fo = static_cast<float*>(o);
    if (d <= 64)
      return tf::launch<64, 64>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d, dv,
                                scale, causal, window, softcap, s);
    if (d <= 128)
      return tf::launch<128, 128>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d,
                                  dv, scale, causal, window, softcap, s);
    if (d <= 192 && dv <= 128)
      return tf::launch<192, 128>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d,
                                  dv, scale, causal, window, softcap, s);
    return tf::launch<256, 256>(fq, fk, fv, fo, fl, b, h, hkv, sq, sk, d, dv,
                                scale, causal, window, softcap, s);
  }
  if (dtype == 1) {
    using tc::bf16;
    const auto* bq = static_cast<const bf16*>(q);
    const auto* bk = static_cast<const bf16*>(k);
    const auto* bv = static_cast<const bf16*>(v);
    auto* bo = static_cast<bf16*>(o);
    if (d <= 64)
      return tc::launch<64>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, dv,
                            scale, causal, window, softcap, s);
    if (d <= 128)
      return tc::launch<128>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, dv,
                             scale, causal, window, softcap, s);
    return tc::launch<256>(bq, bk, bv, bo, fl, b, h, hkv, sq, sk, d, dv,
                           scale, causal, window, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
