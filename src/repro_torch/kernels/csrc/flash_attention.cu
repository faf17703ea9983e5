// Flash attention (online softmax) for Hopper (sm_90a), on CUDA cores.
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
// f32 or bf16 in, accumulation in f32, output in the input's type.
//
// What bounds it on the H100: operations (4 D flops per unmasked (q, k)
// pair and head; the tensor-core rate in bf16 is the bound's yardstick).
// This first kernel runs on the CUDA cores in f32, so it sits far above
// that bound; a wgmma version is later work.
//
// What the design does about it: one 256-thread block per (b, h, 64-query
// tile) keeps the query tile, one 64-key tile (K, then V in the same
// buffer), the probabilities and the running max, denominator and
// rescale factor of each row in shared memory, and loops over the key
// tiles inside the block (the TPU kernel's sequential KV grid axis and its
// VMEM scratch).  Each thread owns 4 rows x 4 keys of the logits and
// 4 rows x D/16 columns of the output accumulator in registers.  Key tiles
// that the causal or window mask empties for the whole query tile are not
// visited; a skipped tile would leave every row's state unchanged.  The
// head dimension is padded to 64, 128 or 256 inside shared memory, with
// zeros, so any D <= 256 runs without a padded copy in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kBQ / kSide;      // rows per thread
constexpr int kKeys = kBK / kSide;      // logit columns per thread

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DP + 1) + kBK * (DP + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

// `rows` rows of a row-major (n_rows, d) source, from row0 on, into dst
// with row stride DP + 1; entries beyond n_rows or beyond d load 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int n_rows, int d) {
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP, cc = e % DP, g = row0 + r;
    dst[r * (DP + 1) + cc] =
        g < n_rows && cc < d ? load_f(src + static_cast<long long>(g) * d + cc)
                             : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int h, int hkv,
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

  load_tile<T, DP>(qs, q, q0, kBQ, sq, d);
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
    load_tile<T, DP>(kvs, k, kt0, kBK, sk, d);
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

    load_tile<T, DP>(kvs, v, kt0, kBK, sk, d);
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
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + kSide * j;
      if (c < d) store_f(o + static_cast<long long>(gq) * d + c, acc[i][j] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int sq, int sk, int d, float scale, int causal,
           int window, float softcap, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_kernel<T, DP><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, hkv, sq, sk, d, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int h, int hkv, int sq, int sk, int d, float scale, int causal,
             int window, float softcap, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, h, hkv, sq, sk, d, scale, causal,
                         window, softcap, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, h, hkv, sq, sk, d, scale, causal,
                          window, softcap, s);
  return launch<T, 256>(q, k, v, o, b, h, hkv, sq, sk, d, scale, causal,
                        window, softcap, s);
}

}  // namespace

extern "C" {

// q, o (b, h, sq, d) and k, v (b, hkv, sk, d), contiguous; dtype 0 is f32,
// 1 bf16.  h % hkv == 0, 1 <= d <= 256.  causal != 0 masks kpos > qpos,
// window > 0 masks qpos - kpos >= window, softcap > 0 caps the logits.
// Returns cudaGetLastError() (or the error of raising the block's shared
// memory limit).
int flash_launch(int dtype, const void* q, const void* k, const void* v,
                 void* o, int b, int h, int hkv, int sq, int sk, int d,
                 float scale, int causal, int window, float softcap,
                 void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, b, h, hkv, sq, sk, d, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, h, hkv, sq, sk, d, scale,
                                   causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
