// GF(p) matrix product C = (A @ B) mod p for Hopper (sm_90a), on the int8
// tensor cores over 8-bit limbs.
//
// Replaces the TPU kernel src/repro/kernels/gfmm.py (_gfmm_kernel,
// gf_matmul): the product of two matrices over the integers mod p, reduced
// so that the sums stay inside the accumulator's type, for inputs already
// reduced to [0, p).  The TPU kernel has two modes (int32 on its matrix
// unit, p = 1009, or f32, p = 251); both return the same integers, and
// this kernel computes both in integers.
//
// What bounds it on the H100: operations.  Every p the wrapper admits has
// p - 1 < 2^16, so a residue r splits exactly into two unsigned bytes,
// r = lo + 256 hi, and
//   A @ B = S_ll + 256 S_x + 65536 S_hh,
//   S_ll = lo_A @ lo_B,  S_x = lo_A @ hi_B + hi_A @ lo_B,  S_hh = hi_A @ hi_B:
// four u8 x u8 -> s32 tensor-core products (one for p <= 256, where hi is
// 0).  At 1979 TOP/s those bound a 4114^2 product (the Cheung propagation
// matrix of sf(q=11)) at 4 x 2 x 4114^3 operations, 0.28 ms, against
// 3 x 68 MB of int32 (0.06 ms).
//
// What the design does about it:
// 1. Packing (pack_rows_gf, pack_cols_gf): each residue is reduced mod p
//    and split into limb planes of bytes, A with K contiguous by rows and
//    B transposed (through shared memory) to K contiguous by columns, the
//    row.col layout mma.sync takes; K is padded with zeros to a multiple
//    of 128.
// 2. The product (gf_kernel): each 256-thread block owns a 128x64 output
//    tile, eight warps of 32x32; per 128-byte K step it stages both planes
//    of A's rows and B's columns through a four-stage cp.async ring (rows
//    padded to 144 bytes, so ldmatrix's eight rows fall in distinct banks)
//    and runs mma.sync.m16n8k32.row.col.s32.u8.u8.s32, the cross term's
//    two products into one accumulator.  Every `chunk` K entries (the
//    wrapper's gf_plan: (p - 1) + chunk * 2 * 255^2 < 2^31 with two limbs,
//    (p - 1) + chunk * 255^2 < 2^31 with one) the s32 accumulators are
//    reduced mod p, so none can overflow with the residue carried in.
//    The output is (S_ll + 256 S_x + 65536 S_hh) mod p in int64.
// Rows and columns beyond the edge load zeros (cp.async's zero fill).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 128;           // K bytes per stage
constexpr int kThreads = 256;      // 8 warps: 4 (rows) x 2 (columns)
constexpr int kStages = 4;
constexpr int kLd = kBK + 16;      // bytes per staged row (9 x 16)
constexpr long long kS32 = 2147483648LL;

template <int L>  // limbs
struct Smem {
  static constexpr int kA = L * kBM * kLd;  // bytes of A's planes a stage
  static constexpr int kStage = kA + L * kBN * kLd;
  static constexpr size_t kBytes = static_cast<size_t>(kStages) * kStage;
};

unsigned blocks_for(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

__device__ __forceinline__ int residue(int v, int p) {
  const int r = v % p;
  return r < 0 ? r + p : r;
}

// a (rows, k) int32 -> planes (limbs, rows, kp) bytes: plane 0 holds
// r & 255, plane 1 r >> 8 of r = a mod p; zero past k.  A thread writes
// one 4-byte word of each plane.
__global__ void pack_rows_gf(const int* __restrict__ a,
                             uint32_t* __restrict__ planes, int rows, int k,
                             int kp, int p, int limbs) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int kw = kp / 4;
  const long long words = static_cast<long long>(rows) * kw;
  if (idx >= words) return;
  const long long r = idx / kw;
  const int w = static_cast<int>(idx % kw);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = 4 * w + j;
    if (kk < k) {
      const int v = residue(a[r * k + kk], p);
      lo |= static_cast<uint32_t>(v & 255) << (8 * j);
      hi |= static_cast<uint32_t>(v >> 8) << (8 * j);
    }
  }
  planes[idx] = lo;
  if (limbs == 2) planes[words + idx] = hi;
}

// b (k, cols) int32 -> planes (limbs, cols, kp) bytes, transposed: a
// 256-thread block reads a 32 (K) x 32 (columns) tile with coalesced rows,
// then each thread writes 4 K entries of one column as one word a plane.
__global__ void pack_cols_gf(const int* __restrict__ b,
                             uint32_t* __restrict__ planes, int k, int cols,
                             int kp, int p, int limbs) {
  __shared__ int tile[32][33];
  const int k0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int kk = k0 + i, c = c0 + tx;
    tile[i][tx] = kk < k && c < cols
                      ? residue(b[static_cast<long long>(kk) * cols + c], p)
                      : 0;
  }
  __syncthreads();
  const int t = ty * 32 + tx;
  const int cc = t >> 3, w = t & 7;
  const int c = c0 + cc;
  if (c >= cols) return;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = tile[4 * w + j][cc];
    lo |= static_cast<uint32_t>(v & 255) << (8 * j);
    hi |= static_cast<uint32_t>(v >> 8) << (8 * j);
  }
  const int kw = kp / 4;
  const long long idx = static_cast<long long>(c) * kw + k0 / 4 + w;
  planes[idx] = lo;
  if (limbs == 2) planes[static_cast<long long>(cols) * kw + idx] = hi;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into dst, of which the first `bytes` are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x32, row) * b (32x8, col), u8 in, s32 accumulate.  Fragments
// (g = lane / 4, t = lane % 4; four bytes a register): a = A[g][4t..],
// A[g+8][4t..], A[g][16+4t..], A[g+8][16+4t..]; b = B[4t..][g],
// B[16+4t..][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators: S_ll, then (two limbs) S_x and S_hh, each over the
// warp's 2 x 4 tiles of 16x8.
template <int L>
constexpr int kSums = L == 2 ? 3 : 1;

template <int L>
__global__ void __launch_bounds__(kThreads, 1)
gf_kernel(const uint8_t* __restrict__ ap, const uint8_t* __restrict__ bp,
          int* __restrict__ c, int m, int n, int kp, int p,
          int chunk_steps) {
  using S = Smem<L>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const long long plane_a = static_cast<long long>(m) * kp;
  const long long plane_b = static_cast<long long>(n) * kp;
  const int steps = kp / kBK;

  // Stage `st` <- K bytes [k0, k0 + 128) of every plane of the block's A
  // rows and B columns, 16 bytes a copy; rows past the edge are zeros.
  auto load = [&](int st, int k0) {
    uint8_t* as = smem + st * S::kStage;
    uint8_t* bs = as + S::kA;
    constexpr int kChunks = kBK / 16;  // 16-byte copies a row
    for (int e = tid; e < L * kBM * kChunks; e += kThreads) {
      const int l = e / (kBM * kChunks), r = (e / kChunks) % kBM;
      const int q = e % kChunks;
      const int gr = row0 + r;
      const uint8_t* src = ap + l * plane_a +
                           static_cast<long long>(gr < m ? gr : m - 1) * kp +
                           k0 + 16 * q;
      cp_async16(as + (l * kBM + r) * kLd + 16 * q, src, gr < m ? 16 : 0);
    }
    for (int e = tid; e < L * kBN * kChunks; e += kThreads) {
      const int l = e / (kBN * kChunks), r = (e / kChunks) % kBN;
      const int q = e % kChunks;
      const int gc = col0 + r;
      const uint8_t* src = bp + l * plane_b +
                           static_cast<long long>(gc < n ? gc : n - 1) * kp +
                           k0 + 16 * q;
      cp_async16(bs + (l * kBN + r) * kLd + 16 * q, src, gc < n ? 16 : 0);
    }
  };

  int acc[kSums<L>][2][4][4];
#pragma unroll
  for (int s = 0; s < kSums<L>; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[s][i][j][v] = 0;

  // The ring: loads run kStages - 1 steps ahead; every slot commits one
  // group (empty past the last step); one barrier a step.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, st * kBK);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = step + kStages - 1;
    if (ahead < steps) load(ahead % kStages, ahead * kBK);
    cp_async_commit();
    const uint8_t* as = smem + (step % kStages) * S::kStage;
    const uint8_t* bs = as + S::kA;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[L][2][4], bf[L][4][2];
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[l][i], as + (l * kBM + wm + 16 * i + (lane & 15)) *
                                         kLd + ks + (lane >> 4) * 16);
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          uint32_t r[4];
          ldmatrix_x4(r, bs + (l * kBN + wn + 16 * j2 + (lane & 7) +
                               ((lane >> 4) << 3)) * kLd +
                             ks + ((lane >> 3) & 1) * 16);
          bf[l][2 * j2][0] = r[0];
          bf[l][2 * j2][1] = r[1];
          bf[l][2 * j2 + 1][0] = r[2];
          bf[l][2 * j2 + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_u8(acc[0][i][j], af[0][i], bf[0][j][0], bf[0][j][1]);
          if constexpr (L == 2) {
            mma_u8(acc[1][i][j], af[0][i], bf[1][j][0], bf[1][j][1]);
            mma_u8(acc[1][i][j], af[1][i], bf[0][j][0], bf[0][j][1]);
            mma_u8(acc[2][i][j], af[1][i], bf[1][j][0], bf[1][j][1]);
          }
        }
    }
    if ((step + 1) % chunk_steps == 0 && step + 1 < steps) {
#pragma unroll
      for (int s = 0; s < kSums<L>; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[s][i][j][v] %= p;
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = row0 + wm + 16 * i + g + 8 * (v >> 1);
        const int col = col0 + wn + 8 * j + 2 * t + (v & 1);
        if (r >= m || col >= n) continue;
        long long x = acc[0][i][j][v] % p;
        if constexpr (L == 2)
          x += 256LL * (acc[1][i][j][v] % p) +
               65536LL * (acc[2][i][j][v] % p);
        c[static_cast<long long>(r) * n + col] = static_cast<int>(x % p);
      }
}

template <int L>
int launch_product(const uint8_t* ap, const uint8_t* bp, int* c, int m,
                   int n, int kp, int p, int chunk_steps, cudaStream_t s) {
  using S = Smem<L>;
  const cudaError_t err = cudaFuncSetAttribute(
      gf_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gf_kernel<L><<<grid, kThreads, S::kBytes, s>>>(ap, bp, c, m, n, kp, p,
                                                 chunk_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A (m, k) and B (k, n) row-major int32; C (m, n) int32 = (A @ B) mod p,
// every entry reduced mod p first.  limbs: 1 (p <= 256) or 2 (p <= 2^16).
// Scratch: ap holds limbs * m * kp and bp limbs * n * kp bytes, kp = k
// rounded up to a multiple of 128.  chunk (a multiple of 128): K entries
// between reductions, which must keep (p - 1) + chunk * t < 2^31 with
// t = 2 * 255^2 for two limbs, 255^2 for one.  Returns cudaGetLastError()
// (or the error of raising the product's shared memory limit).
int gfmm_launch(const void* a, const void* b, void* c, void* ap, void* bp,
                int m, int k, int n, int p, int limbs, int chunk,
                void* stream) {
  const long long term = limbs == 2 ? 2LL * 255 * 255 : 255LL * 255;
  if (m < 1 || n < 1 || k < 1 || p < 2 || p > 65536 ||
      (limbs != 1 && limbs != 2) || (limbs == 1 && p > 256) ||
      chunk < kBK || chunk % kBK != 0 || (p - 1) + chunk * term >= kS32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = (k + kBK - 1) / kBK * kBK;
  uint32_t* pa = static_cast<uint32_t*>(ap);
  uint32_t* pb = static_cast<uint32_t*>(bp);
  pack_rows_gf<<<blocks_for(static_cast<long long>(m) * (kp / 4), 256), 256,
                 0, s>>>(static_cast<const int*>(a), pa, m, k, kp, p, limbs);
  pack_cols_gf<<<dim3((n + 31) / 32, kp / 32), dim3(32, 8), 0, s>>>(
      static_cast<const int*>(b), pb, k, n, kp, p, limbs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* ua = static_cast<const uint8_t*>(ap);
  const uint8_t* ub = static_cast<const uint8_t*>(bp);
  int* ic = static_cast<int*>(c);
  if (limbs == 2)
    return launch_product<2>(ua, ub, ic, m, n, kp, p, chunk / kBK, s);
  return launch_product<1>(ua, ub, ic, m, n, kp, p, chunk / kBK, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
