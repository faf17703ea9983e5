// One max-min water-filling step of the flow simulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/waterfill.py (_waterfill_kernel,
// _pallas_waterfill, waterfill_step).  Per step, over the (F, S) path-edge
// layout (S = hop slots + injection + ejection NIC, link E-1 = write-only
// trash link):
//   round 0: scatter the 0/1 weights of active rows into per-link claim
//            counts; fair = cap / max(count, 1e-9); share = min over the
//            row's live slots; d = min(desired * active, share);
//   rounds 1..fair_iters: scatter d into link loads; scale =
//            min(1, cap / max(load, 1e-9)); s = min over live slots
//            (non-finite -> 0); d *= s;
//   want_util: util = max over live slots of load / max(cap, 1e-9), read
//            from round min(1, fair_iters).
// Inactive rows and -1 slots go to the trash link, which never enters a
// min: a row with no live slot gets share = +inf and, after the first
// refinement, sent = 0.
//
// What bounds it on the H100: bytes and latency, never arithmetic.  One
// step at the main cell (F = 10 830, S = 8, E = 42 599) reads the edge
// array once per round (~0.35 MB), the per-flow vectors and the link
// vector: about a megabyte per step, a fraction of a microsecond at
// 3.35 TB/s, so the launches and the dependent gathers set its time.
//
// What the design does about it: the TPU kernel orders its whole grid so
// that every flow's scatter ends before any reduce.  Blocks on the H100 run
// in no order, so the order comes from kernel boundaries on one stream:
// a memset of the per-round link buffers, one scatter launch, then one
// launch per round in which each thread owns one flow, gathers its links,
// takes the masked min and at once scatters its new demand into the NEXT
// round's buffer.  That is 2 + fair_iters launches plus the memset, at
// every E (the link buffers live in device memory, so sf(q=29)'s 146 335
// links fit as well as sf(q=19)'s).
//
// Determinism: link sums are accumulated as int64 fixed point (value *
// 2^40) with 64-bit integer atomics.  Integer adds commute, so the sums,
// and every output, are bitwise identical from launch to launch whatever
// order the atomics land in; 0/1 claim counts are exact, and 2^-40 is far
// finer than f32 rounding of a demand in [0, 1].  The sum cannot overflow
// while F * S < 2^23 for values in [0, 1].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFix = 1099511627776.0f;            // 2^40
constexpr double kUnfix = 1.0 / 1099511627776.0;    // 2^-40
constexpr float kTiny = 1e-9f;
constexpr int kBlock = 256;

__device__ __forceinline__ unsigned long long to_fix(float v) {
  return static_cast<unsigned long long>(__float2ll_rn(v * kFix));
}

__device__ __forceinline__ float from_fix(unsigned long long x) {
  return static_cast<float>(static_cast<double>(static_cast<long long>(x)) *
                            kUnfix);
}

// Slot -> link id, with inactive rows, -1 padding and ids out of range
// sent to the trash link.
__device__ __forceinline__ int link_of(int e, bool act, int e_tot) {
  return (act && e >= 0 && e < e_tot) ? e : e_tot - 1;
}

// Round-0 claims: one thread per (flow, slot).
__global__ void scatter_claims(const int* __restrict__ edges, int edge_stride,
                               const float* __restrict__ w,
                               const uint8_t* __restrict__ active, int f,
                               int s, int e_tot,
                               unsigned long long* __restrict__ load0) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= static_cast<long long>(f) * s) return;
  const int row = static_cast<int>(i / s);
  const int slot = static_cast<int>(i % s);
  const bool act = active[row] != 0;
  const int e = link_of(edges[static_cast<long long>(row) * edge_stride + slot],
                        act, e_tot);
  if (e == e_tot - 1) return;                 // the trash link is never read
  const float v = w[row] * (act ? 1.0f : 0.0f);
  if (v != 0.0f) atomicAdd(load0 + e, to_fix(v));
}

// One round: gather + masked min per flow, then scatter the new demand
// into the next round's link buffer.  One thread per flow.
__global__ void waterfill_round(const int* __restrict__ edges, int edge_stride,
                                const float* __restrict__ desired,
                                const uint8_t* __restrict__ active,
                                const float* __restrict__ cap, int f, int s,
                                int e_tot, int round, int fair_iters,
                                int util_round,
                                const unsigned long long* __restrict__ load,
                                unsigned long long* __restrict__ load_next,
                                float* __restrict__ sent,
                                float* __restrict__ share,
                                float* __restrict__ util) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= f) return;
  const bool act = active[row] != 0;
  const int* er = edges + static_cast<long long>(row) * edge_stride;
  const bool want_u = util != nullptr && round == util_round;
  float m = INFINITY;
  float u = 0.0f;
  for (int j = 0; j < s; ++j) {
    const int e = link_of(er[j], act, e_tot);
    if (e == e_tot - 1) continue;
    const float ld = from_fix(load[e]);
    const float c = cap[e];
    float v = c / fmaxf(ld, kTiny);
    if (round > 0) v = fminf(1.0f, v);
    m = fminf(m, v);
    if (want_u) u = fmaxf(u, ld / fmaxf(c, kTiny));
  }
  float d;
  if (round == 0) {
    share[row] = m;
    d = fminf(desired[row] * (act ? 1.0f : 0.0f), m);
  } else {
    d = sent[row] * (isfinite(m) ? m : 0.0f);
  }
  sent[row] = d;
  if (want_u) util[row] = u;
  if (round < fair_iters && d != 0.0f) {
    const unsigned long long q = to_fix(d);
    for (int j = 0; j < s; ++j) {
      const int e = link_of(er[j], act, e_tot);
      if (e != e_tot - 1) atomicAdd(load_next + e, q);
    }
  }
}

}  // namespace

extern "C" {

// edges: (f, s) int32 with row stride edge_stride; w, desired, sent, share,
// util: (f,) f32 (util may be null); active: (f,) bytes; cap: (e_tot,) f32;
// load: (1 + fair_iters, e_tot) int64 scratch.  Returns cudaGetLastError().
int waterfill_launch(const int* edges, int edge_stride, const float* w,
                     const float* desired, const uint8_t* active,
                     const float* cap, int f, int s, int e_tot, int fair_iters,
                     unsigned long long* load, float* sent, float* share,
                     float* util, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rounds = 1 + fair_iters;
  cudaError_t err = cudaMemsetAsync(
      load, 0, sizeof(unsigned long long) * rounds * static_cast<size_t>(e_tot),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(f) * s;
  if (slots > 0)
    scatter_claims<<<static_cast<unsigned>((slots + kBlock - 1) / kBlock),
                     kBlock, 0, st>>>(edges, edge_stride, w, active, f, s,
                                      e_tot, load);
  const int util_round = fair_iters < 1 ? fair_iters : 1;
  const unsigned grid = static_cast<unsigned>((f + kBlock - 1) / kBlock);
  for (int r = 0; r < rounds; ++r) {
    unsigned long long* cur = load + static_cast<size_t>(r) * e_tot;
    unsigned long long* next = r + 1 < rounds ? cur + e_tot : nullptr;
    waterfill_round<<<grid, kBlock, 0, st>>>(
        edges, edge_stride, desired, active, cap, f, s, e_tot, r, fair_iters,
        util_round, cur, next, sent, share, util);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
