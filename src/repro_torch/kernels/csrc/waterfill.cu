// One max-min water-filling step of the flow simulator, for Hopper (sm_90a),
// in one launch.
//
// Replaces the TPU kernel src/repro/kernels/waterfill.py (_waterfill_kernel,
// _pallas_waterfill, waterfill_step).  Per step, over the (F, S) path-edge
// layout (S = hop slots + injection + ejection NIC, link E-1 = write-only
// trash link):
//   round 0: per-link claim counts of the active rows' weights; fair =
//            cap / max(count, 1e-9); share = min over the row's live
//            slots; d = min(desired * active, share);
//   rounds 1..fair_iters: per-link loads of d; scale = min(1, cap /
//            max(load, 1e-9)); s = min over live slots (non-finite -> 0);
//            d *= s; the last round also writes acc + d_prev * s as one
//            fmaf (XLA contracts the reference scan's sent_acc update so);
//   want_util: util = max over the slots of load / max(cap, 1e-9) (0 for
//            a dead slot), read from round min(1, fair_iters).
// Inactive rows, -1 slots and ids out of range go to the trash link, which
// never enters a min: a row with no live slot gets share = +inf and, after
// the first refinement, sent = 0.
//
// Order: each link's sum runs over the link's entries of a plan built once
// per cell (kernels/waterfill.py link_plan: a CSR of (flow, layer mask)
// entries sorted by (flow, slot)), in f32 from +0.0, one entry after
// another.  An entry whose flow is not active, or whose mask lacks the
// flow's current layer, adds +0.0, which changes no f32 sum that starts at
// +0.0.  That is the plain version's index_add_ order on the CPU (flat
// row-major (flow, slot)), so every output equals the plain version's
// bitwise, for any f32 inputs, and is the same from launch to launch.
// Every add, product and quotient is an explicit _rn intrinsic, so nvcc
// contracts nothing but the one fmaf.
//
// Design: one cooperative grid (cudaLaunchCooperativeKernel, as many
// blocks as the occupancy calculator lets reside at once) runs the phases
//   links(0) | flows(0) | links(1) | flows(1) | ... | flows(fair_iters)
// with a grid-wide barrier at each '|': 2 * fair_iters + 1 barriers, five
// at fair_iters = 2, and no memset and no atomics on data.  The barrier is
// one word that every block adds to with release semantics, bit 31
// flipping when the last arrives (no -rdc build needed).  Values written in
// one phase are read in the next with plain loads: each block's thread 0
// acquires the word and bar.sync passes that on to its block, so by the
// PTX memory model the reads see every block's writes (the acquire drops
// the SM's stale L1 lines), and a phase still reuses what its SM's L1
// caches (faster than reading through L2 alone).  chip_smoke.py holds
// every output bitwise against the plain version, which a stale read
// would break.
//   links: a warp takes lpw consecutive links (lpw = links / warps, 11 at
//          the main cell on 132 blocks of 1024 threads), whose entries are
//          contiguous in the plan: its 32 lanes load up to 128 of them at
//          once with their flows' state, park the values in shared memory,
//          and lane j adds link j's in order, then keeps what the flows
//          gather of it (the fair share or the scale, and load / cap in
//          the util round), so each flow slot costs one gather;
//   flows: one thread a flow loads up to 10 slots' link ids at once, then
//          their links' values, and writes its demand and live layer as
//          one 8-byte record, so each plan entry of the next link phase
//          costs one gather (round 0 reads weight, activity and layer).
//
// What bounds it on the H100: latency, never bytes or arithmetic.  A step
// at the main cell (F = 10 830, S = 9, E = 42 599, 110 173 plan entries
// for fatpaths) must move about 0.7 MB (0.22 us at 3.35 TB/s); the six
// phases are chains of two or three dependent L2 reads each, and each
// barrier is a round trip of every block to one L2 word.  On an NVIDIA
// H100 80GB HBM3 at 700.00 W (chip_smoke.py, the main sweep's 160 calls
// replayed) a call takes 0.016 ms of device time against 0.0137 for the
// four launches and memset it replaces, of which the five barriers take
// about 0.85 us each and the link phases 1.8-2.8 us, the flow phases
// 1.2-1.7 us: PERF.md §6.
// Passing phase_ns makes block 0 write %globaltimer at the start, after
// each barrier and at its end, and every block write it as it arrives at
// each barrier, for the per-phase split.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 1e-9f;
constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kUnroll = 4;        // 32-entry chunks a warp loads at once
constexpr int kMaxSlots = 10;     // slots a flow gathers at once

struct Args {
  const int* edges;
  long long edge_stride;
  const float* w;
  const float* desired;
  const uint8_t* active;
  const int* layer;                      // null: every row on layer 0
  const float* cap;
  const float* acc;                      // null: no accumulator
  const int* offsets;
  const unsigned long long* entries;
  int f, s, e_tot, fair_iters;
  float* link_val;                       // (e_tot,) fair share or scale
  float* link_util;                      // (e_tot,) load / cap, or null
  float2* flow_rec;                      // (f,) demand, live layer
  float* sent;
  float* share;
  float* util;                           // null: no util
  float* acc_out;
  unsigned long long* phase_ns;          // null: no timing
};

// A flow's layer in its record when it is not active: no mask has bit 32.
constexpr unsigned int kDead = 32u;

// The grid barrier's word: bit 31 flips once every block has arrived.
// One word per device, so launches of this kernel must not overlap (the
// port issues them on one stream).
__device__ unsigned int g_barrier = 0;

__device__ __forceinline__ void stamp(const Args& a, int k) {
  if (a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.phase_ns[k] = t;
  }
}

// Every block of the cooperative grid adds to one word with release
// semantics: block 0 adds 2^31 - (blocks - 1), the others 1, so bit 31
// flips when the last block arrives and the low bits return to 0.  Each
// block's thread 0 polls with acquire loads until it sees the flip.
__device__ __forceinline__ void grid_barrier(const Args& a, int b) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (a.phase_ns != nullptr) {
      // Each block's arrival, after block 0's 2 * fair_iters + 3 stamps.
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      a.phase_ns[2 * a.fair_iters + 3 +
                 blockIdx.x * (2 * a.fair_iters + 1) + b] = t;
    }
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned int old, cur;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(&g_barrier), "r"(add)
                 : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(cur)
                   : "l"(&g_barrier)
                   : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// Slot -> link id, with inactive rows, -1 padding and ids out of range
// sent to the trash link.
__device__ __forceinline__ int link_of(int e, bool act, int e_tot) {
  return (act && e >= 0 && e < e_tot) ? e : e_tot - 1;
}

// Warps numbered across blocks first, so that a phase with few warps of
// work spreads them over every SM.
__device__ __forceinline__ int global_warp() {
  return (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
}

__device__ __forceinline__ int link_of_slot(const Args& a, int row, int j,
                                            bool act) {
  return j < a.s ? link_of(__ldg(a.edges + row * a.edge_stride + j), act,
                           a.e_tot)
                 : -1;
}

// One round's per-link sums and what the flows gather of them: round 0
// sums the weights into claim counts and keeps fair = cap / max(count,
// 1e-9); later rounds sum the demands and keep scale = min(1, cap /
// max(load, 1e-9)); the util round also keeps load / max(cap, 1e-9).  A
// warp takes lpw consecutive links, whose entries are contiguous in the
// plan: all 32 lanes load them kUnroll chunks at a time with their flows'
// state (round 0: weight, activity and layer; later rounds: the record
// the flow phase wrote), park the values in shared memory, and lane j
// adds link j's values one after another.
__device__ __forceinline__ void link_phase(const Args& a, int round,
                                           int lpw, bool want_u) {
  __shared__ float parked[kWarps][kUnroll * 32];
  const int lane = threadIdx.x & 31;
  float* mine = parked[threadIdx.x >> 5];
  const int n_links = a.e_tot - 1;                 // the trash is not summed
  const int n_warps = gridDim.x * kWarps;
  for (int base = global_warp() * lpw; base < n_links;
       base += n_warps * lpw) {
    // Lane j <= lpw holds the start of link base + j's entries; the
    // warp's entries run from lane 0's start to lane lpw's.
    const int link = min(base + lane, n_links);
    const int beg = lane <= lpw ? __ldg(a.offsets + link) : 0;
    const float cap = lane < lpw ? __ldg(a.cap + link) : 0.0f;
    const int end = __shfl_down_sync(0xffffffffu, beg, 1);
    const int wb = __shfl_sync(0xffffffffu, beg, 0);
    const int we = __shfl_sync(0xffffffffu, beg, lpw);
    float sum = 0.0f;
    for (int c0 = wb; c0 < we; c0 += kUnroll * 32) {
      unsigned long long x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c0 + u * 32 + lane;
        x[u] = i < we ? __ldg(a.entries + i) : 0ull;
      }
      float y[kUnroll];
      unsigned int l[kUnroll];
      if (round == 0) {
        uint8_t act[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int fl = static_cast<int>(x[u] & 0xffffffffu);
          y[u] = __ldg(a.w + fl);
          act[u] = __ldg(a.active + fl);
          l[u] = a.layer != nullptr
                     ? static_cast<unsigned int>(__ldg(a.layer + fl))
                     : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (act[u] == 0) l[u] = kDead;
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float2 r =
              a.flow_rec[static_cast<int>(x[u] & 0xffffffffu)];
          y[u] = r.x;
          l[u] = __float_as_uint(r.y);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned int mask = static_cast<unsigned int>(x[u] >> 32);
        mine[u * 32 + lane] = l[u] < 32u && ((mask >> l[u]) & 1u) ? y[u]
                                                                  : 0.0f;
      }
      __syncwarp();
      if (lane < lpw) {
        const int lo = max(beg, c0);
        const int hi = min(end, c0 + kUnroll * 32);
#pragma unroll 4
        for (int i = lo; i < hi; ++i) sum = __fadd_rn(sum, mine[i - c0]);
      }
      __syncwarp();
    }
    if (lane < lpw && base + lane < n_links) {
      float v = __fdiv_rn(cap, fmaxf(sum, kTiny));
      if (round > 0) v = fminf(1.0f, v);
      a.link_val[base + lane] = v;
      if (want_u)
        a.link_util[base + lane] = __fdiv_rn(sum, fmaxf(cap, kTiny));
    }
  }
}

// One round's per-flow step: gather + masked min, then the new demand,
// and the record the next round's link phase reads.
__device__ __forceinline__ void flow_phase(const Args& a, int round,
                                           bool want_u) {
  const int stride = gridDim.x * blockDim.x;
  const bool last = round == a.fair_iters;
  const int trash = a.e_tot - 1;
  for (int row = global_warp() * 32 + (threadIdx.x & 31); row < a.f;
       row += stride) {
    const bool act = __ldg(a.active + row) != 0;
    const float desired = round == 0 ? __ldg(a.desired + row) : 0.0f;
    const float d_prev = round > 0 ? a.sent[row] : 0.0f;
    const float acc =
        last && a.acc != nullptr ? __ldg(a.acc + row) : 0.0f;
    const unsigned int layer =
        !last && a.layer != nullptr
            ? static_cast<unsigned int>(__ldg(a.layer + row))
            : 0u;
    float m = INFINITY;
    float u = -INFINITY;
    for (int j0 = 0; j0 < a.s; j0 += kMaxSlots) {
      int e[kMaxSlots];
      float v[kMaxSlots], lu[kMaxSlots];
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k)
        e[k] = link_of_slot(a, row, j0 + k, act);
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        const bool live = e[k] >= 0 && e[k] != trash;
        v[k] = live ? a.link_val[e[k]] : INFINITY;
        lu[k] = live && want_u ? a.link_util[e[k]] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        if (e[k] < 0) continue;
        m = fminf(m, v[k]);
        if (want_u) u = fmaxf(u, lu[k]);
      }
    }
    if (want_u) a.util[row] = u;
    float d;
    if (round == 0) {
      a.share[row] = m;
      d = fminf(__fmul_rn(desired, act ? 1.0f : 0.0f), m);
      if (last && a.acc != nullptr) a.acc_out[row] = __fadd_rn(acc, d);
    } else {
      const float s = isfinite(m) ? m : 0.0f;
      d = __fmul_rn(d_prev, s);
      if (last && a.acc != nullptr) a.acc_out[row] = fmaf(d_prev, s, acc);
    }
    a.sent[row] = d;
    if (!last)
      a.flow_rec[row] = make_float2(d, __uint_as_float(act ? layer : kDead));
  }
}

__global__ void __launch_bounds__(kBlock)
    waterfill_kernel(Args a) {
  const int util_round = a.fair_iters < 1 ? a.fair_iters : 1;
  // Links a warp sums: enough for one sweep over the links, at most 31
  // (lane lpw holds the last link's end).
  const int n_warps = gridDim.x * kWarps;
  const int lpw = min(31, max(1, (a.e_tot - 1 + n_warps - 1) / n_warps));
  int k = 0;
  stamp(a, k++);
  for (int r = 0; r <= a.fair_iters; ++r) {
    const bool want_u = a.util != nullptr && r == util_round;
    link_phase(a, r, lpw, want_u);
    grid_barrier(a, 2 * r);
    stamp(a, k++);
    flow_phase(a, r, want_u);
    if (r < a.fair_iters) {
      grid_barrier(a, 2 * r + 1);
      stamp(a, k++);
    }
  }
  stamp(a, k);
}

int grid_blocks() {
  static int blocks[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (blocks[dev] == 0) {
    int per_sm = 0, sms = 0, coop = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, waterfill_kernel, kBlock, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
            cudaSuccess || !coop)
      return 0;
    blocks[dev] = per_sm * sms;
  }
  return blocks[dev];
}

}  // namespace

extern "C" {

// edges: (f, s) int32 with row stride edge_stride; w, desired, sent, share,
// util, acc, acc_out: (f,) f32 (util, acc, acc_out may be null); active:
// (f,) bytes; layer: (f,) int32 or null; cap: (e_tot,) f32; offsets:
// (e_tot + 1,) int32 and entries: int64, the link plan; scratch: link_val
// and link_util (e_tot,) f32 (link_util null without util), flow_rec (f,)
// float2; phase_ns: (2 * fair_iters + 3 + blocks * (2 * fair_iters + 1),)
// uint64 or null.  Returns a CUDA
// error code (cudaErrorCooperativeLaunchTooLarge's value if the card
// cannot run a cooperative grid).
int waterfill_launch(const int* edges, int edge_stride, const float* w,
                     const float* desired, const uint8_t* active,
                     const int* layer, const float* cap, const float* acc,
                     const int* offsets, const unsigned long long* entries,
                     int f, int s, int e_tot, int fair_iters, float* link_val,
                     float* link_util, float* flow_rec, float* sent,
                     float* share, float* util, float* acc_out,
                     unsigned long long* phase_ns, void* stream) {
  const int blocks = grid_blocks();
  if (blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess
                                ? err
                                : cudaErrorCooperativeLaunchTooLarge);
  }
  Args a{edges,    edge_stride, w,       desired,
         active,   layer,       cap,     acc,
         offsets,  entries,     f,       s,
         e_tot,    fair_iters,  link_val, link_util,
         reinterpret_cast<float2*>(flow_rec), sent, share, util,
         acc_out,  phase_ns};
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(waterfill_kernel), dim3(blocks), dim3(kBlock),
      params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the cooperative grid on the current device (0 if it cannot
// run one): sizes the phase_ns buffer.
int waterfill_grid_blocks() { return grid_blocks(); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
