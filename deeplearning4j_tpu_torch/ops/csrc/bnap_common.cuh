// The recompute shared by the two passes of the fused BN + activation + 2x2/s2
// max-pool backward (bnap_sums.cu, bnap_dx.cu): port of `_bnap_recompute`,
// deeplearning4j_tpu/ops/pallas_kernels.py :250.
//
// One thread owns one (pooled position, channel). From x and the per-channel
// params p = (mean, inv, gamma, beta) it rebuilds, for the four inputs of its
// 2x2 window, x_hat = (x - mean) * inv, z = x_hat * gamma + beta and a = act(z);
// routes the pooled gradient g to the window's maxima, split evenly among tied
// maxima (g / count, the convention of :275-279, which is jnp.max's own
// gradient), and returns g_z = routed * act'(z).
//
// x_hat and z are rounded step by step (__fmul_rn / __fadd_rn, never fused into
// an FMA), so the kernel decides the same maxima and ties as the plain PyTorch
// version, whose elementwise ops each round to f32.
#pragma once
#include <stdint.h>

#include "activations.cuh"
#include "sm90_common.cuh"

namespace dl4j {

struct Window {
  long long off[4];  // offsets of the four inputs in x (NHWC)
  float xh[4];
  float gz[4];
};

__device__ __forceinline__ void bnap_recompute(const float* __restrict__ x, float g,
                                               long long base, long long row, int C,
                                               float mean, float inv, float gam, float bet,
                                               int act, Window& win) {
  win.off[0] = base;
  win.off[1] = base + C;
  win.off[2] = base + row;
  win.off[3] = base + row + C;
  float z[4], a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    win.xh[j] = __fmul_rn(__fsub_rn(x[win.off[j]], mean), inv);
    z[j] = __fadd_rn(__fmul_rn(win.xh[j], gam), bet);
    a[j] = activate(act, z[j]);
  }
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  float cnt = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) cnt += a[j] == m ? 1.f : 0.f;
  const float share = g / cnt;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    win.gz[j] = (a[j] == m ? share : 0.f) * activate_grad(act, z[j]);
}

// v rounded to bf16 (to nearest even) and back to f32: the activation as a
// bf16 forward's pool compared it.
__device__ __forceinline__ float bf16_round(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return __uint_as_float((unsigned)h << 16);
}

// The same recompute on a window already loaded (bnap_sums.cu loads a lane's
// four window inputs as float4s and calls this once per channel of the
// lane): x_hat and g_z of the four inputs xv[j], in the order of Window.
// Every step rounds as bnap_recompute rounds it, so both decide the same
// maxima and ties and give the same bits. The tie share g / cnt is taken by
// a multiply where cnt is 1, 2 or 4 (exact, so the same bits as the
// division) and divided only for a 3-way tie.
//
// With kRoundBf16 (a bf16 x, widened to f32), the activations are rounded to
// bf16 before the maximum and the tie count (JAX pallas_kernels.py :272-275:
// distinct f32 activations may tie once rounded, and then share the
// gradient); act'(z) is still taken at the f32 z.
template <bool kRoundBf16 = false>
__device__ __forceinline__ void bnap_recompute_vals(const float xv[4], float g,
                                                    float mean, float inv, float gam,
                                                    float bet, int act, float xh[4],
                                                    float gz[4]) {
  float z[4], a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xh[j] = __fmul_rn(__fsub_rn(xv[j], mean), inv);
    z[j] = __fadd_rn(__fmul_rn(xh[j], gam), bet);
    a[j] = activate(act, z[j]);
    if constexpr (kRoundBf16) a[j] = bf16_round(a[j]);
  }
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  float cnt = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) cnt += a[j] == m ? 1.f : 0.f;
  const float share =
      cnt == 3.f ? __fdiv_rn(g, 3.f)
                 : __fmul_rn(g, cnt == 1.f ? 1.f : (cnt == 2.f ? 0.5f : 0.25f));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    gz[j] = __fmul_rn(a[j] == m ? share : 0.f, activate_grad(act, z[j]));
}

}  // namespace dl4j

// ---------------------------------------------------------------------------
// The ring loader of the bf16 kernels' ring route (bnap_sums.cu
// bnap_sums_ring_kernel, bnap_dx.cu bnap_dx_ring_kernel).
//
// In NHWC, pooled row r = b * H/2 + ph has its x as one contiguous run of
// 2 W C bf16 (image rows 2 ph and 2 ph + 1), its g as W/2 C and its dx as
// 2 W C. An item is a run of wn pooled columns [w0, w0 + wn) of one pooled
// row: two bulk copies of x (the top and the bottom image row, 2 wn C bf16
// each) and one of g (wn C), 10 wn C bytes, into one stage of a ring in
// shared memory. wn = min(W/2, kRingRowCap / (2 C)): at AlexNet's three
// shapes (W C = 2048) an item is a whole pooled row, 8 KiB of x and 2 KiB
// of g; wider rows split into nchunks = ceil(W/2 / wn) items.
//
// A block is kRingConsumers consumer threads and one producer warp, whose
// first thread issues every copy (1-d cp.async.bulk, completing the stage's
// full mbarrier; x and g marked first to evict from L2, as they are read
// once) and, in the dx kernel, every store of dx from the stage
// (cp.async.bulk to global memory). The ring has kRingSumsStages stages in
// the sums kernel and kRingDxStages in the dx kernel. The grid is
// persistent: block b walks items b, b + grid, ...
// (cuda_kernels.bnap_bf16_plan: kRingBlocksPerSm blocks on every SM of an
// H100, whose items differ by one at most). A consumer owns one lane of
// kRingLaneC = 8 channels (16 bytes), fixed for the whole walk, so its
// per-channel parameters stay in registers; P = kRingConsumers / (C / 8)
// consumers share a lane, consumer (slot, lane) taking the stage's pooled
// columns slot, slot + P, ... of every item. It waits on the stage's full
// barrier, reads its windows with 16-byte shared loads, and arrives on the
// stage's empty barrier; the dx kernel first writes dx over the window's x
// in the stage and fences it for the bulk store. No division in the walk:
// items step by a fixed (rows, chunks) pair.
//
// The route (ring_route) takes a bf16 launch when C is a multiple of
// kRingC (a lane is 16 bytes, every copy a multiple of 16 bytes), C is at
// most kRingMaxC (one lane a consumer; one pooled column fits a stage), x,
// g and dx start on kRingAlign bytes (the bulk copies' alignment), and B H
// W C is at most kRingMaxElems (every offset an int). The lane kernels
// (a thread per pooled position and channel in bnap_dx.cu, lanes of 4 or 1
// channels in bnap_sums.cu) take every other bf16 launch;
// cuda_kernels.bnap_bf16_route reads these kRing constants from this file.
namespace dl4j_bnap_ring {

using namespace dl4j_sm90;

constexpr int kRingC = 8;
constexpr int kRingMaxC = 1024;
constexpr int kRingAlign = 16;
constexpr long long kRingMaxElems = 2147483647LL;
constexpr int kRingRowCap = 2048;
constexpr int kRingBlocksPerSm = 3;
constexpr int kRingLaneC = 8;
constexpr int kRingConsumers = 128;
constexpr int kRingSumsStages = 2;
constexpr int kRingDxStages = 6;
static_assert(kRingMaxC <= kRingLaneC * kRingConsumers, "one lane a consumer");
static_assert(kRingC % kRingLaneC == 0, "lanes tile C");
static_assert(2 * kRingMaxC <= kRingRowCap, "a pooled column fits a stage");

// a stage: x's top image row, its bottom one, g (bf16 elements)
constexpr int kStageElems = 2 * kRingRowCap + kRingRowCap / 2;
constexpr int kStageBytes = 2 * kStageElems;
static_assert(kStageBytes % 16 == 0, "stages start on 16 bytes");

// A ring of kStages stages in dynamic shared memory: the stages, then the
// full and the empty barriers.
template <int kStages>
struct Ring {
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8;
  uint16_t* stages;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ explicit Ring(uint8_t* smem)
      : stages(reinterpret_cast<uint16_t*>(smem)),
        full(reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes)),
        empty(full + kStages) {}
  __device__ __forceinline__ static int next(int s) { return s + 1 == kStages ? 0 : s + 1; }
  // thread 0 initialises the barriers, seen by the whole block after the
  // barrier; a stage is empty once its `consumers` consumers have arrived
  __device__ __forceinline__ void init(int consumers) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], consumers);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

inline bool ring_route(int B, int H, int W, int C, const void* x, const void* g,
                       const void* dx) {
  const auto aligned = [](const void* p) {
    return (uintptr_t)p % kRingAlign == 0;
  };
  return B >= 1 && H >= 2 && W >= 2 && H % 2 == 0 && W % 2 == 0 && C >= kRingC &&
         C % kRingC == 0 && C <= kRingMaxC &&
         (long long)B * H * W * C <= kRingMaxElems && aligned(x) && aligned(g) &&
         aligned(dx);
}

// The walk of a launch: its shape and the plan's wn, nchunks and grid.
struct Walk {
  int W, C, wn, nchunks, items, grid;
};

// The walk of (B, H, W, C) under the plan (wn, nchunks, grid), or false
// when the plan is not cuda_kernels.bnap_bf16_plan's (wn, nchunks) or the
// grid is empty or larger than the items.
inline bool ring_walk(int B, int H, int W, int C, int wn, int nchunks, int grid,
                      Walk* w) {
  const int W2 = W / 2;
  const int want = kRingRowCap / (2 * C) < W2 ? kRingRowCap / (2 * C) : W2;
  if (wn != want || nchunks != (W2 + wn - 1) / wn) return false;
  const long long items = (long long)B * (H / 2) * nchunks;
  if (items > kRingMaxElems || grid < 1 || grid > items) return false;
  *w = Walk{W, C, wn, nchunks, (int)items, grid};
  return true;
}

// A block's place in its walk, item blockIdx.x + n grid as (pooled row r,
// chunk k), stepped with no division.
struct Cursor {
  int r, k, dr, dk, nchunks;
  __device__ __forceinline__ explicit Cursor(const Walk& w) : nchunks(w.nchunks) {
    r = blockIdx.x / w.nchunks;
    k = blockIdx.x - r * w.nchunks;
    dr = w.grid / w.nchunks;
    dk = w.grid - dr * w.nchunks;
  }
  __device__ __forceinline__ void advance() {
    r += dr;
    k += dk;
    if (k >= nchunks) k -= nchunks, ++r;
  }
};

// items of this block's walk
__device__ __forceinline__ int block_items(const Walk& w) {
  return (w.items - (int)blockIdx.x + w.grid - 1) / w.grid;
}

// The producer (one thread). Loads run kStages items ahead of the
// consumers; with kStore (dx), kStages - 1: item j's stage is stored
// once its consumers are done, and a stage is loaded again only once the
// store before the latest has read it.
template <bool kStore, int kStages>
__device__ __forceinline__ void produce(const uint16_t* x, const uint16_t* g,
                                        uint16_t* dx, const Walk& w,
                                        const Ring<kStages>& ring) {
  uint16_t* stages = ring.stages;
  uint64_t* full = ring.full;
  uint64_t* empty = ring.empty;
  const int count = block_items(w);
  const int W2 = w.W / 2, WC = w.W * w.C;
  // element offsets of the item's x (and dx) run and of its g run, and its
  // bytes of x per image row
  const auto where = [&](const Cursor& cur, int& xo, int& go, uint32_t& bytes) {
    const int w0 = cur.k * w.wn;
    const int cols = W2 - w0 < w.wn ? W2 - w0 : w.wn;
    go = cur.r * W2 * w.C + w0 * w.C;
    xo = 2 * (cur.r * WC + w0 * w.C);
    bytes = 4u * (uint32_t)(cols * w.C);
  };
  // x and g are read once: their lines go first when L2 needs room
  const uint64_t once = l2_evict_first();
  const auto load = [&](int s, const Cursor& cur) {
    int xo, go;
    uint32_t bytes;
    where(cur, xo, go, bytes);
    uint16_t* st = stages + s * kStageElems;
    mbar_expect_tx(&full[s], bytes * 2 + bytes / 2);
    bulk_load_1d(st, x + xo, bytes, &full[s], once);
    bulk_load_1d(st + kRingRowCap, x + xo + WC, bytes, &full[s], once);
    bulk_load_1d(st + 2 * kRingRowCap, g + go, bytes / 2, &full[s], once);
  };
  constexpr int kAhead = kStore ? kStages - 1 : kStages;
  Cursor ld(w), sto(w);
  int n_ld = 0, s_ld = 0;
  for (; n_ld < kAhead && n_ld < count; ++n_ld) {
    load(s_ld, ld);
    ld.advance();
    s_ld = Ring<kStages>::next(s_ld);
  }
  int s = 0;
  uint32_t ph = 0;
  for (int j = 0; j < count; ++j) {
    mbar_wait(&empty[s], ph);
    if constexpr (kStore) {
      int xo, go;
      uint32_t bytes;
      where(sto, xo, go, bytes);
      const uint16_t* st = stages + s * kStageElems;
      bulk_store_1d(dx + xo, st, bytes);
      bulk_store_1d(dx + xo + WC, st + kRingRowCap, bytes);
      bulk_commit();
      sto.advance();
    }
    if (n_ld < count) {
      if constexpr (kStore) bulk_wait_read<1>();
      load(s_ld, ld);
      ld.advance();
      ++n_ld;
      s_ld = Ring<kStages>::next(s_ld);
    }
    s = Ring<kStages>::next(s);
    if (s == 0) ph ^= 1;
  }
  if constexpr (kStore) bulk_wait<0>();
}

// The consumer side of the walk: for every item of the block, wait for its
// stage, call win(stage, xo, go) on the thread's windows (xo: element offset
// of the window's top-left x in the stage's top row; go: of its g in the
// stage's g), then release the stage (with kStore, after fencing the
// window's writes for the producer's bulk store). slot >= P: no window,
// the thread only keeps the barriers' counts.
template <bool kStore, int kStages, class Win>
__device__ __forceinline__ void consume(const Walk& w, const Ring<kStages>& ring,
                                        int slot, int lane, int P, Win&& win) {
  const int count = block_items(w);
  const int W2 = w.W / 2;
  const int xo0 = 2 * slot * w.C + kRingLaneC * lane, go0 = slot * w.C + kRingLaneC * lane;
  const int xstep = 2 * P * w.C, gstep = P * w.C;
  Cursor cur(w);
  int s = 0;
  uint32_t ph = 0;
  for (int j = 0; j < count; ++j) {
    const int w0 = cur.k * w.wn;
    const int cols = W2 - w0 < w.wn ? W2 - w0 : w.wn;
    uint16_t* st = ring.stages + s * kStageElems;
    mbar_wait(&ring.full[s], ph);
    int xo = xo0, go = go0;
    for (int c = slot; c < cols; c += P, xo += xstep, go += gstep) win(st, xo, go);
    if constexpr (kStore) fence_proxy_async();
    mbar_arrive(&ring.empty[s]);
    cur.advance();
    s = Ring<kStages>::next(s);
    if (s == 0) ph ^= 1;
  }
}

// lo and hi rounded to bf16 (to nearest even, as cvt.rn.bf16.f32 rounds
// each) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// A lane's 2x2 window in a stage, as loaded: x at (top, left), (top, right),
// (bottom, left), (bottom, right), in the order of dl4j::Window, then g; 8
// bf16 channels each (one 16-byte shared load), widened to f32 on use (x(j,
// v), g(v): exact).
struct LaneWindow {
  uint4 q[5];
  __device__ __forceinline__ void load(const uint16_t* st, int xo, int go, int C) {
    const auto at = [&](int i) { return *reinterpret_cast<const uint4*>(st + i); };
    q[0] = at(xo);
    q[1] = at(xo + C);
    q[2] = at(kRingRowCap + xo);
    q[3] = at(kRingRowCap + xo + C);
    q[4] = at(2 * kRingRowCap + go);
  }
  __device__ __forceinline__ float x(int j, int v) const {
    const uint32_t w = v < 2 ? q[j].x : v < 4 ? q[j].y : v < 6 ? q[j].z : q[j].w;
    return __uint_as_float(v % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
  __device__ __forceinline__ float g(int v) const { return x(4, v); }
};

// The per-channel parameters of a lane (p [4, C] = mean, inv, gamma, beta)
struct LaneParams {
  float mean[kRingLaneC], inv[kRingLaneC], gam[kRingLaneC], bet[kRingLaneC];
  __device__ __forceinline__ void load(const float* __restrict__ p, int C, int c0) {
#pragma unroll
    for (int v = 0; v < kRingLaneC; ++v) {
      mean[v] = __ldg(p + c0 + v);
      inv[v] = __ldg(p + C + c0 + v);
      gam[v] = __ldg(p + 2 * C + c0 + v);
      bet[v] = __ldg(p + 3 * C + c0 + v);
    }
  }
};

}  // namespace dl4j_bnap_ring
