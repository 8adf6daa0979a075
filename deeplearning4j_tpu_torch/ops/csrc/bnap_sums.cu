// Fused BN + activation + 2x2/s2 max-pool backward, pass 1: the per-channel
// sums, for Hopper (sm_90a), x and g in f32 or in bf16, the sums in f32.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_bnap_sums_kernel` (:286, pallas_call :388 in `_get_bnap_fn.fn_bwd` :356):
//
//   x    [B, H, W, C]        f32, the BN input (H, W even)
//   g    [B, H/2, W/2, C]    f32, the gradient of the pooled output
//   p    [4, C]              f32: batch mean, 1/sqrt(var + eps), gamma, beta
//   dg   [C]                 f32 = sum over the batch of g_z * x_hat  (d gamma)
//   db   [C]                 f32 = sum over the batch of g_z          (d beta)
//
// with g_z recomputed per element as bnap_common.cuh describes.
//
// The bf16 kernel (dl4j_bnap_sums_bf16) is the same kernel with x and g
// loaded as bf16 and widened to f32 (a lane's four channels are one 8-byte
// load), and the window's activations rounded to bf16 before the maximum and
// the tie count (bnap_recompute_vals<true>), as the JAX kernel compares them
// after the cast to x.dtype (:272-275); p, the partial rows and the sums
// stay f32. Its bound is the bytes of x and g at two bytes an element.
//
// What bounds it on this card: the bytes of x and g, read once each (x is
// four times g); the arithmetic is a few operations per element. The design
// keeps the loads wide and many, and the loop free of anything else:
//
//   - a lane owns VEC = 4 consecutive channels (one float4 of x or g, 16 B;
//     VEC = 1 where C % 4 != 0 or an input is not 16-byte aligned), and a
//     block is cl x pl threads: cl lanes across the channels, pl threads
//     along the pooled positions;
//   - pooled row r = b * H/2 + ph starts at x + 2 r W C and g + r W/2 C, so
//     a block owns a run of rpb pooled rows and each thread walks them with
//     incremented pointers, pw = pwl, pwl + pwn, ... inside a row: no
//     division or modulo in the loop. Thread row ty is (ry, pwl) =
//     (ty / pwn, ty % pwn), rl = pl / pwn rows at a time; at AlexNet's three
//     shapes pwn = W/2 and rl = 1. Two rows are in flight per iteration:
//     ten 16-byte loads per lane;
//   - the grid is (channel blocks, ceil(R / rpb)) with rpb from a fixed
//     formula (cuda_kernels.bnap_sums_plan): about two blocks per SM, one
//     wave of equal blocks, every AlexNet shape included (conv3 has only
//     8 x 8 positions per image, so its blocks own 8 rows of 4);
//   - the sums are the same bits on every run, with no float atomics: a
//     block adds its thread rows in order in shared memory and writes one
//     partial row; the last block of each group of `group` row blocks
//     (found by a ticket counter after __threadfence) adds the group's
//     partial rows in a fixed order, and the last group does the same over
//     the group rows into dg and db, all in this one launch. Each counter
//     is back at 0 when its last block leaves, so the wrapper allocates
//     them once per stream.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "bnap_common.cuh"

namespace {

constexpr int kThreads = 256;

// VEC consecutive floats of one lane.
template <int VEC>
struct Lane;

template <>
struct Lane<4> {
  using T = float;
  static constexpr bool kBf16 = false;
  float v[4];
  __device__ __forceinline__ void ldg(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  // rows written by other blocks of this launch: read through L2
  __device__ __forceinline__ void ldcg(const float* p) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
};

template <>
struct Lane<1> {
  using T = float;
  static constexpr bool kBf16 = false;
  float v[1];
  __device__ __forceinline__ void ldg(const float* p) { v[0] = __ldg(p); }
  __device__ __forceinline__ void ldcg(const float* p) { v[0] = __ldcg(p); }
};

// VEC consecutive bf16 of one lane (x or g of the bf16 kernel), widened to
// f32 (exact): four are one 8-byte load.
template <int VEC>
struct LaneBf16;

template <>
struct LaneBf16<4> {
  using T = uint16_t;
  static constexpr bool kBf16 = true;
  float v[4];
  __device__ __forceinline__ void ldg(const uint16_t* p) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
  }
};

template <>
struct LaneBf16<1> {
  using T = uint16_t;
  static constexpr bool kBf16 = true;
  float v[1];
  __device__ __forceinline__ void ldg(const uint16_t* p) {
    v[0] = __uint_as_float((unsigned)__ldg(p) << 16);
  }
};

template <int VEC>
struct Params {
  Lane<VEC> mean, inv, gam, bet;
};

// One pooled position: load its 2x2 window (row stride wc) and g, recompute
// and add to the lane's sums in window order. L is Lane<VEC> (f32) or
// LaneBf16<VEC>.
template <class L>
__device__ __forceinline__ void load_window(const typename L::T* xw,
                                            const typename L::T* gw, int C, int wc,
                                            L (&w)[4], L& gv) {
  w[0].ldg(xw);
  w[1].ldg(xw + C);
  w[2].ldg(xw + wc);
  w[3].ldg(xw + wc + C);
  gv.ldg(gw);
}

template <class L, int VEC, int ACT>
__device__ __forceinline__ void add_window(const L (&w)[4], const L& gv,
                                           const Params<VEC>& pr, float (&sb)[VEC],
                                           float (&sg)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float xv[4] = {w[0].v[v], w[1].v[v], w[2].v[v], w[3].v[v]};
    float xh[4], gz[4];
    dl4j::bnap_recompute_vals<L::kBf16>(xv, gv.v[v], pr.mean.v[v], pr.inv.v[v],
                                        pr.gam.v[v], pr.bet.v[v], ACT, xh, gz);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sb[v] = __fadd_rn(sb[v], gz[j]);
      sg[v] = __fmaf_rn(gz[j], xh[j], sg[v]);
    }
  }
}

// The block's pl thread rows of (sb, sg), added in order (row 0 first) per
// channel, into out_b[c] and out_g[c] for the block's channels c >= cbase.
template <int VEC>
__device__ __forceinline__ void block_sum(const float (&sb)[VEC], const float (&sg)[VEC],
                                          float* red, int C, int cbase, float* out_b,
                                          float* out_g) {
  const int cl = blockDim.x, pl = blockDim.y;
  const int clv = cl * VEC;
  const int at = threadIdx.y * clv + threadIdx.x * VEC;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red[at + v] = sb[v];
    red[pl * clv + at + v] = sg[v];
  }
  __syncthreads();
  for (int f = threadIdx.y * cl + threadIdx.x; f < 2 * clv; f += cl * pl) {
    const int k = f >= clv;
    const int j = f - k * clv;
    if (cbase + j < C) {
      const float* col = red + k * pl * clv + j;
      float t = 0.f;
      for (int r = 0; r < pl; ++r) t = __fadd_rn(t, col[r * clv]);
      (k ? out_g : out_b)[cbase + j] = t;
    }
  }
  __syncthreads();  // red is written again by the next level
}

// Thread row ty adds partial rows ty, ty + pl, ... of rows [n][2][C] in
// order, for the lane's channels c0.. (block_sum then adds the thread rows).
template <int VEC>
__device__ __forceinline__ void fold_rows(const float* rows, int n, int C, int c0, bool ok,
                                          float (&sb)[VEC], float (&sg)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) sb[v] = sg[v] = 0.f;
  if (!ok) return;
#pragma unroll 4
  for (int q = threadIdx.y; q < n; q += blockDim.y) {
    Lane<VEC> b, g;
    b.ldcg(rows + 2LL * q * C + c0);
    g.ldcg(rows + (2LL * q + 1) * C + c0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sb[v] = __fadd_rn(sb[v], b.v[v]);
      sg[v] = __fadd_rn(sg[v], g.v[v]);
    }
  }
}

// Arrival of this block at `counter`, one of n: true in the last block to
// arrive, which also sets the counter back to 0. Every thread's writes are
// fenced first, so the last block reads them all.
__device__ __forceinline__ bool arrive(unsigned* counter, unsigned n, bool& last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(counter, 1u) + 1 == n;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// L: the lane type of x and g, Lane<VEC> or LaneBf16<VEC>
template <class L, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    bnap_sums_kernel(const typename L::T* __restrict__ x,
                     const typename L::T* __restrict__ g,
                     const float* __restrict__ p, float* __restrict__ part,
                     float* __restrict__ dg, float* __restrict__ db,
                     unsigned* __restrict__ ticket, int C, int W, int R, int rpb, int pwn,
                     int rl, int group, int ngroups) {
  __shared__ float red[2 * kThreads * 4];
  __shared__ bool last;
  const int W2 = W / 2;
  const int cbase = blockIdx.x * blockDim.x * VEC;
  const int c0 = cbase + threadIdx.x * VEC;
  const bool lane_ok = c0 < C;
  const int ry = threadIdx.y / pwn, pwl = threadIdx.y - ry * pwn;
  float sb[VEC], sg[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sb[v] = sg[v] = 0.f;
  if (lane_ok && ry < rl) {
    Params<VEC> pr;
    pr.mean.ldg(p + c0);
    pr.inv.ldg(p + C + c0);
    pr.gam.ldg(p + 2 * C + c0);
    pr.bet.ldg(p + 3 * C + c0);
    const long long xrow = 2LL * W * C, grow = (long long)W2 * C;
    const int wc = W * C;
    const int r_end = min(R, (int)(blockIdx.y + 1) * rpb);
    int r = blockIdx.y * rpb + ry;
    const typename L::T* xr = x + r * xrow + 2 * pwl * C + c0;
    const typename L::T* gr = g + r * grow + pwl * C + c0;
    // two rows (r, r + rl) per iteration, then the odd row
    for (; r + rl < r_end; r += 2 * rl, xr += 2 * rl * xrow, gr += 2 * rl * grow) {
      int xo = 0, go = 0;
      for (int pw = pwl; pw < W2; pw += pwn, xo += 2 * pwn * C, go += pwn * C) {
        L a[4], b[4], ga, gb;
        load_window(xr + xo, gr + go, C, wc, a, ga);
        load_window(xr + rl * xrow + xo, gr + rl * grow + go, C, wc, b, gb);
        add_window<L, VEC, ACT>(a, ga, pr, sb, sg);
        add_window<L, VEC, ACT>(b, gb, pr, sb, sg);
      }
    }
    if (r < r_end) {
      int xo = 0, go = 0;
      for (int pw = pwl; pw < W2; pw += pwn, xo += 2 * pwn * C, go += pwn * C) {
        L a[4], ga;
        load_window(xr + xo, gr + go, C, wc, a, ga);
        add_window<L, VEC, ACT>(a, ga, pr, sb, sg);
      }
    }
  }
  // level 1: this block's partial row
  block_sum(sb, sg, red, C, cbase, part + 2LL * blockIdx.y * C,
            part + (2LL * blockIdx.y + 1) * C);
  // level 2: the last block of the group adds the group's rows
  const int grp = blockIdx.y / group;
  const int first = grp * group;
  const int n = min(group, (int)gridDim.y - first);
  unsigned* tk = ticket + blockIdx.x * (ngroups + 1);
  if (!arrive(tk + grp, n, last)) return;
  float* gpart = part + 2LL * gridDim.y * C;
  fold_rows(part + 2LL * first * C, n, C, c0, lane_ok, sb, sg);
  block_sum(sb, sg, red, C, cbase, gpart + 2LL * grp * C, gpart + (2LL * grp + 1) * C);
  // level 3: the last group's block adds the group rows
  if (!arrive(tk + ngroups, ngroups, last)) return;
  fold_rows(gpart, ngroups, C, c0, lane_ok, sb, sg);
  block_sum(sb, sg, red, C, cbase, db, dg);
}

bool aligned(const void* p, unsigned n) { return ((uintptr_t)p & (n - 1)) == 0; }

template <typename T>
using Kernel = void (*)(const T*, const T*, const float*, float*, float*, float*,
                        unsigned*, int, int, int, int, int, int, int, int);

// The kernel of a lane type and an activation code (the four the fused
// backward recomputes: identity, relu, tanh, sigmoid), or nullptr. The
// activation is a template parameter, so its switch folds away in the loop.
template <class L, int VEC>
Kernel<typename L::T> kernel_for(int act) {
  switch (act) {
    case dl4j::kIdentity: return bnap_sums_kernel<L, VEC, dl4j::kIdentity>;
    case dl4j::kRelu: return bnap_sums_kernel<L, VEC, dl4j::kRelu>;
    case dl4j::kTanh: return bnap_sums_kernel<L, VEC, dl4j::kTanh>;
    case dl4j::kSigmoid: return bnap_sums_kernel<L, VEC, dl4j::kSigmoid>;
    default: return nullptr;
  }
}

// The f32 (T = float) or bf16 (T = uint16_t) kernel of lane width vec and
// activation code act, or nullptr.
template <typename T>
Kernel<T> kernel_of(int vec, int act) {
  using L4 = std::conditional_t<sizeof(T) == 4, Lane<4>, LaneBf16<4>>;
  using L1 = std::conditional_t<sizeof(T) == 4, Lane<1>, LaneBf16<1>>;
  if (vec == 4) return kernel_for<L4, 4>(act);
  return vec == 1 ? kernel_for<L1, 1>(act) : nullptr;
}

// The checks and the launch shared by the f32 and bf16 entry points; x and g
// take 4 elements' bytes of alignment for a lane of four.
template <typename T>
int launch(const T* x, const T* g, const float* p, float* part, float* dg, float* db,
           unsigned* ticket, int B, int H, int W, int C, int act, int vec, int cl, int pl,
           int pwn, int rl, int rpb, int rblocks, int group, int ngroups, void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || 2LL * W * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec != 4) || C % vec || cl < 1 || pl < 1 || cl * pl > kThreads ||
      pwn < 1 || rl < 1 || pwn * rl > pl || rpb < 1 || group < 1)
    return (int)cudaErrorInvalidValue;
  const Kernel<T> kernel = kernel_of<T>(vec, act);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned xalign = 4 * sizeof(T);
  if (vec == 4 && !(aligned(x, xalign) && aligned(g, xalign) && aligned(p, 16) &&
                    aligned(part, 16)))
    return (int)cudaErrorMisalignedAddress;
  const long long R = (long long)B * (H / 2);
  if (R > INT_MAX || rblocks != (R + rpb - 1) / rpb || rblocks > 65535 ||
      ngroups != (rblocks + group - 1) / group)
    return (int)cudaErrorInvalidValue;
  const int cblocks = (C / vec + cl - 1) / cl;
  kernel<<<dim3(cblocks, rblocks), dim3(cl, pl), 0, (cudaStream_t)stream>>>(
      x, g, p, part, dg, db, ticket, C, W, (int)R, rpb, pwn, rl, group, ngroups);
  return (int)cudaGetLastError();
}

template <typename T>
int kernel_attrs(Kernel<T> kernel, int* out) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// -- the bf16 ring route (bnap_common.cuh dl4j_bnap_ring) ---------------------

namespace ring = dl4j_bnap_ring;

constexpr int kStages = ring::kRingSumsStages;
constexpr int kLaneC = ring::kRingLaneC;
constexpr int kConsumers = ring::kRingConsumers;
constexpr int kRingThreads = kConsumers + 32;  // and one producer warp

// Rows [n][2C] of rows (f32, written by other blocks of this launch: read
// through L2), added in order per column by the block's consumers into
// out_b[f] (f < C) and out_g[f - C]; a consumer takes 4 columns at a time
// (C % 8 == 0: the 4 lie in one half), and keeps 8 rows' loads in flight.
__device__ __forceinline__ void ring_fold(const float* rows, int n, int C, float* out_b,
                                          float* out_g) {
  const int C2 = 2 * C;
  for (int f = 4 * threadIdx.x; f < C2; f += 4 * kConsumers) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int q = 0; q < n; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(rows + (long long)q * C2 + f));
      t.x = __fadd_rn(t.x, v.x);
      t.y = __fadd_rn(t.y, v.y);
      t.z = __fadd_rn(t.z, v.z);
      t.w = __fadd_rn(t.w, v.w);
    }
    *reinterpret_cast<float4*>(f < C ? out_b + f : out_g + (f - C)) = t;
  }
}

// A lane's window (kLaneC channels) added to the lane's sums, with the
// values of bnap_recompute_vals<true> taken with no branch: ties counted in
// floats, a 3-way tie's share g / 3 as the division's fast path (one
// product corrected by its residual: RN(g / 3) wherever g / 3 is a normal
// f32, every bf16 g of magnitude 2^-124 or more), two channels'
// activations rounded to bf16 in one instruction (cvt.rn.bf16x2.f32
// rounds each half as cvt.rn.bf16.f32 does). A routed 0 may be -0 here,
// which no sum sees. The window's elements are added in order: db += g_z,
// dg = fma(g_z, x_hat, dg).
template <int ACT>
__device__ __forceinline__ void add_lane_window(const ring::LaneWindow& win,
                                                const ring::LaneParams& pr,
                                                float (&sb)[kLaneC], float (&sg)[kLaneC]) {
  constexpr float kThird = 1.f / 3.f;
#pragma unroll
  for (int v = 0; v < kLaneC; v += 2) {
    float xh[2][4], z[2][4], a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xh[h][j] = __fmul_rn(__fsub_rn(win.x(j, v + h), pr.mean[v + h]), pr.inv[v + h]);
        z[h][j] = __fadd_rn(__fmul_rn(xh[h][j], pr.gam[v + h]), pr.bet[v + h]);
        a[h][j] = dl4j::activate(ACT, z[h][j]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t r = ring::pack_bf16x2(a[0][j], a[1][j]);
      a[0][j] = __uint_as_float(r << 16);
      a[1][j] = __uint_as_float(r & 0xffff0000u);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = fmaxf(fmaxf(a[h][0], a[h][1]), fmaxf(a[h][2], a[h][3]));
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = a[h][j] == m ? 1.f : 0.f;
      const float cnt = __fadd_rn(__fadd_rn(e[0], e[1]), __fadd_rn(e[2], e[3]));
      const float g = win.g(v + h);
      const float q = __fmul_rn(g, kThird);
      const float third = __fmaf_rn(__fmaf_rn(-3.f, q, g), kThird, q);
      const float share =
          cnt == 3.f ? third : __fmul_rn(g, cnt == 4.f ? 0.25f : (cnt == 2.f ? 0.5f : 1.f));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gz =
            __fmul_rn(__fmul_rn(e[j], share), dl4j::activate_grad(ACT, z[h][j]));
        sb[v + h] = __fadd_rn(sb[v + h], gz);
        sg[v + h] = __fmaf_rn(gz, xh[h][j], sg[v + h]);
      }
    }
  }
}

// Arrival of this block's consumers at `counter`, one of n: true in the
// last block to arrive, which also sets the counter back to 0. The
// consumers' writes are ordered before the arrival by the named barrier
// and thread 0's fence (cumulative at device scope), so the last block
// reads them all.
__device__ __forceinline__ bool ring_arrive(unsigned* counter, unsigned n, bool& last) {
  dl4j_sm90::bar_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) + 1 == n;
    if (last) *counter = 0;
  }
  dl4j_sm90::bar_sync(1, kConsumers);
  return last;
}

// The sums on the ring: consumer (slot, lane) adds its windows' g_z and g_z
// x_hat into kLaneC f32 pairs in the order of its walk (item by item,
// column slot, slot + P, ... of each, window element by element: db +=
// g_z, dg = fma(g_z, x_hat, dg)); the block adds its slots in order (slot 0 first)
// into its partial row part[b] = (db, dg); the last block of each group of
// `group` blocks adds the group's rows in order, and the last group's block
// the group rows, into db and dg. No float atomics: the same bits on every
// run. cuda_kernels.bnap_bf16_plan gives the plan; the CPU tests emulate
// this order.
template <int ACT>
__global__ void __launch_bounds__(kRingThreads, ring::kRingBlocksPerSm)
    bnap_sums_ring_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                          const float* __restrict__ p, float* __restrict__ part,
                          float* __restrict__ dg, float* __restrict__ db,
                          unsigned* __restrict__ ticket, const ring::Walk w, int group,
                          int ngroups) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ bool last;
  const ring::Ring<kStages> rg(smem);
  rg.init(kConsumers);
  const int t = threadIdx.x;
  if (t >= kConsumers) {
    if (t == kConsumers) ring::produce<false>(x, g, nullptr, w, rg);
    return;
  }
  const int C = w.C, lanes = C / kLaneC, P = kConsumers / lanes;
  const int lane = t % lanes, slot = t / lanes;
  ring::LaneParams pr;
  pr.load(p, C, kLaneC * lane);
  float sb[kLaneC], sg[kLaneC];
#pragma unroll
  for (int v = 0; v < kLaneC; ++v) sb[v] = sg[v] = 0.f;
  ring::consume<false>(w, rg, slot < P ? slot : ring::kRingRowCap, lane, P,
                               [&](const uint16_t* st, int xo, int go) {
                                 ring::LaneWindow win;
                                 win.load(st, xo, go, C);
                                 add_lane_window<ACT>(win, pr, sb, sg);
                               });
  // level 1: the block's slots, in order, into its partial row. Every stage
  // has been waited for, so the ring's memory holds no copy in flight.
  float* red = reinterpret_cast<float*>(smem);
  const int C2 = 2 * C;
  dl4j_sm90::bar_sync(1, kConsumers);
  if (slot < P) {
#pragma unroll
    for (int v = 0; v < kLaneC; ++v) {
      red[slot * C2 + kLaneC * lane + v] = sb[v];
      red[slot * C2 + C + kLaneC * lane + v] = sg[v];
    }
  }
  dl4j_sm90::bar_sync(1, kConsumers);
  float* row = part + (long long)blockIdx.x * C2;
  for (int f = t; f < C2; f += kConsumers) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) acc = __fadd_rn(acc, red[q * C2 + f]);
    row[f] = acc;
  }
  // level 2: the last block of the group adds the group's rows
  const int grp = blockIdx.x / group;
  const int first = grp * group;
  const int n = min(group, w.grid - first);
  if (!ring_arrive(ticket + grp, n, last)) return;
  float* gpart = part + (long long)w.grid * C2;
  ring_fold(part + (long long)first * C2, n, C, gpart + (long long)grp * C2,
            gpart + (long long)grp * C2 + C);
  // level 3: the last group's block adds the group rows
  if (!ring_arrive(ticket + ngroups, ngroups, last)) return;
  ring_fold(gpart, ngroups, C, db, dg);
}

using RingKernel = void (*)(const uint16_t*, const uint16_t*, const float*, float*, float*,
                            float*, unsigned*, const ring::Walk, int, int);

RingKernel ring_kernel_for(int act) {
  switch (act) {
    case dl4j::kIdentity: return bnap_sums_ring_kernel<dl4j::kIdentity>;
    case dl4j::kRelu: return bnap_sums_ring_kernel<dl4j::kRelu>;
    case dl4j::kTanh: return bnap_sums_ring_kernel<dl4j::kTanh>;
    case dl4j::kSigmoid: return bnap_sums_ring_kernel<dl4j::kSigmoid>;
    default: return nullptr;
  }
}

}  // namespace

// The bf16 ring route (bnap_common.cuh: ring_route must hold). part:
// scratch of [grid + ngroups, 2, C] f32, and dg and db, 16-byte aligned;
// ticket: ngroups + 1 counters, all 0 before the launch and after it. The plan (wn, nchunks, grid, group,
// ngroups) is cuda_kernels.bnap_bf16_plan's.
extern "C" int dl4j_bnap_sums_bf16_ring(const uint16_t* x, const uint16_t* g,
                                        const float* p, float* part, float* dg, float* db,
                                        unsigned* ticket, int B, int H, int W, int C,
                                        int act, int wn, int nchunks, int grid, int group,
                                        int ngroups, void* stream) {
  ring::Walk w;
  const RingKernel kernel = ring_kernel_for(act);
  if (kernel == nullptr || !ring::ring_route(B, H, W, C, x, g, nullptr) ||
      !ring::ring_walk(B, H, W, C, wn, nchunks, grid, &w) || group < 1 ||
      ngroups != (grid + group - 1) / group)
    return (int)cudaErrorInvalidValue;
  if (!(aligned(part, 16) && aligned(dg, 16) && aligned(db, 16)))
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring::Ring<kStages>::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, kRingThreads, ring::Ring<kStages>::kSmem, (cudaStream_t)stream>>>(
      x, g, p, part, dg, db, ticket, w, group, ngroups);
  return (int)cudaGetLastError();
}

// Registers, local bytes per thread and shared bytes (static and dynamic)
// of the ring kernel of activation code act, into out[3].
extern "C" int dl4j_bnap_sums_bf16_ring_attrs(int act, int* out) {
  const RingKernel kernel = ring_kernel_for(act);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + ring::Ring<kStages>::kSmem;
  return 0;
}

// part: scratch of [rblocks + ngroups, 2, C] f32. ticket: cblocks x
// (ngroups + 1) counters, all 0 before the launch and after it. The plan
// (vec, cl, pl, pwn, rl, rpb, rblocks, group, ngroups) is
// cuda_kernels.bnap_sums_plan's; cblocks = ceil(C / vec / cl).
extern "C" int dl4j_bnap_sums_f32(const float* x, const float* g, const float* p,
                                  float* part, float* dg, float* db, unsigned* ticket,
                                  int B, int H, int W, int C, int act, int vec, int cl,
                                  int pl, int pwn, int rl, int rpb, int rblocks, int group,
                                  int ngroups, void* stream) {
  return launch(x, g, p, part, dg, db, ticket, B, H, W, C, act, vec, cl, pl, pwn, rl, rpb,
                rblocks, group, ngroups, stream);
}

// The same with x and g as bf16 bits (8-byte aligned for vec = 4).
extern "C" int dl4j_bnap_sums_bf16(const uint16_t* x, const uint16_t* g, const float* p,
                                   float* part, float* dg, float* db, unsigned* ticket,
                                   int B, int H, int W, int C, int act, int vec, int cl,
                                   int pl, int pwn, int rl, int rpb, int rblocks,
                                   int group, int ngroups, void* stream) {
  return launch(x, g, p, part, dg, db, ticket, B, H, W, C, act, vec, cl, pl, pwn, rl, rpb,
                rblocks, group, ngroups, stream);
}

// Registers, local (spill) bytes per thread and static shared bytes of the
// kernel of lane width vec and activation code act as the loaded binary has
// them, into out[3].
extern "C" int dl4j_bnap_sums_attrs(int vec, int act, int* out) {
  return kernel_attrs(kernel_of<float>(vec, act), out);
}

// The same for the bf16 kernel.
extern "C" int dl4j_bnap_sums_bf16_attrs(int vec, int act, int* out) {
  return kernel_attrs(kernel_of<uint16_t>(vec, act), out);
}
