// Fused BN + activation + 2x2/s2 max-pool backward, pass 2: the input
// gradient, for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_bnap_dx_kernel` (:301, pallas_call :400 in `_get_bnap_fn.fn_bwd` :356):
//
//   x    [B, H, W, C]        f32, the BN input (H, W even)
//   g    [B, H/2, W/2, C]    f32, the gradient of the pooled output
//   p    [4, C]              f32: batch mean, 1/sqrt(var + eps), gamma, beta
//   s    [2, C]              f32: d beta, d gamma (from bnap_sums.cu)
//   dx   [B, H, W, C]        f32 = inv * gamma * (g_z - dbeta / n - x_hat * dgamma / n),
//                            n = B * H * W (the formula of :309)
//
// Design: one thread per (pooled position, channel), consecutive threads on
// consecutive channels; each recomputes its 2x2 window once (bnap_common.cuh)
// and writes the window's four dx values. The formula is rounded step by step
// in the order of the plain version, so the two agree to the last bit when
// their sums agree.
//
// What bounds it on this card: the bytes of x and g read once and dx written
// once.
//
// The bf16 kernel (dl4j_bnap_dx_bf16) takes x and g in bf16 and writes dx in
// bf16, as the JAX kernel writes dx in x.dtype (:309): the same thread per
// (pooled position, channel), x and g widened to f32, the window's
// activations rounded to bf16 before the maximum and the tie count
// (bnap_recompute_vals<true>), the formula in f32 in the same order, and one
// rounding to bf16 (to nearest even) at the store. Its bound is the bytes at
// two bytes an element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnap_common.cuh"

namespace {

constexpr int kThreads = 256;

// One body for both dtypes: T is float, or uint16_t for bf16 bits. The f32
// instantiation recomputes through bnap_recompute as it always has; the bf16
// one widens its loads to f32, rounds the activations before the max
// (bnap_recompute_vals<true>) and rounds dx once at the store.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bnap_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ p, const float* __restrict__ s,
                   T* __restrict__ dx, int B, int H, int W, int C, int act) {
  const int H2 = H / 2, W2 = W / 2;
  const long long total = (long long)B * H2 * W2 * C;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const long long pp = i / C;
  const int pw = (int)(pp % W2);
  const long long t = pp / W2;
  const int ph = (int)(t % H2);
  const long long b = t / H2;
  const float inv = p[C + c], gam = p[2 * C + c];
  const float n = (float)((long long)B * H * W);
  const float s_b = s[c] / n;
  const float s_g = s[C + c] / n;
  const long long base = ((b * H + 2 * ph) * W + 2 * pw) * C + c;
  if constexpr (sizeof(T) == sizeof(float)) {
    dl4j::Window win;
    dl4j::bnap_recompute(x, g[i], base, (long long)W * C, C, p[c], inv, gam,
                         p[3 * C + c], act, win);
    const float scale = __fmul_rn(inv, gam);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dx[win.off[j]] =
          __fmul_rn(scale, __fsub_rn(__fsub_rn(win.gz[j], s_b), __fmul_rn(win.xh[j], s_g)));
  } else {
    const long long off[4] = {base, base + C, base + (long long)W * C,
                              base + (long long)W * C + C};
    float xv[4], xh[4], gz[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = __uint_as_float((unsigned)__ldg(x + off[j]) << 16);
    const float gv = __uint_as_float((unsigned)__ldg(g + i) << 16);
    dl4j::bnap_recompute_vals<true>(xv, gv, p[c], inv, gam, p[3 * C + c], act, xh, gz);
    const float scale = __fmul_rn(inv, gam);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d =
          __fmul_rn(scale, __fsub_rn(__fsub_rn(gz[j], s_b), __fmul_rn(xh[j], s_g)));
      unsigned short h;
      asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(d));
      dx[off[j]] = h;
    }
  }
}

int check_dims(int B, int H, int W, int C, int act, long long* blocks) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || act < 0 ||
      act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * (H / 2) * (W / 2) * C;
  *blocks = (total + kThreads - 1) / kThreads;
  return *blocks > 2147483647LL ? (int)cudaErrorInvalidValue : 0;
}

// -- the bf16 ring route (bnap_common.cuh dl4j_bnap_ring) ---------------------

namespace ring = dl4j_bnap_ring;

constexpr int kStages = ring::kRingDxStages;
constexpr int kLaneC = ring::kRingLaneC;
constexpr int kConsumers = ring::kRingConsumers;
constexpr int kRingThreads = kConsumers + 32;  // and one producer warp

// dx of a lane's window in its stage st, written over its x: each channel
// recomputed by bnap_recompute_vals<true> and the formula rounded step by
// step in the lane kernel's order, so dx is that kernel's bits; two
// channels rounded to bf16 in one instruction (cvt.rn.bf16x2.f32 rounds
// each half as cvt.rn.bf16.f32 does).
template <int ACT>
__device__ __forceinline__ void dx_lane_window(uint16_t* st, int xo, int go, int C,
                                               const ring::LaneParams& pr,
                                               const float (&scale)[kLaneC],
                                               const float (&s_b)[kLaneC],
                                               const float (&s_g)[kLaneC]) {
  ring::LaneWindow win;
  win.load(st, xo, go, C);
  uint32_t out[4][kLaneC / 2];  // [input j][word]
#pragma unroll
  for (int v = 0; v < kLaneC; v += 2) {
    float d[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xv[4] = {win.x(0, v + h), win.x(1, v + h), win.x(2, v + h),
                           win.x(3, v + h)};
      float xh[4], gz[4];
      dl4j::bnap_recompute_vals<true>(xv, win.g(v + h), pr.mean[v + h], pr.inv[v + h],
                                      pr.gam[v + h], pr.bet[v + h], ACT, xh, gz);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[h][j] = __fmul_rn(scale[v + h], __fsub_rn(__fsub_rn(gz[j], s_b[v + h]),
                                                    __fmul_rn(xh[j], s_g[v + h])));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j][v / 2] = ring::pack_bf16x2(d[0][j], d[1][j]);
  }
  const int at[4] = {xo, xo + C, ring::kRingRowCap + xo, ring::kRingRowCap + xo + C};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(st + at[j]) =
        make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
}

// dx on the ring: consumer (slot, lane) recomputes each of its windows as
// the lane kernel does, so dx is that kernel's bits, and writes the
// window's dx over its x in the stage; the producer stores the stage's two
// image rows to dx with bulk copies.
template <int ACT>
__global__ void __launch_bounds__(kRingThreads, ring::kRingBlocksPerSm)
    bnap_dx_ring_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ g,
                        const float* __restrict__ p, const float* __restrict__ s,
                        uint16_t* __restrict__ dx, const ring::Walk w, float n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const ring::Ring<kStages> rg(smem);
  rg.init(kConsumers);
  const int t = threadIdx.x;
  if (t >= kConsumers) {
    if (t == kConsumers) ring::produce<true>(x, g, dx, w, rg);
    return;
  }
  const int C = w.C, lanes = C / kLaneC, P = kConsumers / lanes;
  const int lane = t % lanes, slot = t / lanes;
  const int c0 = kLaneC * lane;
  ring::LaneParams pr;
  pr.load(p, C, c0);
  float scale[kLaneC], s_b[kLaneC], s_g[kLaneC];
#pragma unroll
  for (int v = 0; v < kLaneC; ++v) {
    scale[v] = __fmul_rn(pr.inv[v], pr.gam[v]);
    s_b[v] = __ldg(s + c0 + v) / n;
    s_g[v] = __ldg(s + C + c0 + v) / n;
  }
  ring::consume<true>(w, rg, slot < P ? slot : ring::kRingRowCap, lane, P,
                              [&](uint16_t* st, int xo, int go) {
                                dx_lane_window<ACT>(st, xo, go, C, pr, scale, s_b, s_g);
                              });
}

using RingKernel = void (*)(const uint16_t*, const uint16_t*, const float*, const float*,
                            uint16_t*, const ring::Walk, float);

RingKernel ring_kernel_for(int act) {
  switch (act) {
    case dl4j::kIdentity: return bnap_dx_ring_kernel<dl4j::kIdentity>;
    case dl4j::kRelu: return bnap_dx_ring_kernel<dl4j::kRelu>;
    case dl4j::kTanh: return bnap_dx_ring_kernel<dl4j::kTanh>;
    case dl4j::kSigmoid: return bnap_dx_ring_kernel<dl4j::kSigmoid>;
    default: return nullptr;
  }
}

}  // namespace

// The bf16 ring route (bnap_common.cuh: ring_route must hold); the plan
// (wn, nchunks, grid) is cuda_kernels.bnap_bf16_plan's.
extern "C" int dl4j_bnap_dx_bf16_ring(const uint16_t* x, const uint16_t* g, const float* p,
                                      const float* s, uint16_t* dx, int B, int H, int W,
                                      int C, int act, int wn, int nchunks, int grid,
                                      void* stream) {
  ring::Walk w;
  const RingKernel kernel = ring_kernel_for(act);
  if (kernel == nullptr || !ring::ring_route(B, H, W, C, x, g, dx) ||
      !ring::ring_walk(B, H, W, C, wn, nchunks, grid, &w))
    return (int)cudaErrorInvalidValue;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring::Ring<kStages>::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, kRingThreads, ring::Ring<kStages>::kSmem, (cudaStream_t)stream>>>(
      x, g, p, s, dx, w, (float)((long long)B * H * W));
  return (int)cudaGetLastError();
}

// Registers, local bytes per thread and shared bytes (static and dynamic)
// of the ring kernel of activation code act, into out[3].
extern "C" int dl4j_bnap_dx_bf16_ring_attrs(int act, int* out) {
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

// The bf16 kernel: x, g and dx as bf16 bits; p and s f32.
extern "C" int dl4j_bnap_dx_bf16(const uint16_t* x, const uint16_t* g, const float* p,
                                 const float* s, uint16_t* dx, int B, int H, int W, int C,
                                 int act, void* stream) {
  long long blocks = 0;
  const int rc = check_dims(B, H, W, C, act, &blocks);
  if (rc != 0) return rc;
  bnap_dx_kernel<uint16_t><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, g, p, s, dx, B, H, W, C, act);
  return (int)cudaGetLastError();
}

// {registers, local bytes per thread, static shared bytes} of the bf16
// kernel into out[3].
extern "C" int dl4j_bnap_dx_bf16_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bnap_dx_kernel<uint16_t>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int dl4j_bnap_dx_f32(const float* x, const float* g, const float* p,
                                const float* s, float* dx, int B, int H, int W, int C,
                                int act, void* stream) {
  long long blocks = 0;
  const int rc = check_dims(B, H, W, C, act, &blocks);
  if (rc != 0) return rc;
  bnap_dx_kernel<float><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, g, p, s, dx, B, H, W, C, act);
  return (int)cudaGetLastError();
}
