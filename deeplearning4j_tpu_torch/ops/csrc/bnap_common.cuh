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
#include "activations.cuh"

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
