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

}  // namespace dl4j
