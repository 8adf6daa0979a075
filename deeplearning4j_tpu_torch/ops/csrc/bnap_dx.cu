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
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnap_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bnap_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ p, const float* __restrict__ s,
                   float* __restrict__ dx, int B, int H, int W, int C, int act) {
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
  dl4j::Window win;
  dl4j::bnap_recompute(x, g[i], base, (long long)W * C, C, p[c], inv, gam, p[3 * C + c],
                       act, win);
  const float scale = __fmul_rn(inv, gam);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dx[win.off[j]] =
        __fmul_rn(scale, __fsub_rn(__fsub_rn(win.gz[j], s_b), __fmul_rn(win.xh[j], s_g)));
}

}  // namespace

extern "C" int dl4j_bnap_dx_f32(const float* x, const float* g, const float* p,
                                const float* s, float* dx, int B, int H, int W, int C,
                                int act, void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || act < 0 ||
      act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * (H / 2) * (W / 2) * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bnap_dx_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, g, p, s, dx, B, H, W, C, act);
  return (int)cudaGetLastError();
}
