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

}  // namespace

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
