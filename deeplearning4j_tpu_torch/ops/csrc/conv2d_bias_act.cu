// Fused NHWC conv2d + bias + activation, forward, for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_conv2d_bias_act_forward` (:119, pallas_call :144, body `_conv_kernel` :92):
//
//   x    [B, H, W, C]        f32, NHWC
//   w    [KH, KW, C, OC]     f32, HWIO; flattened it is the [K, OC] matrix,
//                            K = KH * KW * C in (ki, kj, c) order
//   b    [OC]                f32
//   out  [B, OH, OW, OC]     f32 = act(conv(x, w) + b); as a matrix [M, OC],
//                            M = B * OH * OW
//   pre  [B, OH, OW, OC]     f32 = conv(x, w) + b, the pre-activation, written
//                            only when the pointer is not null (the training
//                            path keeps it for the activation's gradient)
//
// Geometry (stride, the top/left pads, OH, OW) comes from the wrapper, which
// computes it as `_conv_geometry` (:72) does, SAME's asymmetric pads included;
// input rows and columns outside [0, H) x [0, W) read as zero.
//
// Design: an implicit GEMM. A block owns a 64 x 64 tile of the [M, OC] output
// and walks K in slices of 16. For each slice it loads the [64 x 16] slice of
// the virtual im2col matrix straight from x, decomposing k into (ki, kj, c)
// and bounds-checking the padded position per element, and the [16 x 64]
// slice of w, both into shared memory; each of the 256 threads then
// accumulates a 4 x 4 micro-tile in f32 FMA registers. Bias and activation
// are fused into the store. No im2col matrix is ever written to device memory
// (the TPU kernel still materialised a kw-fold row expansion).
//
// What bounds it on this card: at the AlexNet shapes the f32 operations
// (2 * M * OC * K; 19.3 GFLOP for conv2 and conv3 at batch 512) against 67
// TFLOP/s outside the tensor cores; conv1 (K = 27) is bound by its bytes.
// This simple SIMT kernel reaches a fraction of that; wgmma/TF32 tiles, TMA
// loads and a multi-stage pipeline are later work.
//
// Differences from the TPU kernel: the Pallas grid ran (batch tile, output
// row, kernel row) in order and accumulated the kernel rows in the resident
// output block; here one block owns a whole output tile and the reduction
// over (ki, kj, c) is a loop inside the block. The ragged edges (M and OC not
// multiples of 64, e.g. OC = 50, K not a multiple of 16) are masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // keeps float4 rows aligned and spreads the banks

struct Geom {
  int B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act;
};

__global__ void __launch_bounds__(kThreads)
    conv2d_bias_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ out,
                           float* __restrict__ pre, Geom g) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const long long M = (long long)g.B * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each

  // this thread loads column a_k of the A slice, at rows a_r + 16 * i
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  long long a_base[4];  // offset of x[n, 0, 0, 0]
  int a_ih0[4], a_iw0[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + a_r + 16 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int ow = (int)(mm % g.OW);
    const long long t = mm / g.OW;
    const int oh = (int)(t % g.OH);
    const long long n = t / g.OH;
    a_base[i] = n * g.H * g.W * g.C;
    a_ih0[i] = oh * g.SH - g.PT;
    a_iw0[i] = ow * g.SW - g.PL;
  }
  // and row b_k + 4 * i of the B slice, at column b_n
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + a_k;
    const int c = k % g.C;
    const int kk = k / g.C;
    const int kj = kk % g.KW;
    const int ki = kk / g.KW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      const int ih = a_ih0[i] + ki;
      const int iw = a_iw0[i] + kj;
      if (a_ok[i] && k < K && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = x[a_base[i] + ((long long)ih * g.W + iw) * g.C + c];
      As[a_k][a_r + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = b_k + 4 * i;
      const int n = n0 + b_n;
      Bs[kr][b_n] = (k0 + kr < K && n < g.OC) ? w[(long long)(k0 + kr) * g.OC + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[q][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.OC) continue;
      const float z = acc[i][j] + bias[n];
      if (pre != nullptr) pre[m * g.OC + n] = z;
      out[m * g.OC + n] = dl4j::activate(g.act, z);
    }
  }
}

}  // namespace

extern "C" int dl4j_conv2d_bias_act_f32(const float* x, const float* w, const float* b,
                                        float* out, float* pre, int B, int H, int W,
                                        int C, int KH, int KW, int OC, int OH, int OW,
                                        int SH, int SW, int PT, int PL, int act,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || KH < 1 || KW < 1 || OC < 1 || OH < 1 ||
      OW < 1 || SH < 1 || SW < 1 || act < 0 || act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * OH * OW;
  const long long mt = (M + kBM - 1) / kBM;
  const int nt = (OC + kBN - 1) / kBN;
  if (mt > 2147483647LL || nt > 65535) return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act};
  conv2d_bias_act_kernel<<<dim3((unsigned)mt, nt), kThreads, 0, (cudaStream_t)stream>>>(
      x, w, b, out, pre, g);
  return (int)cudaGetLastError();
}
