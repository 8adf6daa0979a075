// Fused BN + activation + 2x2/s2 max-pool backward, pass 1: the per-channel
// sums, for Hopper (sm_90a), f32.
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
// Design: a block of 32 x 8 threads owns 32 consecutive channels (so a warp
// reads 128 contiguous bytes of NHWC memory) and walks the pooled positions
// blockIdx.y * 8 + threadIdx.y, stepping by gridDim.y * 8, keeping its two
// running sums in registers. The block then adds its 8 rows in a fixed order
// and writes one partial per (block row, channel); a second kernel adds the
// gridDim.y partials of each channel in order. No float atomics: the sums are
// bitwise the same from run to run (the TPU kernel carried them in its
// resident output block across the sequential grid, which CUDA blocks cannot).
//
// What bounds it on this card: the bytes of x and g, read once each (x is
// four times g); the arithmetic is a few operations per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnap_common.cuh"

namespace {

constexpr int kCh = 32;    // channels per block
constexpr int kRows = 8;   // pooled-position rows per block

__global__ void __launch_bounds__(kCh * kRows)
    bnap_sums_partial(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ p, float* __restrict__ part, int B,
                      int H, int W, int C, int act) {
  __shared__ float sb[kRows][kCh + 1];
  __shared__ float sg[kRows][kCh + 1];
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int H2 = H / 2, W2 = W / 2;
  const long long P = (long long)B * H2 * W2;
  float db = 0.f, dg = 0.f;
  if (c < C) {
    const float mean = p[c], inv = p[C + c], gam = p[2 * C + c], bet = p[3 * C + c];
    const long long row = (long long)W * C;
    for (long long pp = (long long)blockIdx.y * kRows + threadIdx.y; pp < P;
         pp += (long long)gridDim.y * kRows) {
      const int pw = (int)(pp % W2);
      const long long t = pp / W2;
      const int ph = (int)(t % H2);
      const long long b = t / H2;
      const long long base = ((b * H + 2 * ph) * W + 2 * pw) * C + c;
      dl4j::Window win;
      dl4j::bnap_recompute(x, g[pp * C + c], base, row, C, mean, inv, gam, bet, act,
                           win);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        db += win.gz[j];
        dg += win.gz[j] * win.xh[j];
      }
    }
  }
  sb[threadIdx.y][threadIdx.x] = db;
  sg[threadIdx.y][threadIdx.x] = dg;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float tb = 0.f, tg = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      tb += sb[r][threadIdx.x];
      tg += sg[r][threadIdx.x];
    }
    part[(long long)(2 * blockIdx.y) * C + c] = tb;
    part[(long long)(2 * blockIdx.y + 1) * C + c] = tg;
  }
}

__global__ void bnap_sums_final(const float* __restrict__ part, float* __restrict__ dg,
                                float* __restrict__ db, int C, int rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float tb = 0.f, tg = 0.f;
  for (int r = 0; r < rows; ++r) {
    tb += part[(long long)(2 * r) * C + c];
    tg += part[(long long)(2 * r + 1) * C + c];
  }
  db[c] = tb;
  dg[c] = tg;
}

}  // namespace

// part: scratch of [rows, 2, C] f32, rows = dl4j_bnap_sums_rows(...)
extern "C" int dl4j_bnap_sums_rows(int B, int H, int W, int C) {
  const long long P = (long long)B * (H / 2) * (W / 2);
  const int cblocks = (C + kCh - 1) / kCh;
  // about 1024 blocks in all (8 per SM on 132 SMs), each row of blocks
  // walking at least one position per thread
  long long rows = 1024 / cblocks;
  const long long need = (P + kRows - 1) / kRows;
  if (rows > need) rows = need;
  if (rows < 1) rows = 1;
  return (int)rows;
}

extern "C" int dl4j_bnap_sums_f32(const float* x, const float* g, const float* p,
                                  float* part, float* dg, float* db, int B, int H, int W,
                                  int C, int act, int rows, void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || rows < 1 ||
      rows > 65535 || act < 0 || act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  bnap_sums_partial<<<dim3((C + kCh - 1) / kCh, rows), dim3(kCh, kRows), 0, s>>>(
      x, g, p, part, B, H, W, C, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bnap_sums_final<<<(C + 127) / 128, 128, 0, s>>>(part, dg, db, C, rows);
  return (int)cudaGetLastError();
}
