// Flash-attention forward for Hopper (sm_90a), f32.
//
// Replaces the forward Pallas TPU kernel behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_flash_call` (:589): the library
// kernel `_flash_attention_impl` (jax/experimental/pallas/ops/tpu/
// flash_attention.py, pallas_call at :758 in JAX 0.9.0). It computes
//
//   o   [B, L, H, D] = softmax(q k^T * scale, causal or full) v
//   lse [B, H, L]    = the log of each row's softmax denominator, max included
//
// from q, k, v [B, L, H, D] f32 with equal head counts (the layer repeats GQA's
// K/V heads first). The TPU kernel saves the row max m and sum l apart; one
// lse = m + log(l) is all the backward needs.
//
// Design: one block per (q tile of 64 rows, head, batch row), launched longest
// causal row first. It keeps its q tile in shared memory, loops over the k/v
// tiles with the online softmax (running max m and sum l per row in registers,
// the 64 x D output accumulator in registers, the tile's probabilities in
// shared memory), and with `causal` stops at the diagonal tile: tiles wholly
// above the diagonal are never loaded, and only the diagonal tile is masked.
// Rows and columns past L are masked at the tile edge and never loaded, so any
// L >= 1 runs. A masked score takes no part in max or sum, which is what the
// dense version's f32-min fill gives (exp(f32_min - m) is 0 in f32); a causal
// row always keeps its diagonal, so no row is fully masked. expf and logf
// (not __expf): the o and lse gates are 1e-4 of max |plain|.
//
// What bounds it on this card: the f32 operations, 4 B H L^2 D (half that when
// causal), far above its bytes at L >= 256; SIMT FMA from shared-memory tiles
// here, with no tensor cores (TF32 wgmma is later work).
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace dl4j_flash;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int L, int H, float scale) {
  constexpr int P = Dims<D>::kStride;
  constexpr int kOut = Dims<D>::kOut;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + Dims<D>::kTileFloats;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* p_s = v_s + Dims<D>::kTileFloats;  // [64][kSStride] probabilities
  const int nt = (L + kTile - 1) / kTile;
  const int qt = nt - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int q0 = qt * kTile;
  load_tile<D>(q_s, q, base, q0, L, rs);

  float acc[kSub][kOut];
  float m[kSub], l[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = 0.f;
  }

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, p_s
    load_tile<D>(k_s, k, base, k0, L, rs);
    load_tile<D>(v_s, v, base, k0, L, rs);
    __syncthreads();
    float s[kSub][kSub];
    tile_dot<D>(q_s, k_s, ty, tx, s);
    const bool edge = (kCausal && kt == qt) || k0 + kTile > L;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const bool keep = !edge || live<kCausal>(q0 + r, k0 + tx + 16 * j, L);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[i][j] - m_use);
        p_s[r * kSStride + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    // acc[r][d] += sum_c p[r][c] * v[c][d]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[kSub], vv[kOut];
#pragma unroll
      for (int i = 0; i < kSub; ++i) pv[i] = p_s[(ty + 16 * i) * kSStride + c];
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) vv[jj] = v_s[c * P + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  const long long lbase = ((long long)b * H + h) * L;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < L) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj)
        o[base + (long long)row * rs + tx + 16 * jj] = acc[i][jj] * inv;
      if (tx == 0) lse[lbase + row] = m[i] + logf(l[i]);
    }
  }
}

template <int D, bool kCausal>
int run(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int L, int H, float scale, cudaStream_t stream) {
  const size_t smem =
      (3 * (size_t)Dims<D>::kTileFloats + (size_t)kTile * kSStride) * sizeof(float);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  return launch(flash_fwd_kernel<D, kCausal>, grid, smem, stream, q, k, v, o, lse,
                L, H, scale);
}

template <int D>
int dispatch(bool causal, const float* q, const float* k, const float* v,
             float* o, float* lse, int B, int L, int H, float scale,
             cudaStream_t stream) {
  return causal ? run<D, true>(q, k, v, o, lse, B, L, H, scale, stream)
                : run<D, false>(q, k, v, o, lse, B, L, H, scale, stream);
}

}  // namespace

// Shared memory per block: 116.75 KiB at D = 128, 68.75 KiB at D = 64.
extern "C" int dl4j_flash_fwd_f32(const float* q, const float* k, const float* v,
                                  float* o, float* lse, int B, int L, int H, int D,
                                  int causal, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return dispatch<16>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 32: return dispatch<32>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 64: return dispatch<64>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 128: return dispatch<128>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
