// Splash-attention forward for Hopper (sm_90a), f32, driven by the block table.
//
// Replaces the forward Pallas TPU kernel behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_splash_call` (:609): the
// library's `_splash_attention_forward` (jax/experimental/pallas/ops/tpu/
// splash_attention/splash_attention_kernel.py :895, pallas_call at :1137,
// body `flash_attention_kernel` :696, JAX 0.9.0). From q (pre-scaled by the
// caller, as `_splash_call` folds the scale into q), k, v [B, L, H, D] f32:
//
//   o   [B, L, H, D] = softmax(q k^T, masked) v
//   lse [B, H, L]    = m + log(l), the row max m and softmax sum l
//
// Design: one block per (q block of 128 rows, head, batch row), most table
// entries first (the table lists i + 1 kv blocks for causal q block i). The
// block reads its row of the forward block list (splash_common.cuh) and walks
// only the kv blocks it names, in the library's order; empty blocks are never
// loaded. It runs its q block as two 64-row halves, each with the online
// softmax of the library kernel: m starts at the mask value, l at 0, and each
// 64-key tile of a listed block updates m, l and the 64 x D output in
// registers, the tile's probabilities in shared memory. Full (kind-2) blocks
// run no mask code; partial (kind-1) blocks evaluate q >= k and fill the rest
// with the mask value, and skip a tile whose every key follows every query of
// the half (it would add exp(mask - m) = 0). L % 128 == 0, so no tile is
// ragged. expf and logf, not __expf.
//
// What bounds it on this card: the f32 operations of the kept blocks, 4 D per
// kept (query, key) pair, far above its bytes at L >= 1024; SIMT FMA from
// shared-memory tiles (flash_common.cuh), no tensor cores.
#include <cuda_runtime.h>
#include <math.h>

#include "splash_common.cuh"

namespace {

using namespace dl4j_splash;

template <int D>
__global__ void __launch_bounds__(kThreads)
    splash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ counts,
                      const int* __restrict__ blocks, const int* __restrict__ kinds,
                      int L, int H, int R, int W) {
  constexpr int P = Dims<D>::kStride;
  constexpr int kOut = Dims<D>::kOut;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + Dims<D>::kTileFloats;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* p_s = v_s + Dims<D>::kTileFloats;  // [64][kSStride] probabilities
  const int nq = L / kBlock;
  const int qb = nq - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, nq, h, qb);

  for (int half = 0; half < kHalves; ++half) {
    const int q0 = qb * kBlock + half * kTile;
    __syncthreads();  // the previous half's readers are done with q_s
    load_tile<D>(q_s, q, base, q0, L, rs);
    float acc[kSub][kOut];
    float m[kSub], l[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      m[i] = kMaskValue;
      l[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = 0.f;
    }
    for (int e = 0; e < row.count; ++e) {
      const int kind = row.kinds[e];
      for (int sub = 0; sub < kHalves; ++sub) {
        const int k0 = row.blocks[e] * kBlock + sub * kTile;
        if (tile_masked(kind, q0, k0)) continue;
        __syncthreads();  // the previous tile's readers are done
        load_tile<D>(k_s, k, base, k0, L, rs);
        load_tile<D>(v_s, v, base, k0, L, rs);
        __syncthreads();
        float s[kSub][kSub];
        tile_dot<D>(q_s, k_s, ty, tx, s);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int r = ty + 16 * i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            if (kind == 1 && q0 + r < k0 + tx + 16 * j) s[i][j] = kMaskValue;
            mx = fmaxf(mx, s[i][j]);
          }
          mx = half_warp_max(mx);
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const float p = expf(s[i][j] - m_new);
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
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = q0 + ty + 16 * i;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj)
        o[base + (long long)r * rs + tx + 16 * jj] = acc[i][jj] * inv;
      if (tx == 0) lse[lbase + r] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
int run(const float* q, const float* k, const float* v, float* o, float* lse,
        const int* counts, const int* blocks, const int* kinds, int B, int L,
        int H, int R, int W, cudaStream_t stream) {
  const size_t smem =
      (3 * (size_t)Dims<D>::kTileFloats + (size_t)kTile * kSStride) * sizeof(float);
  const dim3 grid(L / kBlock, H, B);
  return launch(splash_fwd_kernel<D>, grid, smem, stream, q, k, v, o, lse, counts,
                blocks, kinds, L, H, R, W);
}

}  // namespace

// Shared memory per block: 116.75 KiB at D = 128, 68.75 KiB at D = 64.
extern "C" int dl4j_splash_fwd_f32(const float* q, const float* k, const float* v,
                                   float* o, float* lse, const int* counts,
                                   const int* blocks, const int* kinds, int B,
                                   int L, int H, int D, int R, int W,
                                   void* stream) {
  if (bad_dims(B, L, H, R, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return run<16>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 32: return run<32>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 64: return run<64>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 128: return run<128>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
