// The bf16 dQ core of the attention backward, Hopper (sm_90a): dq for one
// block's 128 query rows from bf16 q, k, v, dO, under the splash and flash
// dQ kernels (splash_attention_bwd.cu, flash_attention_bwd.cu).
//
// Layout and arithmetic as the f32 core (attn_dq_tc.cuh): q, k, v, dO, dq
// [B, L, H, D] bf16, lse and di [B, H, L] f32. Per kept (query, key) pair
//
//   p  = exp(s - lse)        s = q k^T in f32 (splash: q pre-scaled; flash:
//                            times scale); masked pairs: p = 0
//   ds = p * (dO v^T - di)   dO v^T in f32; flash: ds times scale
//   dq = bf16(ds) k          in f32, written in bf16
//
// which are the libraries' roundings: ds goes to bf16 before ds k (flash
// `ds.astype(k.dtype)` after its scale, flash_attention.py :1258; splash
// :1395), q k^T and dO v^T are f32 dots of bf16 operands, dq accumulates in
// f32. The block and its walk are the f32 core's; the products are bf16
// mma.sync (attn_tile_bf16.cuh: scores_bf16 for s and dp, pv_bf16 with ds as
// the A operand from registers and k's B fragments by ldmatrix.trans).
//
// The tile: 64 keys at every head dim. q (32 KiB) + dO (32 KiB) + a 2-stage
// ring of K+V tiles (64 KiB) is 128 KiB at D = 128: bf16 halves the f32
// core's tiles, so the f32 core's 32-key tiles at D = 128 are not needed.
// No atomics: each dq element is written once, so a launch gives the same
// bits every time.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "attn_tile_bf16.cuh"

namespace dl4j_attn_tc {

template <int D>
struct DqBf16 {
  static constexpr int kKeys = 64;           // keys per K/V tile
  static constexpr int kNK = kKeys / 8;      // n-tiles of s and dp
  static constexpr int kTile = kKeys * D;    // bf16 of a K or V tile
  static constexpr size_t kSmem =
      (2 * (size_t)kRows * D + (size_t)kStages * 2 * kTile) * sizeof(uint16_t);
};

// dq of the block's 128 query rows from q0 of head h, batch row b, over the
// tiles ``walk`` lists, in tiles of DqBf16<D>::kKeys keys: the f32 core's
// attn_dq with bf16 tiles and products. For flash (Walk::kFlash) the scale
// is on s and on ds before its rounding, as the library applies it.
template <int D, class Walk>
__device__ __forceinline__ void attn_dq_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    uint16_t* __restrict__ dq, int L, int H, int q0, int h, int b,
    const Walk& walk, float mask, uint16_t* smem) {
  constexpr int KT = DqBf16<D>::kKeys;
  constexpr int NK = DqBf16<D>::kNK;
  constexpr int T = DqBf16<D>::kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + 16 * (threadIdx.x >> 5);
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int n = walk.count();

  uint16_t* q_s = smem;
  uint16_t* do_s = smem + kRows * D;
  uint16_t* ring = do_s + kRows * D;
  auto fetch = [&](int i) {
    uint16_t* ks = ring + (i % kStages) * 2 * T;
    const int k0 = walk.key0(i);
    copy_tile_bf16<D, KT>(ks, k + base, k0, L, rs);
    copy_tile_bf16<D, KT>(ks + T, v + base, k0, L, rs);
  };
  copy_tile_bf16<D, kRows>(q_s, q + base, q0, L, rs);
  copy_tile_bf16<D, kRows>(do_s, dout + base, q0, L, rs);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  const long long lbase = ((long long)b * H + h) * L;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lr[r] = row < L ? lse[lbase + row] : 0.f;
    dr[r] = row < L ? di[lbase + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, w0);
    if (mode < 0) continue;  // warp-uniform
    const uint16_t* k_s = ring + (i % kStages) * 2 * T;
    float s[NK][4], dp[NK][4];
    scores_bf16<D, NK>(q_s, w0 - q0, k_s, lane, s);
    scores_bf16<D, NK>(do_s, w0 - q0, k_s + T, lane, dp);
    const int k0 = walk.key0(i);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e];
        if constexpr (Walk::kFlash) x *= walk.scale;
        if (mode == 1 && !walk.keep(w0 + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1)))
          x = mask;
        float ds = expf(x - lr[r]) * (dp[j][e] - dr[r]);
        if constexpr (Walk::kFlash) ds *= walk.scale;
        s[j][e] = ds;
      }
    pv_bf16<D, NK, false>(s, k_s, lane, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < L) store_row_bf16<D>(dq + base + row * rs, acc, r, t, 1.f);
  }
}

}  // namespace dl4j_attn_tc
