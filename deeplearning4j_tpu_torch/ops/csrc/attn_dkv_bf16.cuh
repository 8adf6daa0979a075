// The bf16 dK/dV core of the attention backward, Hopper (sm_90a): dk and dv
// for one block's 128 keys from bf16 q, k, v, dO, under the splash and flash
// dK/dV kernels (splash_attention_bwd.cu, flash_attention_bwd.cu).
//
// Layout and arithmetic as the f32 core (attn_dkv_tc.cuh): q, k, v, dO, dk,
// dv [B, L, H, D] bf16, lse and di [B, H, L] f32. Per kept (query, key) pair
//
//   p  = exp(s - lse)        s = q k^T in f32 (splash: q pre-scaled; flash:
//                            times scale); masked pairs: p = 0
//   ds = p * (dO v^T - di)   dO v^T in f32; flash: ds times scale
//   dv = bf16(p)^T dO,  dk = bf16(ds)^T q    in f32, written in bf16
//
// which are the libraries' roundings: p and ds go to bf16 before the two
// products (flash `p.T.astype(do.dtype)` :900 and `ds.T.astype(do.dtype)`
// after its scale :918; splash :1788, :1804), dk and dv accumulate in f32.
// The block and its walk are the f32 core's: k and v of the block's 128
// keys stay in shared tiles, q, dO, lse and di stream through the 2-stage
// ring; the transposed products s^T = k q^T and dp^T = v dO^T come from
// scores_bf16 with k and v as the A operand, and p^T dO, ds^T q from
// pv_bf16 with p^T and ds^T as the A operands from registers and the B
// fragments of dO and q by ldmatrix.trans (attn_tile_bf16.cuh).
//
// The tile: 32 query rows at D = 128 (64 at D <= 64), the f32 core's rule
// for the registers: dk and dv hold 2 (D / 8) 4 = 128 f32 a thread at D =
// 128, and 32-row tiles keep s^T and dp^T at 16 each. Shared memory: k + v
// 64 KiB + a ring of 2 x (q + dO + lse + di) 32.5 KiB = 96.5 KiB at D = 128.
// No atomics: each output element is written once.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "attn_tile_bf16.cuh"

namespace dl4j_attn_tc {

template <int D>
struct DkvBf16 {
  static constexpr int kQT = D == 128 ? 32 : 64;  // query rows per q/dO tile
  static constexpr int kNQ = kQT / 8;             // n-tiles of s^T and dp^T
  static constexpr int kTile = kQT * D;           // bf16 of a q or dO tile
  // bytes of one stage: q and dO tiles, then lse and di (f32)
  static constexpr int kStage = 2 * kTile * 2 + 2 * kQT * 4;
  static constexpr size_t kSmem =
      2 * (size_t)kRows * D * sizeof(uint16_t) + (size_t)kStages * kStage;
};

// dk and dv of the block's 128 keys from k0 of head h, batch row b, over the
// query tiles ``walk`` lists: the f32 core's attn_dkv with bf16 tiles and
// products. For flash (Walk::kFlash) the scale is on s and on ds before its
// rounding, as the library applies it, so dk takes none at the store.
template <int D, class Walk>
__device__ __forceinline__ void attn_dkv_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int L, int H,
    int k0, int h, int b, const Walk& walk, float mask, uint16_t* smem) {
  constexpr int QT = DkvBf16<D>::kQT;
  constexpr int NQ = DkvBf16<D>::kNQ;
  constexpr int T = DkvBf16<D>::kTile;
  constexpr int S = DkvBf16<D>::kStage;
  static_assert(2 * QT <= kThreads, "one thread per lse or di value");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w = 16 * (threadIdx.x >> 5);  // the warp's first row of k_s
  const int kw0 = k0 + w;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
  const int n = walk.count();

  uint16_t* k_s = smem;
  uint16_t* v_s = k_s + kRows * D;
  char* ring = reinterpret_cast<char*>(v_s + kRows * D);
  auto fetch = [&](int i) {
    uint16_t* st = reinterpret_cast<uint16_t*>(ring + (i % kStages) * S);
    const int q0 = walk.q0(i);
    copy_tile_bf16<D, QT>(st, q + base, q0, L, rs);
    copy_tile_bf16<D, QT>(st + T, dout + base, q0, L, rs);
    float* ld = reinterpret_cast<float*>(st + 2 * T);
    const int x = threadIdx.x;
    if (x < 2 * QT) {  // lse into ld[0, QT), di into the next QT
      const int row = q0 + x % QT;
      const bool in = row < L;
      cp_async4(ld + x, (x < QT ? lse : di) + lbase + (in ? row : 0), in);
    }
  };
  copy_tile_bf16<D, kRows>(k_s, k + base, k0, L, rs);
  copy_tile_bf16<D, kRows>(v_s, v + base, k0, L, rs);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, kw0);
    if (mode < 0) continue;  // warp-uniform
    const uint16_t* q_t =
        reinterpret_cast<const uint16_t*>(ring + (i % kStages) * S);
    const uint16_t* do_t = q_t + T;
    const float* lse_t = reinterpret_cast<const float*>(q_t + 2 * T);
    const float* di_t = lse_t + QT;
    float s[NQ][4], dp[NQ][4];
    scores_bf16<D, NQ>(k_s, w, q_t, lane, s);
    scores_bf16<D, NQ>(v_s, w, do_t, lane, dp);
    const int q0 = walk.q0(i);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if constexpr (Walk::kFlash) x *= walk.scale;
        if (mode == 1 && !walk.keep(q0 + 8 * j + 2 * t + (e & 1),
                                    kw0 + g + 8 * (e >> 1)))
          x = mask;
        const float p = expf(x - ((e & 1) ? l2.y : l2.x));
        float ds = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
        if constexpr (Walk::kFlash) ds *= walk.scale;
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
    pv_bf16<D, NQ, false>(s, do_t, lane, adv);
    pv_bf16<D, NQ, false>(dp, q_t, lane, adk);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= L) continue;
    store_row_bf16<D>(dk + base + key * rs, adk, r, t, 1.f);
    store_row_bf16<D>(dv + base + key * rs, adv, r, t, 1.f);
  }
}

}  // namespace dl4j_attn_tc
