// The dK/dV core of the attention backward on the tensor cores, Hopper
// (sm_90a): dk and dv for one block's 128 keys, in 3xTF32, under the splash
// and flash dK/dV kernels (splash_attention_bwd.cu, flash_attention_bwd.cu).
//
// Layout as the forward core (attn_fwd_tc.cuh): q, k, v, dO, dk, dv [B, L, H,
// D] f32, contiguous, 16-byte aligned (the wrappers check it), row stride H *
// D; lse and di [B, H, L] f32. Per kept (query, key) pair:
//
//   p  = exp(s - lse)        s = q k^T (splash: q pre-scaled; flash: times
//                            scale); masked pairs: p = 0
//   ds = p * (dO v^T - di)
//   dv = p^T dO,  dk = ds^T q  (flash: times scale at the store)
//
// A CUDA block of 8 warps owns 128 keys k0 ... k0 + 127, warp w the 16 keys
// kw0 = k0 + 16 w ... kw0 + 15. The core computes the transposed products
// directly, so nothing is transposed: k and v of the block's keys stay
// resident in swizzled shared tiles and take the role the q tile has in the
// forward; q and dO of the walked query rows stream through the forward's
// 2-stage cp.async ring in tiles of QT rows and take the role of K and V.
// Per tile a warp computes, on the forward's primitives:
//   - s^T = k q^T and dp^T = v dO^T (tile_scores, k and v as the A operand):
//     the C fragments hold key g + 8 (e / 2) and query 8 j + 2 t + (e & 1);
//   - p^T = exp(s^T - lse[query]) and ds^T = p^T (dp^T - di[query]) on the
//     fragments, lse and di read per query column from the stage's slot;
//   - dv += p^T dO and dk += ds^T q (tile_pv): p^T and ds^T are the A
//     operands as they lie, exactly as p is in the forward's p v, with dO
//     and q in v's place.
// Each tile's products sum in fresh accumulators and join dk and dv in one
// rounded f32 add (the tensor cores truncate as they accumulate). A warp
// skips the math of a tile the walk marks as adding nothing to its keys;
// tiles with some masked pair evaluate the walk's keep(). expf, not __expf.
// No atomics: each dk and dv element is written once, after the walk, in a
// fixed order, so a launch gives the same bits every time.
//
// Each stage of the ring carries a tile's q and dO rows (16-byte cp.async)
// and its QT values of lse and di (4-byte cp.async: 16-byte copies would
// misalign at flash's odd L); rows past L are zero-filled and never read
// from global memory.
//
// The tile and the registers: dk and dv take 2 (D / 8) 4 = 128 accumulator
// floats a thread at D = 128. Resident k + v is 128 KiB there, and a 2-stage
// ring of 64-row q + dO tiles would be 128 KiB more, past the 227 KiB a block
// may use; 32-row tiles take the ring to 64 KiB (192.5 KiB in all) and keep
// s^T and dp^T at 16 registers each. QT = 64 at D <= 64 (at D = 64, 64 KiB +
// 65 KiB). This is the dQ core's rule (attn_dq_tc.cuh) with the axes swapped.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "attn_fwd_tc.cuh"

namespace dl4j_attn_tc {

template <int D>
struct Dkv {
  static constexpr int kQT = D == 128 ? 32 : 64;  // query rows per q/dO tile
  static constexpr int kNQ = kQT / 8;             // n-tiles of s^T and dp^T
  static constexpr int kTile = kQT * D;           // floats of a q or dO tile
  static constexpr int kStage = 2 * kTile + 2 * kQT;  // q, dO, lse, di
  static constexpr size_t kSmem =
      (2 * (size_t)kRows * D + (size_t)kStages * kStage) * sizeof(float);
};

// dk and dv of the block's 128 keys from k0 of head h, batch row b, over the
// query tiles ``walk`` lists: count(), q0(i), mode(i, kw0) (-1: the tile adds
// nothing to keys kw0 ... kw0 + 15; 0: none of their pairs is masked; 1: some
// are), keep(qrow, key), kFlash and, for flash, scale (on s and on dk). Masked
// scores take ``mask`` (the library's mask value for splash, -inf for flash):
// p = 0 either way.
template <int D, class Walk>
__device__ __forceinline__ void attn_dkv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int L, int H, int k0,
    int h, int b, const Walk& walk, float mask, float* smem) {
  constexpr int QT = Dkv<D>::kQT;
  constexpr int NQ = Dkv<D>::kNQ;
  constexpr int T = Dkv<D>::kTile;
  constexpr int S = Dkv<D>::kStage;
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

  float* k_s = smem;
  float* v_s = k_s + kRows * D;
  float* ring = v_s + kRows * D;
  auto fetch = [&](int i) {
    float* st = ring + (i % kStages) * S;
    const int q0 = walk.q0(i);
    copy_tile<D, QT>(st, q + base, q0, L, rs);
    copy_tile<D, QT>(st + T, dout + base, q0, L, rs);
    const int x = threadIdx.x;
    if (x < 2 * QT) {  // lse into st[2T, 2T + QT), di into the next QT
      const int row = q0 + x % QT;
      const bool in = row < L;
      cp_async4(st + 2 * T + x, (x < QT ? lse : di) + lbase + (in ? row : 0),
                in);
    }
  };
  copy_tile<D, kRows>(k_s, k + base, k0, L, rs);
  copy_tile<D, kRows>(v_s, v + base, k0, L, rs);
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
  const float one[2] = {1.f, 1.f};

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, kw0);
    if (mode < 0) continue;  // warp-uniform
    const float* q_t = ring + (i % kStages) * S;
    const float* do_t = q_t + T;
    const float* lse_t = q_t + 2 * T;
    const float* di_t = lse_t + QT;
    float s[NQ][4], dp[NQ][4];
    tile_scores<D, NQ>(k_s, w, q_t, g, t, s);
    tile_scores<D, NQ>(v_s, w, do_t, g, t, dp);
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
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));  // ds
      }
    }
    tile_pv<D, NQ>(s, do_t, g, t, one, adv);
    tile_pv<D, NQ>(dp, q_t, g, t, one, adk);
  }
  cp_async_wait<0>();

  float dk_mul = 1.f;
  if constexpr (Walk::kFlash) dk_mul = walk.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= L) continue;
    store_row<D>(dk + base + key * rs, adk, r, t, dk_mul);
    store_row<D>(dv + base + key * rs, adv, r, t, 1.f);
  }
}

}  // namespace dl4j_attn_tc
