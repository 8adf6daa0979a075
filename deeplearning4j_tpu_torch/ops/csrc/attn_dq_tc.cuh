// The dQ core of the attention backward on the tensor cores, Hopper (sm_90a):
// dq for one block's 128 query rows, in 3xTF32, under the splash and flash
// dQ kernels (splash_attention_bwd.cu, flash_attention_bwd.cu).
//
// Layout as the forward core (attn_fwd_tc.cuh): q, k, v, dO, dq [B, L, H, D]
// f32, contiguous, 16-byte aligned (the wrappers check it), row stride H * D;
// lse and di [B, H, L] f32. Per kept (query, key) pair:
//
//   p  = exp(s - lse)        s = q k^T (splash: q pre-scaled; flash: times
//                            scale); masked pairs: p = 0
//   ds = p * (dO v^T - di)
//   dq = ds k                (splash: unscaled, autograd applies the scale;
//                            flash: times scale at the store)
//
// A CUDA block of 8 warps owns 128 query rows, warp w the 16 rows w0 = q0 +
// 16 w ... w0 + 15, with lse and di of its rows g and g + 8 in registers
// (read once, only for rows below L). q and dO sit in swizzled shared tiles;
// K and V come through the forward's 2-stage cp.async ring in tiles of KT
// keys. For each tile a warp computes s = q k^T and dp = dO v^T on the
// forward's q k^T path (tile_scores, head dims relabelled so each shared
// load is 16 bytes), p = exp(s - lse) and ds = p (dp - di) on the C
// fragments, then dq += ds k with ds as the A operand as it lies: the
// forward's p v (tile_pv), with k's rows read in the order the forward reads
// v's (key 2t as column t, key 2t + 1 as column t + 4 of each 8-key step).
// Each tile's ds k sums in fresh accumulators and joins dq in one rounded f32
// fma (the tensor cores truncate as they accumulate). A warp skips the math
// of a tile the walk marks as adding nothing to its rows; tiles with some
// masked pair evaluate the walk's keep() and give the rest the mask value.
// The flash walk's scale (on s, and on dq at the store) is compiled in only
// for it (if constexpr), so the splash kernel's code is unchanged by it.
// expf, not __expf. No atomics: each dq element is written once, after a
// loop in a fixed order, so a launch gives the same bits every time.
//
// The tile: 32 keys at D = 128, 64 at D <= 64. With 64-key tiles at D = 128,
// q (64 KiB) + dO (64 KiB) + a 2-stage ring of K+V tiles (128 KiB) is 256
// KiB, past the 227 KiB a block may use; 32-key tiles take the ring to 64
// KiB, 192 KiB in all, and halve the s and dp fragments (16 registers each,
// where the forward sits at 255 registers with 64-key tiles). 64-row blocks
// would read each head's K and V twice as often; a single stage would lose
// the overlap of copies and math. At D = 64: 32 + 32 + 64 = 128 KiB.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "attn_fwd_tc.cuh"

namespace dl4j_attn_tc {

template <int D>
struct Dq {
  static constexpr int kKeys = D == 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int kNK = kKeys / 8;             // n-tiles of s and dp
  static constexpr int kTile = kKeys * D;           // floats of a K or V tile
  static constexpr size_t kSmem =
      (2 * (size_t)kRows * D + (size_t)kStages * 2 * kTile) * sizeof(float);
};

// dq of the block's 128 query rows from q0 of head h, batch row b, over the
// tiles ``walk`` lists: count(), key0(i), mode(i, w0) (-1: the tile adds
// nothing to rows w0 ... w0 + 15; 0: none of their pairs is masked; 1: some
// are), keep(row, col), kFlash and, for flash, scale (on s and on dq), in
// tiles of Dq<D>::kKeys keys. Masked scores take ``mask`` (the library's mask
// value for splash, -inf for flash): p = 0 either way.
template <int D, class Walk>
__device__ __forceinline__ void attn_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int L, int H, int q0, int h, int b,
    const Walk& walk, float mask, float* smem) {
  constexpr int KT = Dq<D>::kKeys;
  constexpr int NK = Dq<D>::kNK;
  constexpr int T = Dq<D>::kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + 16 * (threadIdx.x >> 5);
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int n = walk.count();

  float* q_s = smem;
  float* do_s = smem + kRows * D;
  float* ring = do_s + kRows * D;
  auto fetch = [&](int i) {
    float* ks = ring + (i % kStages) * 2 * T;
    const int k0 = walk.key0(i);
    copy_tile<D, KT>(ks, k + base, k0, L, rs);
    copy_tile<D, KT>(ks + T, v + base, k0, L, rs);
  };
  copy_tile<D, kRows>(q_s, q + base, q0, L, rs);
  copy_tile<D, kRows>(do_s, dout + base, q0, L, rs);
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
  const float one[2] = {1.f, 1.f};

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, w0);
    if (mode < 0) continue;  // warp-uniform
    const float* k_s = ring + (i % kStages) * 2 * T;
    float s[NK][4], dp[NK][4];
    tile_scores<D, NK>(q_s, w0 - q0, k_s, g, t, s);
    tile_scores<D, NK>(do_s, w0 - q0, k_s + T, g, t, dp);
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
        s[j][e] = expf(x - lr[r]) * (dp[j][e] - dr[r]);  // ds
      }
    tile_pv<D, NK>(s, k_s, g, t, one, acc);
  }
  cp_async_wait<0>();

  float dq_mul = 1.f;
  if constexpr (Walk::kFlash) dq_mul = walk.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < L) store_row<D>(dq + base + row * rs, acc, r, t, dq_mul);
  }
}

}  // namespace dl4j_attn_tc
