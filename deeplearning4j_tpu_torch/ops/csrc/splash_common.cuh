// What the splash-attention kernels (splash_attention_fwd.cu,
// splash_attention_bwd.cu) share beyond the flash tiles of flash_common.cuh:
// the block list a CUDA block walks, the walk of the tensor-core cores, the
// mask value, and p / ds of one tile for the SIMT dK/dV kernel.
//
// Block lists (ops/splash_mask.py `BlockList`): counts [R, n], blocks and
// kinds [R, n, W] int32, R = 1 when every head shares the mask (else one row
// per head). Row (r, i) lists, in the library's order, the non-empty blocks of
// the other axis for block i of the launch axis: kv blocks for a q block (the
// forward and dQ tables), q blocks for a kv block (the dK/dV table). Kind 2
// is a full block, whose scores take no mask code; kind 1 a partial block,
// which evaluates the causal mask function q >= k on absolute positions and
// fills the rest with the library's DEFAULT_MASK_VALUE.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace dl4j_splash {

using namespace dl4j_flash;

constexpr int kBlock = 128;  // the table's block (BlockSizes.get_default())
constexpr int kHalves = kBlock / kTile;  // 64-row compute tiles per block
// -0.7 * float32 max, rounded once to float as the library's jnp.where does
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

struct BlockRow {
  const int* blocks;
  const int* kinds;
  int count;
};

__device__ __forceinline__ BlockRow block_row(const int* __restrict__ counts,
                                              const int* __restrict__ blocks,
                                              const int* __restrict__ kinds,
                                              int R, int W, int n, int h, int i) {
  const long long at = (long long)(R == 1 ? 0 : h) * n + i;
  return {blocks + at * W, kinds + at * W, counts[at]};
}

// The walk of one row of a forward or dQ block list in tiles of KT keys
// (kBlock / KT tiles per listed kv block), in the library's order, for the
// tensor-core cores (attn_fwd_tc.cuh, attn_dq_tc.cuh): masked scores take the
// mask value (q is pre-scaled, so no scale), which takes part in the
// forward's max and sum as in the library. mode(i, w0): -1 when the tile
// adds nothing to rows w0 .. w0 + 15 (a kind-1 tile whose every key follows
// every one of those rows), 0 when none of their scores is masked, 1 when
// some are.
template <int KT>
struct SplashWalk {
  static_assert(kBlock % KT == 0, "tiles split a block evenly");
  static constexpr bool kFlash = false;
  static constexpr unsigned kPer = kBlock / KT;
  const int* blocks;
  const int* kinds;
  int n;
  __device__ int count() const { return (int)kPer * n; }
  __device__ int key0(int i) const {
    return __ldg(blocks + (unsigned)i / kPer) * kBlock +
           (int)((unsigned)i % kPer) * KT;
  }
  __device__ int mode(int i, int w0) const {
    if (__ldg(kinds + (unsigned)i / kPer) != 1) return 0;
    const int k0 = key0(i);
    if (k0 > w0 + 15) return -1;
    return k0 + KT - 1 > w0 ? 1 : 0;
  }
  __device__ bool keep(int row, int col) const { return row >= col; }
};

// Whether a 64 x 64 tile of a kind-1 block lies wholly above the diagonal
// (every key after every query): its scores are all the mask value, and it
// adds nothing where the row has any live key, which every causal row has.
__device__ __forceinline__ bool tile_masked(int kind, int q0, int k0) {
  return kind == 1 && k0 > q0 + kTile - 1;
}

// p = exp(s - lse) and ds = p (dO v^T - di) of one 64 x 64 tile at the
// thread's rows ty + 16 i (queries from q0) and columns tx + 16 j (keys from
// k0), into p_s and ds_s. q is pre-scaled, so s = q k^T.
template <int D>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* k_s, const float* v_s, const float* do_s,
    const float* lse_s, const float* di_s, float* p_s, float* ds_s, int q0,
    int k0, bool partial, int ty, int tx) {
  float s[kSub][kSub], dp[kSub][kSub];
  tile_dot<D>(q_s, k_s, ty, tx, s);
  tile_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    const float lr = lse_s[r];
    const float dr = di_s[r];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = tx + 16 * j;
      const float x = !partial || q0 + r >= k0 + c ? s[i][j] : kMaskValue;
      const float p = expf(x - lr);
      p_s[r * kSStride + c] = p;
      ds_s[r * kSStride + c] = p * (dp[i][j] - dr);
    }
  }
}

inline bool bad_dims(int B, int L, int H, int R, int W) {
  return B < 1 || L < kBlock || L % kBlock || H < 1 || B > 65535 ||
         H > 65535 || (R != 1 && R != H) || W < 1;
}

}  // namespace dl4j_splash
