// What the splash-attention kernels (splash_attention_fwd.cu,
// splash_attention_bwd.cu) share: the block list a CUDA block walks, the
// walks of the tensor-core cores over it, and the mask value.
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

#include "flash_common.cuh"  // dl4j_cuda_error_string

namespace dl4j_splash {

constexpr int kBlock = 128;  // the table's block (BlockSizes.get_default())
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
// tensor-core cores (attn_fwd_tc.cuh, attn_dq_tc.cuh; R = 16 rows a warp)
// and the bf16 forward core (attn_fwd_bf16.cuh; R = 64 rows a warpgroup):
// masked scores take the mask value (q is pre-scaled, so no scale), which
// takes part in the forward's max and sum as in the library. mode(i, w0):
// -1 when the tile adds nothing to rows w0 .. w0 + R - 1 (a kind-1 tile
// whose every key follows every one of those rows), 0 when none of their
// scores is masked, 1 when some are.
template <int KT, int R = 16>
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
    if (k0 > w0 + R - 1) return -1;
    return k0 + KT - 1 > w0 ? 1 : 0;
  }
  __device__ bool keep(int row, int col) const { return row >= col; }
};

// The walk of one row of the dK/dV block list for the dK/dV core
// (attn_dkv_tc.cuh): SplashWalk's tiles, here of QT query rows (kBlock / QT
// per listed q block), with the axes of mode() swapped. mode(i, kw0): -1
// when the tile adds nothing to keys kw0 .. kw0 + 15 (a kind-1 tile whose
// every query precedes all of those keys: their scores are all the mask
// value, p = 0), 0 when none of their pairs is masked, 1 when some are.
template <int QT>
struct SplashDkvWalk : SplashWalk<QT> {
  __device__ int q0(int i) const { return this->key0(i); }
  __device__ int mode(int i, int kw0) const {
    if (__ldg(this->kinds + (unsigned)i / this->kPer) != 1) return 0;
    const int first = q0(i);
    if (first + QT - 1 < kw0) return -1;
    return first < kw0 + 15 ? 1 : 0;
  }
};

// The walk of one row of the dK/dV block list for the Hopper bf16 dK/dV
// core (attn_dkv_bf16.cuh): SplashDkvWalk's tiles of QT query rows, with
// mode() judged for the KR keys kw0 .. kw0 + KR - 1 of a consumer
// warpgroup: -1 when every query of the tile precedes all of them, 0 when
// none of their pairs is masked, 1 when some are.
template <int QT, int KR>
struct SplashDkvWgWalk : SplashDkvWalk<QT> {
  __device__ int mode(int i, int kw0) const {
    if (__ldg(this->kinds + (unsigned)i / this->kPer) != 1) return 0;
    const int first = this->q0(i);
    if (first + QT - 1 < kw0) return -1;
    return first < kw0 + KR - 1 ? 1 : 0;
  }
};

inline bool bad_dims(int B, int L, int H, int R, int W) {
  return B < 1 || L < kBlock || L % kBlock || H < 1 || B > 65535 ||
         H > 65535 || (R != 1 && R != H) || W < 1;
}

}  // namespace dl4j_splash
