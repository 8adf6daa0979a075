// The bf16 forward core of the flash and splash attention kernels
// (flash_attention_fwd.cu, splash_attention_fwd.cu), Hopper (sm_90a): q, k,
// v and o in bf16, both products on the tensor cores as bf16 mma.sync
// m16n8k16 with f32 accumulators, the online softmax in f32. Also the tile
// primitives the bf16 dK/dV and dQ cores (attn_dkv_bf16.cuh,
// attn_dq_bf16.cuh) share.
//
// Layout: q, k, v, o are [B, L, H, D] bf16, contiguous, 16-byte aligned (the
// wrappers check it), row stride H * D; lse is [B, H, L] f32.
//
// The block and its walk are the f32 core's (attn_fwd_tc.cuh): 8 warps own
// 128 query rows, 16 a warp; K/V come through a 2-stage cp.async ring of
// 64-key tiles; the walks (FlashWalk, SplashWalk) and their masks are the
// same objects. What bf16 changes is the products:
//   - s = q k^T: per 16-deep k-step one ldmatrix.x4 of q (the A fragment)
//     and one per two 8-key n-tiles of k (B fragments of a tile stored
//     [key][dim]); bf16 mma into f32 C fragments. bf16 products are exact
//     in f32, so s is the libraries' f32 dot of bf16 operands up to the
//     order of the f32 sums;
//   - p v: the C fragments of two n-tiles, packed to bf16 pairs, are the A
//     fragment of one 16-key k-step as they lie (tc_common.cuh); v's B
//     fragments come by ldmatrix.x4.trans of the tile stored [key][dim].
// The precision of p v is the walk's trait, the two libraries' rules:
//   - flash (Walk::kFlash) rounds p to bf16 before p v, as the library's
//     `p.astype(v.dtype)` (flash_attention.py :471): one product;
//   - splash keeps p in f32 and casts v up (splash_attention_kernel.py
//     :819). v is exact in bf16, so p v = p_hi v + p_lo v with p_hi =
//     bf16(p) and p_lo = bf16(p - p_hi): two bf16 products, exact to about
//     2^-17 of p, far under the bf16 output's own rounding (2^-9).
// o is divided by the row sum in f32 and written in bf16; lse = m + log(l)
// in f32.
//
// Shared tiles hold [rows][D] bf16 without padding, 16-byte chunk c of row r
// at c ^ f(r) (at_bf16): the eight rows of every ldmatrix matrix fall in
// distinct 16-byte slots of a 128-byte line. Shared memory: q 32 KiB + a
// ring of 2 x (K + V) 64 KiB = 96 KiB at D = 128 (48 KiB at D = 64).
//
// What bounds it on this card: operations, 4 D per kept (query, key) pair at
// 989 TFLOP/s (bf16 dense): 1.11 ms at [1, 32768, 4, 128] causal. The splash
// kernel issues 6 D a pair (its p v is two products). Why mma.sync and not wgmma
// in this first bf16 kernel: it reuses the f32 cores' block, ring, walks and
// fragment bookkeeping, and its A operand p comes from registers either way;
// wgmma and TMA are later work.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd_tc.cuh"  // kRows, kKeys, kThreads, kStages, FlashWalk, launch

namespace dl4j_attn_tc {

template <int D>
struct FwdBf16 {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head dim");
  static constexpr int kTile = kKeys * D;   // bf16 of one K or V tile
  static constexpr int kQTile = kRows * D;  // bf16 of the q tile
  static constexpr size_t kSmem =
      ((size_t)kQTile + (size_t)kStages * 2 * kTile) * sizeof(uint16_t);
};

// Rows [row0, row0 + N) of one (b, h) slice (src points at its row 0) into
// a swizzled [N][D] bf16 tile; rows past L are zeros.
template <int D, int N>
__device__ __forceinline__ void copy_tile_bf16(uint16_t* tile,
                                               const uint16_t* __restrict__ src,
                                               int row0, int L, long long rs) {
  constexpr int C = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < N * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    const int row = row0 + r;
    const bool in = row < L;
    cp_async16_bf16(tile + at_bf16<D>(r, c),
                    src + (long long)(in ? row : 0) * rs + 8 * c, in);
  }
}

// s = a b^T in f32 of 16 rows of ``a_s`` from row ``ar`` and the first 8 NJ
// rows of ``b_s``, both swizzled [rows][D] bf16 tiles: s[j][e] at row ar + g
// + 8 (e / 2), b row 8 j + 2 t + (e % 2).
template <int D, int NJ>
__device__ __forceinline__ void scores_bf16(const uint16_t* a_s, int ar,
                                            const uint16_t* b_s, int lane,
                                            float (&s)[NJ][4]) {
  static_assert(NJ % 2 == 0, "n-tiles come in pairs");
  const int lr = lane & 7;
  const int l8 = (lane >> 3) & 1;
  const int l16 = lane >> 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];  // rows +0 / +8 (l8), dims lo / hi (l16)
    ldsm_x4(a, a_s + at_bf16<D>(ar + lr + 8 * l8, 2 * kk + l16));
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];  // b rows +0 / +8 (l16), dims lo / hi (l8)
      ldsm_x4(b, b_s + at_bf16<D>(16 * jj + lr + 8 * l16, 2 * kk + l8));
      mma_bf16(s[2 * jj], a, b[0], b[1]);
      mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc += p b of the warp's 16 rows: p in f32 C fragments over 8 NK columns
// (p[j][e] at row g + 8 (e / 2), column 8 j + 2 t + (e % 2)), b the first 8
// NK rows of a swizzled [rows][D] bf16 tile; acc[n][e] at row g + 8 (e / 2),
// dim 8 n + 2 t + (e % 2). p is rounded to bf16 (kSplit false), or taken as
// bf16(p) + bf16(p - bf16(p)) in two products (kSplit true).
template <int D, int NK, bool kSplit>
__device__ __forceinline__ void pv_bf16(const float (&p)[NK][4],
                                        const uint16_t* b_s, int lane,
                                        float (&acc)[D / 8][4]) {
  static_assert(NK % 2 == 0, "16-deep k-steps");
  const int lr = lane & 7;
  const int l8 = (lane >> 3) & 1;
  const int l16 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const float(&p0)[4] = p[2 * kk];
    const float(&p1)[4] = p[2 * kk + 1];
    uint32_t a[4], lo[4];
    a[0] = pack_bf16(p0[0], p0[1]);
    a[1] = pack_bf16(p0[2], p0[3]);
    a[2] = pack_bf16(p1[0], p1[1]);
    a[3] = pack_bf16(p1[2], p1[3]);
    if constexpr (kSplit) {
      lo[0] = pack_bf16(p0[0] - bf16_lo(a[0]), p0[1] - bf16_hi(a[0]));
      lo[1] = pack_bf16(p0[2] - bf16_lo(a[1]), p0[3] - bf16_hi(a[1]));
      lo[2] = pack_bf16(p1[0] - bf16_lo(a[2]), p1[1] - bf16_hi(a[2]));
      lo[3] = pack_bf16(p1[2] - bf16_lo(a[3]), p1[3] - bf16_hi(a[3]));
    }
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];  // b rows +0 / +8 (l8), dims of n-tile 2 nn / + 1 (l16)
      ldsm_x4_trans(b, b_s + at_bf16<D>(16 * kk + lr + 8 * l8, 2 * nn + l16));
      if constexpr (kSplit) {
        mma_bf16(acc[2 * nn], lo, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], lo, b[2], b[3]);
      }
      mma_bf16(acc[2 * nn], a, b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// Row g + 8 r of the warp's output fragments, times mul, rounded to bf16,
// into out[0 .. D): two dims (one 4-byte store) per n-tile.
template <int D>
__device__ __forceinline__ void store_row_bf16(uint16_t* out,
                                               const float (&acc)[D / 8][4],
                                               int r, int t, float mul) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
        pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
}

// The bf16 forward of the block's 128 query rows from q0 of head h, batch
// row b, over the tiles ``walk`` lists: the f32 core's attn_fwd (its walk,
// mask and softmax) with bf16 tiles and products. Walk::kFlash picks the
// flash rules (scale on s, m guarded, p rounded for p v), else splash's.
template <int D, class Walk>
__device__ __forceinline__ void attn_fwd_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
    float* __restrict__ lse, int L, int H, int q0, int h, int b,
    const Walk& walk, float mask, uint16_t* smem) {
  constexpr int T = FwdBf16<D>::kTile;
  constexpr int NT = D / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + 16 * (threadIdx.x >> 5);
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int n = walk.count();

  uint16_t* q_s = smem;
  auto fetch = [&](int i) {
    uint16_t* ks = smem + FwdBf16<D>::kQTile + (i % kStages) * 2 * T;
    const int k0 = walk.key0(i);
    copy_tile_bf16<D, kKeys>(ks, k + base, k0, L, rs);
    copy_tile_bf16<D, kKeys>(ks + T, v + base, k0, L, rs);
  };
  copy_tile_bf16<D, kRows>(q_s, q + base, q0, L, rs);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {mask, mask}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, w0);
    if (mode < 0) continue;  // warp-uniform
    const uint16_t* k_s = smem + FwdBf16<D>::kQTile + (i % kStages) * 2 * T;
    float s[8][4];
    scores_bf16<D, 8>(q_s, w0 - q0, k_s, lane, s);
    const int k0 = walk.key0(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Walk::kFlash) s[j][e] *= walk.scale;
        if (mode == 1 && !walk.keep(w0 + g + 8 * (e >> 1),
                                    k0 + 8 * j + 2 * t + (e & 1)))
          s[j][e] = mask;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[0][2 * r], s[0][2 * r + 1]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use =
          (Walk::kFlash && m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_use);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    pv_bf16<D, 8, !Walk::kFlash>(s, k_s + T, lane, acc);
  }
  cp_async_wait<0>();

  const long long lbase = ((long long)b * H + h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = w0 + g + 8 * r;
    if (row >= L) continue;
    store_row_bf16<D>(o + base + row * rs, acc, r, t, 1.f / lr);
    if (t == 0) lse[lbase + row] = m[r] + logf(lr);
  }
}

}  // namespace dl4j_attn_tc
