// The bf16 tile primitives of the attention backward cores
// (attn_dkv_bf16.cuh, attn_dq_bf16.cuh), on mma.sync m16n8k16 bf16 with f32
// accumulators in the f32 cores' block of 8 warps (attn_fwd_tc.cuh):
// swizzled [rows][D] bf16 tiles through cp.async, s = a b^T of 16 rows,
// acc += p b with p from registers, and the store of an output row.
//
// Shared tiles hold [rows][D] bf16 without padding, 16-byte chunk c of row r
// at c ^ f(r) (at_bf16): the eight rows of every ldmatrix matrix fall in
// distinct 16-byte slots of a 128-byte line.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd_tc.cuh"  // kThreads and the tc_common.cuh primitives

namespace dl4j_attn_tc {

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

}  // namespace dl4j_attn_tc
