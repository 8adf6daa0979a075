// Tiles shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu), Hopper (sm_90a), f32 SIMT.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, D] f32, contiguous, indexed
// directly (row stride H * D, no transposes); lse and di are [B, H, L] f32.
//
// A block has 256 threads, seen as 16 x 16 (ty, tx). A 64 x 64 score tile
// S[r][c] (r a query row, c a key row of the tile) is split so that thread
// (ty, tx) owns rows r = ty + 16 i and columns c = tx + 16 j, i, j < 4; a
// 64 x D accumulator so that it owns rows ty + 16 i and head dims tx + 16 jj,
// jj < D / 16. The 16 threads of one row sit in one half of a warp, so a row's
// max and sum reduce with four shuffles.
//
// Shared tiles of q, k, v and dO keep rows at a stride of D + 1 floats: the 16
// threads reading k_s[c][d] for c = tx + 16 j then hit 16 different banks.
// Score tiles keep rows at a stride of 80 floats, so the two rows one warp
// writes land in disjoint halves of the banks.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace dl4j_flash {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kSub = 4;         // rows (and columns) of a score tile per thread
constexpr int kSStride = kTile + 16;  // floats per row of a score tile in smem

template <int D>
struct Dims {
  static constexpr int kStride = D + 1;     // floats per row of a q/k/v/dO tile
  static constexpr int kOut = D / 16;       // head dims per thread in an accumulator
  static constexpr int kTileFloats = kTile * kStride;
};

// Rows [row0, row0 + 64) of one (b, h) slice into tile[64][D + 1]; rows past L
// are zeros, so nothing is read out of bounds.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const float* __restrict__ src,
                                          long long base, int row0, int L,
                                          long long row_stride) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = row0 + r;
    tile[r * Dims<D>::kStride + d] =
        row < L ? src[base + (long long)row * row_stride + d] : 0.f;
  }
}

// 64 values of a [B, H, L] row vector (lse or di) into smem; past L zeros.
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         long long base, int row0, int L) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < L ? src[base + row0 + i] : 0.f;
}

// s[i][j] = sum_d a[r_i][d] * b[c_j][d] over the thread's rows r_i = ty + 16 i
// of tile a and rows c_j = tx + 16 j of tile b.
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx, float (&s)[kSub][kSub]) {
  constexpr int P = Dims<D>::kStride;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Whether score (row, col) takes part: inside L, and at or below the diagonal
// when causal.
template <bool kCausal>
__device__ __forceinline__ bool live(int row, int col, int L) {
  return row < L && col < L && (!kCausal || col <= row);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt in to more than 48 KiB of dynamic shared memory where needed, then
// launch; returns the launch's cudaError_t as int.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dl4j_flash

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
