// Tensor-core primitives of the port's Hopper (sm_90a) kernels: the 3xTF32
// split, the mma.sync m16n8k8 tf32 product, asynchronous copies into shared
// memory, and the chunk swizzle of shared tiles. Used by the attention cores
// (attn_fwd_tc.cuh, attn_dq_tc.cuh) and the conv kernel (conv2d_bias_act.cu).
//
// mma.sync.m16n8k8 tf32, lane (g, t) = (lane / 4, lane % 4):
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//     a3 = A[g + 8][t + 4];
//   B (8 x 8, k by n):     b0 = B[t][g], b1 = B[t + 4][g];
//   C (16 x 8):            c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
//     c3 = C[g + 8][2t + 1].
// Within one k-step the eight k indices may stand in any order, as long as A's
// column c and B's row c name the same one; the kernels use that freedom so
// that every shared load is 16 bytes (see each caller).
//
// 3xTF32: x = hi + lo with hi = rna(x) and lo = rna(x - hi), rna the rounding
// of cvt.rna.tf32.f32 (to nearest, ties away) computed as (bits + 0x1000) &
// ~0x1fff; a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, in that order, into the f32
// accumulator (lo_a lo_b, about 2^-22 relative, is dropped). The tensor cores
// truncate as they accumulate, so the callers keep accumulator chains short
// (fresh accumulators per tile or per K slice, joined in one rounded f32 add).
// Plain TF32 keeps 11 significant bits, far from the f32-class gates the
// kernels are held to (tests/test_torch_attention_tc.py,
// tests/test_torch_conv_tc.py).
//
// Why mma.sync and not wgmma: wgmma takes tf32 operands only K-major from
// shared memory, and the split would need lo tiles beside the hi ones in
// shared memory; mma.sync takes its operands from registers, where the split
// is made.
//
// bf16 (the attention kernels' bf16 cores, attn_*_bf16.cuh): mma.sync
// m16n8k16 bf16 with an f32 accumulator, lane (g, t):
//   A (16 x 16, row-major), four registers of two bf16 each, the lower
//     column in the lower half: a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t,
//     2t + 1], a2 = A[g][2t + 8, 2t + 9], a3 = A[g + 8][2t + 8, 2t + 9];
//   B (16 x 8, k by n):  b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g];
//   C (16 x 8):          as the tf32 product's.
// So the C fragments of two 8-column n-tiles are, packed in pairs, the A
// fragment of one 16-deep k-step: a product's result feeds the next product
// from registers. ldmatrix (.x4: four 8 x 8 matrices of 16-bit values, lanes
// 8i ... 8i + 7 giving the row addresses of matrix i) loads A fragments and
// B fragments of a tile stored [n][k] from shared memory; .trans loads B
// fragments of a tile stored [k][n]. Shared bf16 tiles use the chunk
// swizzle of at_bf16 so that the eight row addresses of one matrix fall in
// eight distinct 16-byte slots of a 128-byte line.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j_tc {

// x rounded to tf32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer operations (ptxas
// expands the cvt into four, with a NaN test these inputs never need)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a = ah + al and b = (bh0 + bl0, bh1 + bl1) split already
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// d += a b in 3xTF32, a split already, b = (b0, b1) split here
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma3(d, ah, al, h0, h1, l0, l1);
}

// 16 bytes from global to shared, L1 bypassed; zeros when !in (src-size 0:
// nothing is read, src need only be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// one float from global to shared; zero when !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float offset of 16-byte chunk ``chunk`` of row ``row`` in a swizzled
// tile of W floats a row: chunk c sits at c ^ f(row), f(r) = (r & 6) ^ ((r &
// 1) << 2) for W >= 32 (eight chunks or more), (r / 2) & 3 at W = 16. Two
// rows r, r + 1 (r even) then put a float4 read of four chunks each on eight
// distinct chunk slots of a 128-byte line, and so do four rows reading two
// chunks each: no bank conflicts, and no padding.
template <int W>
__device__ __forceinline__ int at(int row, int chunk) {
  const int f = W >= 32 ? ((row & 6) ^ ((row & 1) << 2)) : ((row >> 1) & 3);
  return row * W + 4 * (chunk ^ f);
}

// -- bf16 ---------------------------------------------------------------------

// {lo, hi} rounded to bf16 (to nearest, ties to even) and packed: lo in the
// lower half, the order of an mma fragment's two columns
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two bf16 of a packed pair, back as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 matrices of 16-bit values from shared memory; this lane gives
// the address of row lane % 8 of matrix lane / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes (8 bf16) from global to shared, L1 bypassed; zeros when !in
__device__ __forceinline__ void cp_async16_bf16(uint16_t* dst,
                                                const uint16_t* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// The element offset of 16-byte chunk ``chunk`` (8 bf16) of row ``row`` in a
// swizzled bf16 tile of W values a row: chunk c sits at c ^ f(row), f(r) = r
// & 7 for W >= 64 (eight chunks or more), (r / 2) & 3 at W = 32, (r / 4) & 1
// at W = 16. Eight consecutive rows at one chunk, what ldmatrix reads for one
// matrix, then touch eight distinct 16-byte slots of a 128-byte line: no bank
// conflicts, and no padding.
template <int W>
__device__ __forceinline__ int at_bf16(int row, int chunk) {
  const int f = W >= 64 ? (row & 7) : W == 32 ? ((row >> 1) & 3)
                                              : ((row >> 2) & 1);
  return row * W + 8 * (chunk ^ f);
}

// Registers, local (spill) bytes per thread and dynamic shared bytes of a
// kernel as the loaded binary has them, into out[3]; returns a cudaError_t.
template <typename Kernel>
int attrs(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

}  // namespace dl4j_tc
