// Splash-attention forward for Hopper (sm_90a), f32 in and out, driven by the
// block table, both products on the tensor cores in 3xTF32.
//
// Replaces the forward Pallas TPU kernel behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_splash_call` (:609): the
// library's `_splash_attention_forward` (jax/experimental/pallas/ops/tpu/
// splash_attention/splash_attention_kernel.py :895, pallas_call at :1137,
// body `flash_attention_kernel` :696, JAX 0.9.0). From q (pre-scaled by the
// caller, as `_splash_call` folds the scale into q), k, v [B, L, H, D] f32:
//
//   o   [B, L, H, D] = softmax(q k^T, masked) v
//   lse [B, H, L]    = m + log(l), the row max m and softmax sum l
//
// Design (attn_fwd_tc.cuh): one block of 8 warps per row of the forward block
// table, that is per (head, q block of 128 rows, batch row), most table
// entries first across all heads (grid (H, q blocks, B); the table lists i +
// 1 kv blocks for causal q block i). The
// block reads its row of the block list (splash_common.cuh) and walks only
// the kv blocks it names, in the library's order, as two 64-key tiles each;
// every K/V tile is loaded once, through a 2-stage cp.async ring, for all
// 128 rows. Each warp owns 16 rows and runs the library kernel's online
// softmax on them: m starts at the mask value, l at 0; s = q k^T and o += p v
// on mma.sync m16n8k8 tf32 in 3xTF32, p in registers. Full (kind-2) blocks
// run no mask code; partial (kind-1) blocks evaluate q >= k and fill the rest
// with the mask value, and a warp skips the math of a tile whose every key
// follows every one of its rows (it would add exp(mask - m) = 0). L % 128 ==
// 0, so no tile is ragged. expf and logf, not __expf.
//
// What bounds it on this card: operations, 4 D per kept (query, key) pair,
// far above its bytes at L >= 1024. Against f32 outside the tensor cores (67
// TFLOP/s) that is 16.41 ms at [1, 32768, 4, 128] causal; the 3xTF32 split
// runs three tf32 products per product (495 TFLOP/s), a least time of
// 6.66 ms there. Why mma.sync and not wgmma, and the error of plain TF32:
// attn_fwd_tc.cuh.
//
// bf16 (dl4j_splash_fwd_bf16): its own kernel over attn_fwd_bf16.cuh, designed
// for Hopper: the producer warpgroup reads the block's row of the table and
// fetches by TMA only the kv blocks it lists, one 128-key tile each, through
// an mbarrier ring; two consumer warpgroups of 64 query rows run wgmma in
// turns. p stays f32 for p v, as the library keeps it
// (splash_attention_kernel.py :819), taken as bf16(p) + bf16(p - bf16(p)) in
// two bf16 products. Bound: 4 D operations per kept pair at 989 TFLOP/s,
// 1.112 ms at [1, 32768, 4, 128] causal (the two products of p v cap the
// share near 0.67); on an H100 the mma.sync kernel it replaces took 6.42 ms
// there (0.173 of it), SDPA's bf16 forward 1.73 ms. What the design does about it:
// attn_fwd_bf16.cuh.
#include <cuda_runtime.h>
#include <math.h>

#include "attn_fwd_bf16.cuh"
#include "attn_fwd_tc.cuh"
#include "splash_common.cuh"

namespace {

using namespace dl4j_attn_tc;
using dl4j_splash::BlockRow;
using dl4j_splash::kBlock;
using dl4j_splash::kMaskValue;
using SplashWalk = dl4j_splash::SplashWalk<kKeys>;

static_assert(kBlock == kRows, "one CUDA block per q block of the table");

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ counts,
                      const int* __restrict__ blocks, const int* __restrict__ kinds,
                      int L, int H, int R, int W) {
  extern __shared__ __align__(16) float smem[];
  const int nq = L / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;
  const BlockRow row = dl4j_splash::block_row(counts, blocks, kinds, R, W, nq,
                                              blockIdx.x, qb);
  const SplashWalk walk{row.blocks, row.kinds, row.count};
  attn_fwd<D>(q, k, v, o, lse, L, H, qb * kBlock, blockIdx.x, blockIdx.z, walk,
              kMaskValue, smem);
}

template <int D>
int run(const float* q, const float* k, const float* v, float* o, float* lse,
        const int* counts, const int* blocks, const int* kinds, int B, int L,
        int H, int R, int W, cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return launch(splash_fwd_kernel<D>, grid, Fwd<D>::kSmem, stream, q, k, v, o,
                lse, counts, blocks, kinds, L, H, R, W);
}

namespace ws = dl4j_attn_ws;
static_assert(kBlock == ws::kRows && kBlock == ws::kKeys,
              "one CUDA block per q block, one tile per kv block");

template <int D>
__global__ void __launch_bounds__(ws::kThreads, 1)
    splash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           uint16_t* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ counts,
                           const int* __restrict__ blocks,
                           const int* __restrict__ kinds, int L, int H, int R,
                           int W) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int nq = L / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;
  const BlockRow row = dl4j_splash::block_row(counts, blocks, kinds, R, W, nq,
                                              blockIdx.x, qb);
  const dl4j_splash::SplashWalk<ws::kKeys, ws::kWgRows> walk{
      row.blocks, row.kinds, row.count};
  ws::attn_fwd_ws<D>(&tq, &tk, &tv, o, lse, L, H, qb * kBlock, blockIdx.x,
                     blockIdx.z, walk, kMaskValue, ws::kLog2e, 1.f, smem_w);
}

template <int D>
int run_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
             uint16_t* o, float* lse, const int* counts, const int* blocks,
             const int* kinds, int B, int L, int H, int R, int W,
             cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return ws::launch_ws<D>(splash_fwd_bf16_kernel<D>, grid, stream, q, k, v, B,
                          L, H, o, lse, counts, blocks, kinds, L, H, R, W);
}

}  // namespace

// Shared memory per block: 192 KiB at D = 128, 96 KiB at D = 64.
extern "C" int dl4j_splash_fwd_f32(const float* q, const float* k, const float* v,
                                   float* o, float* lse, const int* counts,
                                   const int* blocks, const int* kinds, int B,
                                   int L, int H, int D, int R, int W,
                                   void* stream) {
  if (dl4j_splash::bad_dims(B, L, H, R, W) || L / dl4j_splash::kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return run<16>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 32: return run<32>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 64: return run<64>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    case 128: return run<128>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the kernel
// for head dim D into out[3].
extern "C" int dl4j_splash_fwd_attrs(int D, int* out) {
  switch (D) {
    case 16: return attrs(splash_fwd_kernel<16>, Fwd<16>::kSmem, out);
    case 32: return attrs(splash_fwd_kernel<32>, Fwd<32>::kSmem, out);
    case 64: return attrs(splash_fwd_kernel<64>, Fwd<64>::kSmem, out);
    case 128: return attrs(splash_fwd_kernel<128>, Fwd<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q (pre-scaled), k, v, o (raw bf16 bits), f32 lse. Shared memory per
// block: 161 KiB at D = 128, 81 KiB at D = 64 (attn_fwd_bf16.cuh).
extern "C" int dl4j_splash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                                    const uint16_t* v, uint16_t* o, float* lse,
                                    const int* counts, const int* blocks,
                                    const int* kinds, int B, int L, int H,
                                    int D, int R, int W, void* stream) {
  if (dl4j_splash::bad_dims(B, L, H, R, W) || L / dl4j_splash::kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DL4J_FWD(DIM) \
  run_bf16<DIM>(q, k, v, o, lse, counts, blocks, kinds, B, L, H, R, W, s)
  switch (D) {
    case 16: return DL4J_FWD(16);
    case 32: return DL4J_FWD(32);
    case 64: return DL4J_FWD(64);
    case 128: return DL4J_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_FWD
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16
// kernel for head dim D into out[3].
extern "C" int dl4j_splash_fwd_bf16_attrs(int D, int* out) {
  switch (D) {
    case 16: return attrs(splash_fwd_bf16_kernel<16>, ws::Fwd<16>::kSmem, out);
    case 32: return attrs(splash_fwd_bf16_kernel<32>, ws::Fwd<32>::kSmem, out);
    case 64: return attrs(splash_fwd_bf16_kernel<64>, ws::Fwd<64>::kSmem, out);
    case 128: return attrs(splash_fwd_bf16_kernel<128>, ws::Fwd<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
