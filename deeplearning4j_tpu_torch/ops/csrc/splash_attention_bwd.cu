// Splash-attention backward for Hopper (sm_90a), f32: the dK/dV kernel and the
// dQ kernel, each driven by its own block table.
//
// Replaces the two backward Pallas TPU kernels behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_splash_call` (:609) at the
// library's default (unfused) block sizes: `_splash_attention_bwd_dkv`
// (jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
// :1857, pallas_call at :2196) and `_splash_attention_bwd_dq` (:1405,
// pallas_call at :1635), JAX 0.9.0. From q (pre-scaled), k, v, dO
// [B, L, H, D], lse [B, H, L] (the forward's) and di = sum_d o * dO [B, H, L]
// (one plain reduction outside, as `_splash_attention_bwd` :2241 computes it):
//
//   p  = exp(q k^T - lse)     (masked scores at the mask value: p = 0)
//   ds = p * (dO v^T - di)
//   dv = p^T dO,  dk = ds^T q  (dK/dV kernel; no scale: q carries it)
//   dq = ds k                  (dQ kernel; autograd applies the scale)
//
// Design of both (attn_dkv_tc.cuh, attn_dq_tc.cuh): on the tensor cores in
// 3xTF32, one block of 8 warps per row of its block list, that is per (head,
// block of 128 rows of the launch axis, batch row), the longest rows first
// across all heads (grid (H, blocks, B), as the forward).
//   - dK/dV: kv block 0 (the most listed q blocks under a causal table)
//     first. It reads that kv block's row of the dK/dV block list, the
//     library's shrunk `dkv_mask_info` read down its columns, and walks only
//     the q blocks it names (SplashDkvWalk, splash_common.cuh). k and v of
//     the block's 128 keys stay in shared tiles; q, dO, lse and di stream
//     through a 2-stage cp.async ring in tiles of 32 query rows at D = 128
//     (64 at D <= 64); s^T, dp^T, p^T and ds^T in registers, p^T and ds^T
//     as the A operands of p^T dO and ds^T q. A warp skips a kind-1 tile
//     whose every query precedes all 16 of its keys.
//   - dQ: q and dO in shared tiles, K/V through the ring in 32-key tiles at
//     D = 128 (64 at D <= 64), s, dp and ds in registers, ds as the A
//     operand of ds k; the forward's SplashWalk.
// Kind-2 blocks run no mask code; kind-1 blocks evaluate q >= k and give the
// rest the mask value (p = 0).
//
// Every output element is written once by one thread after a loop in a fixed
// order: no atomics, so a launch gives the same bits every time.
//
// What bounds them on this card: operations, 8 D (dK/dV: s recomputed, dO
// v^T, p^T dO, ds^T q) and 6 D (dQ) per kept pair. The 3xTF32 split runs
// three tf32 products per product at 495 TFLOP/s: least times of 13.328 ms
// (dK/dV) and 9.996 ms (dQ) at [1, 32768, 4, 128] causal (32.822 and 24.617
// ms against f32 outside the tensor cores, 67 TFLOP/s).
//
// bf16 (dl4j_splash_bwd_dkv_bf16, dl4j_splash_bwd_dq_bf16): bf16 q, k, v,
// dO and outputs, f32 lse and di; p and ds go to bf16 before p^T dO, ds^T
// q and ds k, as the library rounds them (splash_attention_kernel.py
// :1788, :1804, :1395). Both run on Hopper cores, one block of two
// warpgroups per row of their table, each warpgroup on 64 rows of the
// launch axis with wgmma. dK/dV (attn_dkv_bf16.cuh): a kv block, fetching
// by TMA only the q blocks its column of the dK/dV table lists, in 64-row
// tiles through an mbarrier ring. dQ (attn_dq_bf16.cuh): a q block,
// fetching by TMA only the kv blocks its row of the dQ table lists, in
// 64-key tiles through an mbarrier ring (SplashWalk<64, 64>). Bounds at
// 989 TFLOP/s: 2.224 ms (dK/dV) and 1.668 ms (dQ) at [1, 32768, 4, 128]
// causal.
#include <cuda_runtime.h>
#include <math.h>

#include "attn_dkv_bf16.cuh"
#include "attn_dkv_tc.cuh"
#include "attn_dq_bf16.cuh"
#include "attn_dq_tc.cuh"
#include "splash_common.cuh"

namespace {

using namespace dl4j_splash;

template <int D>
__global__ void __launch_bounds__(dl4j_attn_tc::kThreads, 1)
    splash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ counts, const int* __restrict__ blocks,
                          const int* __restrict__ kinds, int L, int H, int R, int W) {
  static_assert(kBlock == dl4j_attn_tc::kRows, "one CUDA block per kv block");
  extern __shared__ __align__(16) float smem[];
  const int kb = blockIdx.y;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, L / kBlock,
                                 blockIdx.x, kb);
  const SplashDkvWalk<dl4j_attn_tc::Dkv<D>::kQT> walk{
      {row.blocks, row.kinds, row.count}};
  dl4j_attn_tc::attn_dkv<D>(q, k, v, dout, lse, di, dk, dv, L, H, kb * kBlock,
                            blockIdx.x, blockIdx.z, walk, kMaskValue, smem);
}

template <int D>
__global__ void __launch_bounds__(dl4j_attn_tc::kThreads, 1)
    splash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, const int* __restrict__ counts,
                         const int* __restrict__ blocks, const int* __restrict__ kinds,
                         int L, int H, int R, int W) {
  static_assert(kBlock == dl4j_attn_tc::kRows, "one CUDA block per q block");
  extern __shared__ __align__(16) float smem[];
  const int nq = L / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, nq, blockIdx.x, qb);
  const SplashWalk<dl4j_attn_tc::Dq<D>::kKeys> walk{row.blocks, row.kinds,
                                                    row.count};
  dl4j_attn_tc::attn_dq<D>(q, k, v, dout, lse, di, dq, L, H, qb * kBlock,
                           blockIdx.x, blockIdx.z, walk, kMaskValue, smem);
}

template <int D>
int run_dkv(const float* q, const float* k, const float* v, const float* dout,
            const float* lse, const float* di, float* dk, float* dv,
            const int* counts, const int* blocks, const int* kinds, int B, int L,
            int H, int R, int W, cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return dl4j_attn_tc::launch(splash_bwd_dkv_kernel<D>, grid,
                              dl4j_attn_tc::Dkv<D>::kSmem, stream, q, k, v,
                              dout, lse, di, dk, dv, counts, blocks, kinds, L,
                              H, R, W);
}

template <int D>
int run_dq(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* di, float* dq, const int* counts,
           const int* blocks, const int* kinds, int B, int L, int H, int R, int W,
           cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return dl4j_attn_tc::launch(splash_bwd_dq_kernel<D>, grid,
                              dl4j_attn_tc::Dq<D>::kSmem, stream, q, k, v, dout,
                              lse, di, dq, counts, blocks, kinds, L, H, R, W);
}

namespace dkv16 = dl4j_attn_dkv;
static_assert(kBlock == dkv16::kKeys && kBlock % dkv16::kQT == 0,
              "one CUDA block per kv block, whole q tiles per q block");

template <int D>
__global__ void __launch_bounds__(dkv16::kThreads, 1)
    splash_bwd_dkv_bf16_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
        const float* __restrict__ di, uint16_t* __restrict__ dk,
        uint16_t* __restrict__ dv, const int* __restrict__ counts,
        const int* __restrict__ blocks, const int* __restrict__ kinds, int L,
        int H, int R, int W) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int kb = blockIdx.y;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, L / kBlock,
                                 blockIdx.x, kb);
  const SplashDkvWgWalk<dkv16::kQT, dkv16::kWgKeys> walk{
      {{row.blocks, row.kinds, row.count}}};
  dkv16::attn_dkv_ws<D>(&tq, &tdo, &tk, &tv, lse, di, dk, dv, L, H,
                        kb * kBlock, blockIdx.x, blockIdx.z, walk, kMaskValue,
                        dkv16::kLog2e, smem_w);
}

namespace dq16 = dl4j_attn_dq;
static_assert(kBlock == dq16::kRows && kBlock % dq16::kKT == 0,
              "one CUDA block per q block, whole k / v tiles per kv block");

template <int D>
__global__ void __launch_bounds__(dq16::kThreads, 1)
    splash_bwd_dq_bf16_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
        const float* __restrict__ di, uint16_t* __restrict__ dq,
        const int* __restrict__ counts, const int* __restrict__ blocks,
        const int* __restrict__ kinds, int L, int H, int R, int W) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int nq = L / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, nq, blockIdx.x, qb);
  const SplashWalk<dq16::kKT, dq16::kWgRows> walk{row.blocks, row.kinds,
                                                   row.count};
  dq16::attn_dq_ws<D>(&tq, &tdo, &tk, &tv, lse, di, dq, L, H, qb * kBlock,
                      blockIdx.x, blockIdx.z, walk, kMaskValue, dq16::kLog2e,
                      smem_w);
}

template <int D>
int run_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                 const uint16_t* dout, const float* lse, const float* di,
                 uint16_t* dk, uint16_t* dv, const int* counts,
                 const int* blocks, const int* kinds, int B, int L, int H,
                 int R, int W, cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return dkv16::launch_dkv<D>(splash_bwd_dkv_bf16_kernel<D>, grid, stream, q, k,
                              v, dout, B, L, H, lse, di, dk, dv, counts, blocks,
                              kinds, L, H, R, W);
}

template <int D>
int run_dq_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                const uint16_t* dout, const float* lse, const float* di,
                uint16_t* dq, const int* counts, const int* blocks,
                const int* kinds, int B, int L, int H, int R, int W,
                cudaStream_t stream) {
  const dim3 grid(H, L / kBlock, B);
  return dq16::launch_dq<D>(splash_bwd_dq_bf16_kernel<D>, grid, stream, q, k,
                            v, dout, B, L, H, lse, di, dq, counts, blocks,
                            kinds, L, H, R, W);
}

}  // namespace

// Shared memory per block at D = 128: dK/dV 192.5 KiB, dQ 192 KiB (129 KiB
// and 128 KiB at D = 64).
extern "C" int dl4j_splash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse,
                                       const float* di, float* dk, float* dv,
                                       const int* counts, const int* blocks,
                                       const int* kinds, int B, int L, int H, int D,
                                       int R, int W, void* stream) {
  if (bad_dims(B, L, H, R, W) || L / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DL4J_DKV(DIM)                                                             \
  run_dkv<DIM>(q, k, v, dout, lse, di, dk, dv, counts, blocks, kinds, B, L, H, R, \
               W, s)
  switch (D) {
    case 16: return DL4J_DKV(16);
    case 32: return DL4J_DKV(32);
    case 64: return DL4J_DKV(64);
    case 128: return DL4J_DKV(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DKV
}

extern "C" int dl4j_splash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse,
                                      const float* di, float* dq_out,
                                      const int* counts, const int* blocks,
                                      const int* kinds, int B, int L, int H, int D,
                                      int R, int W, void* stream) {
  if (bad_dims(B, L, H, R, W) || L / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DL4J_DQ(DIM) \
  run_dq<DIM>(q, k, v, dout, lse, di, dq_out, counts, blocks, kinds, B, L, H, R, W, s)
  switch (D) {
    case 16: return DL4J_DQ(16);
    case 32: return DL4J_DQ(32);
    case 64: return DL4J_DQ(64);
    case 128: return DL4J_DQ(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DQ
}

// {registers, local bytes per thread, dynamic shared bytes} of the dQ kernel
// for head dim D into out[3].
extern "C" int dl4j_splash_bwd_dq_attrs(int D, int* out) {
  using dl4j_attn_tc::Dq;
  using dl4j_tc::attrs;
  switch (D) {
    case 16: return attrs(splash_bwd_dq_kernel<16>, Dq<16>::kSmem, out);
    case 32: return attrs(splash_bwd_dq_kernel<32>, Dq<32>::kSmem, out);
    case 64: return attrs(splash_bwd_dq_kernel<64>, Dq<64>::kSmem, out);
    case 128: return attrs(splash_bwd_dq_kernel<128>, Dq<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the dK/dV
// kernel for head dim D into out[3].
extern "C" int dl4j_splash_bwd_dkv_attrs(int D, int* out) {
  using dl4j_attn_tc::Dkv;
  using dl4j_tc::attrs;
  switch (D) {
    case 16: return attrs(splash_bwd_dkv_kernel<16>, Dkv<16>::kSmem, out);
    case 32: return attrs(splash_bwd_dkv_kernel<32>, Dkv<32>::kSmem, out);
    case 64: return attrs(splash_bwd_dkv_kernel<64>, Dkv<64>::kSmem, out);
    case 128: return attrs(splash_bwd_dkv_kernel<128>, Dkv<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q (pre-scaled), k, v, dO, dk, dv (raw bf16 bits), f32 lse and di.
// Shared memory per block at D = 128: dK/dV 163 KiB (attn_dkv_bf16.cuh), dQ
// 225 KiB (attn_dq_bf16.cuh).
extern "C" int dl4j_splash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k,
                                        const uint16_t* v, const uint16_t* dout,
                                        const float* lse, const float* di,
                                        uint16_t* dk, uint16_t* dv,
                                        const int* counts, const int* blocks,
                                        const int* kinds, int B, int L, int H,
                                        int D, int R, int W, void* stream) {
  if (bad_dims(B, L, H, R, W) || L / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DL4J_DKV(DIM)                                                       \
  run_dkv_bf16<DIM>(q, k, v, dout, lse, di, dk, dv, counts, blocks, kinds, B, \
                    L, H, R, W, s)
  switch (D) {
    case 16: return DL4J_DKV(16);
    case 32: return DL4J_DKV(32);
    case 64: return DL4J_DKV(64);
    case 128: return DL4J_DKV(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DKV
}

extern "C" int dl4j_splash_bwd_dq_bf16(const uint16_t* q, const uint16_t* k,
                                       const uint16_t* v, const uint16_t* dout,
                                       const float* lse, const float* di,
                                       uint16_t* dq_out, const int* counts,
                                       const int* blocks, const int* kinds,
                                       int B, int L, int H, int D, int R, int W,
                                       void* stream) {
  if (bad_dims(B, L, H, R, W) || L / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DL4J_DQ(DIM)                                                          \
  run_dq_bf16<DIM>(q, k, v, dout, lse, di, dq_out, counts, blocks, kinds, B, L, \
                   H, R, W, s)
  switch (D) {
    case 16: return DL4J_DQ(16);
    case 32: return DL4J_DQ(32);
    case 64: return DL4J_DQ(64);
    case 128: return DL4J_DQ(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DQ
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16 dQ
// kernel for head dim D into out[3].
extern "C" int dl4j_splash_bwd_dq_bf16_attrs(int D, int* out) {
  using dq16::Dq;
  using dl4j_tc::attrs;
  switch (D) {
    case 16: return attrs(splash_bwd_dq_bf16_kernel<16>, Dq<16>::kSmem, out);
    case 32: return attrs(splash_bwd_dq_bf16_kernel<32>, Dq<32>::kSmem, out);
    case 64: return attrs(splash_bwd_dq_bf16_kernel<64>, Dq<64>::kSmem, out);
    case 128: return attrs(splash_bwd_dq_bf16_kernel<128>, Dq<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16
// dK/dV kernel for head dim D into out[3].
extern "C" int dl4j_splash_bwd_dkv_bf16_attrs(int D, int* out) {
  using dkv16::Dkv;
  using dl4j_tc::attrs;
  switch (D) {
    case 16: return attrs(splash_bwd_dkv_bf16_kernel<16>, Dkv<16>::kSmem, out);
    case 32: return attrs(splash_bwd_dkv_bf16_kernel<32>, Dkv<32>::kSmem, out);
    case 64: return attrs(splash_bwd_dkv_bf16_kernel<64>, Dkv<64>::kSmem, out);
    case 128: return attrs(splash_bwd_dkv_bf16_kernel<128>, Dkv<128>::kSmem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
