// Flash-attention forward for Hopper (sm_90a), f32 in and out, both products
// on the tensor cores in 3xTF32.
//
// Replaces the forward Pallas TPU kernel behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_flash_call` (:589): the library
// kernel `_flash_attention_impl` (jax/experimental/pallas/ops/tpu/
// flash_attention.py, pallas_call at :758 in JAX 0.9.0). It computes
//
//   o   [B, L, H, D] = softmax(q k^T * scale, causal or full) v
//   lse [B, H, L]    = the log of each row's softmax denominator, max included
//
// from q, k, v [B, L, H, D] f32 with equal head counts (the layer repeats GQA's
// K/V heads first). The TPU kernel saves the row max m and sum l apart; one
// lse = m + log(l) is all the backward needs.
//
// Design (attn_fwd_tc.cuh): one block of 8 warps per (head, 128 query rows,
// batch row), launched longest causal rows first across all heads (the grid is
// (H, q tiles, B), x fastest: with the heads as the slowest index, the heavy
// tiles of the last heads started late and left SMs idle at the end); q in a
// shared tile, k and v through a 2-stage cp.async ring of 64-key tiles, s = q
// k^T and o += p v with mma.sync m16n8k8 tf32 in 3xTF32, the online softmax on
// the accumulator fragments, p in registers. With `causal` the walk stops at
// the diagonal tile, and a warp skips the math of a tile wholly above its 16
// rows. Masked scores (past L, above the diagonal) are -inf in registers and
// take no part in max or sum, which is what the dense version's f32-min fill
// gives; a row whose every score so far is masked keeps m = -inf and uses 0 in
// its place (m_use), so nothing turns NaN. Rows and keys past L are zero-filled
// and masked, so any L >= 1 runs. expf and logf, not __expf: the o and lse
// gates are 1e-5 of max |plain|.
//
// What bounds it on this card: operations, 4 D per kept (query, key) pair,
// far above its bytes at L >= 256. Against f32 outside the tensor cores (67
// TFLOP/s) that is 1.026 ms at [1, 8192, 4, 128] causal; the 3xTF32 split
// runs three tf32 products per product (495 TFLOP/s), a least time of
// 0.416 ms there. Why mma.sync and not wgmma, and the error of plain TF32:
// attn_fwd_tc.cuh.
//
// bf16 (dl4j_flash_fwd_bf16): its own kernel over attn_fwd_bf16.cuh, designed
// for Hopper: a producer warpgroup feeding K and V tiles of 128 keys by TMA
// through an mbarrier ring, two consumer warpgroups of 64 query rows on
// wgmma that take turns on the tensor cores, p rounded to bf16 before p v as
// the library rounds it (flash_attention.py :471). Bound: 4 D operations per
// kept pair at 989 TFLOP/s, 0.0695 ms at [1, 8192, 4, 128] causal on an
// H100; the mma.sync kernel it replaces took 0.357 ms there (0.195 of it),
// SDPA's bf16 forward 0.176 ms. What the design does about it: attn_fwd_bf16.cuh.
#include <cuda_runtime.h>
#include <math.h>

#include "attn_fwd_bf16.cuh"
#include "attn_fwd_tc.cuh"
#include "flash_common.cuh"  // dl4j_cuda_error_string

namespace {

using namespace dl4j_attn_tc;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int L, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (L + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kRows;
  const FlashWalk<kCausal> walk(L, q0, scale);
  attn_fwd<D>(q, k, v, o, lse, L, H, q0, blockIdx.x, blockIdx.z, walk,
              -INFINITY, smem);
}

template <int D, bool kCausal>
int run(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int L, int H, float scale, cudaStream_t stream) {
  const dim3 grid(H, (L + kRows - 1) / kRows, B);
  return launch(flash_fwd_kernel<D, kCausal>, grid, Fwd<D>::kSmem, stream, q,
                k, v, o, lse, L, H, scale);
}

template <int D>
int dispatch(bool causal, const float* q, const float* k, const float* v,
             float* o, float* lse, int B, int L, int H, float scale,
             cudaStream_t stream) {
  return causal ? run<D, true>(q, k, v, o, lse, B, L, H, scale, stream)
                : run<D, false>(q, k, v, o, lse, B, L, H, scale, stream);
}

template <int D>
int kernel_attrs(bool causal, int* out) {
  return causal ? attrs(flash_fwd_kernel<D, true>, Fwd<D>::kSmem, out)
                : attrs(flash_fwd_kernel<D, false>, Fwd<D>::kSmem, out);
}

namespace ws = dl4j_attn_ws;

template <int D, bool kCausal>
__global__ void __launch_bounds__(ws::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          uint16_t* __restrict__ o, float* __restrict__ lse,
                          int L, int H, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int nq = (L + ws::kRows - 1) / ws::kRows;
  const int q0 = (nq - 1 - (int)blockIdx.y) * ws::kRows;
  const ws::FlashWalk<kCausal> walk(L, q0);
  ws::attn_fwd_ws<D>(&tq, &tk, &tv, o, lse, L, H, q0, blockIdx.x, blockIdx.z,
                     walk, -INFINITY, scale * ws::kLog2e, scale, smem_w);
}

template <int D>
int dispatch_bf16(bool causal, const uint16_t* q, const uint16_t* k,
                  const uint16_t* v, uint16_t* o, float* lse, int B, int L,
                  int H, float scale, cudaStream_t stream) {
  const dim3 grid(H, (L + ws::kRows - 1) / ws::kRows, B);
  return causal ? ws::launch_ws<D>(flash_fwd_bf16_kernel<D, true>, grid,
                                   stream, q, k, v, B, L, H, o, lse, L, H,
                                   scale)
                : ws::launch_ws<D>(flash_fwd_bf16_kernel<D, false>, grid,
                                   stream, q, k, v, B, L, H, o, lse, L, H,
                                   scale);
}

template <int D>
int kernel_attrs_bf16(bool causal, int* out) {
  constexpr size_t smem = ws::Fwd<D>::kSmem;
  return causal ? attrs(flash_fwd_bf16_kernel<D, true>, smem, out)
                : attrs(flash_fwd_bf16_kernel<D, false>, smem, out);
}

bool bad_dims(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535 ||
         (L + kRows - 1) / kRows > 65535;
}

}  // namespace

// Shared memory per block: 192 KiB at D = 128, 96 KiB at D = 64.
extern "C" int dl4j_flash_fwd_f32(const float* q, const float* k, const float* v,
                                  float* o, float* lse, int B, int L, int H, int D,
                                  int causal, float scale, void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return dispatch<16>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 32: return dispatch<32>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 64: return dispatch<64>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    case 128: return dispatch<128>(causal != 0, q, k, v, o, lse, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the kernel
// for head dim D into out[3].
extern "C" int dl4j_flash_fwd_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return kernel_attrs<16>(causal != 0, out);
    case 32: return kernel_attrs<32>(causal != 0, out);
    case 64: return kernel_attrs<64>(causal != 0, out);
    case 128: return kernel_attrs<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q, k, v, o (raw bf16 bits), f32 lse. Shared memory per block: 161
// KiB at D = 128, 81 KiB at D = 64 (attn_fwd_bf16.cuh).
extern "C" int dl4j_flash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                                   const uint16_t* v, uint16_t* o, float* lse,
                                   int B, int L, int H, int D, int causal,
                                   float scale, void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  switch (D) {
    case 16: return dispatch_bf16<16>(c, q, k, v, o, lse, B, L, H, scale, s);
    case 32: return dispatch_bf16<32>(c, q, k, v, o, lse, B, L, H, scale, s);
    case 64: return dispatch_bf16<64>(c, q, k, v, o, lse, B, L, H, scale, s);
    case 128: return dispatch_bf16<128>(c, q, k, v, o, lse, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16
// kernel for head dim D into out[3].
extern "C" int dl4j_flash_fwd_bf16_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return kernel_attrs_bf16<16>(causal != 0, out);
    case 32: return kernel_attrs_bf16<32>(causal != 0, out);
    case 64: return kernel_attrs_bf16<64>(causal != 0, out);
    case 128: return kernel_attrs_bf16<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The warp specialisation of the bf16 forward core (attn_fwd_bf16.cuh) into
// out[6]: threads per block, the producer warpgroup's and each consumer
// warpgroup's registers after setmaxnreg, the ring's stages, keys per K/V
// tile and query rows per block.
extern "C" int dl4j_attn_fwd_bf16_roles(int* out) {
  out[0] = ws::kThreads;
  out[1] = ws::kProducerRegs;
  out[2] = ws::kConsumerRegs;
  out[3] = ws::kStages;
  out[4] = ws::kKeys;
  out[5] = ws::kRows;
  return 0;
}
