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
// Design of the dK/dV kernel (SIMT f32 FMA from shared-memory tiles, over
// flash_common.cuh's tile_dot): one block per (kv block of 128 rows, head,
// batch row), kv block 0 (the most listed q blocks under a causal table)
// first. It reads that kv block's row of the dK/dV block list, the
// library's shrunk `dkv_mask_info` read down its columns, and walks only the
// q blocks it names. Each 64-row half of the kv block keeps its k and v tiles
// in shared memory and its 64 x D dk and dv sums in registers while the
// listed q blocks stream past in 64-row tiles, recomputing p and ds per tile.
// Kind-2 blocks run no mask code; kind-1 blocks evaluate q >= k and skip
// tiles wholly above the diagonal (p = 0 there).
//
// Design of the dQ kernel (attn_dq_tc.cuh): on the tensor cores in 3xTF32,
// one block of 8 warps per row of the dQ block list, that is per (head, q
// block of 128 rows, batch row), most table entries first across all heads
// (grid (H, q blocks, B), as the forward); q and dO in shared tiles, K/V
// through a 2-stage cp.async ring in 32-key tiles at D = 128 (64 at D <= 64),
// s, dp and ds in registers, ds as the A operand of ds k. It walks the
// listed kv blocks with the forward's SplashWalk (splash_common.cuh).
//
// Every output element is written once by one thread after a loop in a fixed
// order: no atomics, so a launch gives the same bits every time.
//
// What bounds them on this card: the f32 operations, 8 D (dK/dV: s
// recomputed, dO v^T, p^T dO, ds^T q) and 6 D (dQ) per kept pair. dQ's 3xTF32
// split runs three tf32 products per product: its least time is 3 x 6 D per
// kept pair at 495 TFLOP/s, 9.996 ms at [1, 32768, 4, 128] causal (24.617 ms
// against f32 outside the tensor cores, 67 TFLOP/s).
#include <cuda_runtime.h>
#include <math.h>

#include "attn_dq_tc.cuh"
#include "splash_common.cuh"

namespace {

using namespace dl4j_splash;

template <int D>
__global__ void __launch_bounds__(kThreads)
    splash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ counts, const int* __restrict__ blocks,
                          const int* __restrict__ kinds, int L, int H, int R, int W) {
  constexpr int P = Dims<D>::kStride;
  constexpr int kOut = Dims<D>::kOut;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* q_s = v_s + Dims<D>::kTileFloats;
  float* do_s = q_s + Dims<D>::kTileFloats;
  float* p_s = do_s + Dims<D>::kTileFloats;  // [64][kSStride]
  float* ds_s = p_s + kTile * kSStride;      // [64][kSStride]
  float* lse_s = ds_s + kTile * kSStride;    // [64]
  float* di_s = lse_s + kTile;               // [64]
  const int nk = L / kBlock;
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
  const BlockRow row = block_row(counts, blocks, kinds, R, W, nk, h, kb);

  for (int half = 0; half < kHalves; ++half) {
    const int k0 = kb * kBlock + half * kTile;
    __syncthreads();  // the previous half's readers are done with k_s, v_s
    load_tile<D>(k_s, k, base, k0, L, rs);
    load_tile<D>(v_s, v, base, k0, L, rs);
    float acc_dk[kSub][kOut], acc_dv[kSub][kOut];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) acc_dk[i][jj] = acc_dv[i][jj] = 0.f;
    for (int e = 0; e < row.count; ++e) {
      const int kind = row.kinds[e];
      for (int sub = 0; sub < kHalves; ++sub) {
        const int q0 = row.blocks[e] * kBlock + sub * kTile;
        if (tile_masked(kind, q0, k0)) continue;
        __syncthreads();  // the previous tile's readers are done
        load_tile<D>(q_s, q, base, q0, L, rs);
        load_tile<D>(do_s, dout, base, q0, L, rs);
        load_vec(lse_s, lse, lbase, q0, L);
        load_vec(di_s, di, lbase, q0, L);
        __syncthreads();
        probs_and_ds<D>(q_s, k_s, v_s, do_s, lse_s, di_s, p_s, ds_s, q0, k0,
                        kind == 1, ty, tx);
        __syncthreads();
        // dv[c][d] += sum_r p[r][c] dO[r][d];  dk[c][d] += sum_r ds[r][c] q[r][d]
#pragma unroll 2
        for (int r = 0; r < kTile; ++r) {
          float pv[kSub], dsv[kSub], dov[kOut], qv[kOut];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            pv[i] = p_s[r * kSStride + ty + 16 * i];
            dsv[i] = ds_s[r * kSStride + ty + 16 * i];
          }
#pragma unroll
          for (int jj = 0; jj < kOut; ++jj) {
            dov[jj] = do_s[r * P + tx + 16 * jj];
            qv[jj] = q_s[r * P + tx + 16 * jj];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int jj = 0; jj < kOut; ++jj) {
              acc_dv[i][jj] = fmaf(pv[i], dov[jj], acc_dv[i][jj]);
              acc_dk[i][jj] = fmaf(dsv[i], qv[jj], acc_dk[i][jj]);
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const long long off = base + (long long)r * rs + tx + 16 * jj;
        dk[off] = acc_dk[i][jj];
        dv[off] = acc_dv[i][jj];
      }
    }
  }
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
  const size_t smem = (4 * (size_t)Dims<D>::kTileFloats + 2 * (size_t)kTile * kSStride +
                       2 * (size_t)kTile) * sizeof(float);
  const dim3 grid(L / kBlock, H, B);
  return launch(splash_bwd_dkv_kernel<D>, grid, smem, stream, q, k, v, dout, lse, di,
                dk, dv, counts, blocks, kinds, L, H, R, W);
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

}  // namespace

// Shared memory per block at D = 128: dK/dV 169.5 KiB, dQ 192 KiB (128 KiB
// at D = 64).
extern "C" int dl4j_splash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse,
                                       const float* di, float* dk, float* dv,
                                       const int* counts, const int* blocks,
                                       const int* kinds, int B, int L, int H, int D,
                                       int R, int W, void* stream) {
  if (bad_dims(B, L, H, R, W)) return (int)cudaErrorInvalidValue;
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
