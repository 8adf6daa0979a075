// Flash-attention backward for Hopper (sm_90a), f32: the dK/dV kernel and the
// dQ kernel.
//
// Replaces the two backward Pallas TPU kernels behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_flash_call` (:589), the library's
// `_flash_attention_bwd_dkv` (jax/experimental/pallas/ops/tpu/
// flash_attention.py, pallas_call at :1121 in JAX 0.9.0) and
// `_flash_attention_bwd_dq` (pallas_call at :1456). From q, k, v, dO
// [B, L, H, D], lse [B, H, L] (the forward's) and di = sum_d o * dO [B, H, L]
// (one plain reduction outside, as the library computes it in XLA, :273):
//
//   p  = exp(q k^T * scale - lse)       (0 where masked)
//   ds = p * (dO v^T - di)
//   dv = p^T dO,  dk = scale * ds^T q   (dK/dV kernel)
//   dq = scale * ds k                   (dQ kernel)
//
// Design: the dK/dV kernel runs one block per (k tile of 64 rows, head, batch
// row); it keeps its k and v tiles in shared memory and loops over the q tiles
// from the diagonal on (all of them when not causal), recomputing p and ds
// per tile, with the 64 x D dk and dv accumulators in registers. The dQ kernel
// runs one block per (q tile, head, batch row), longest causal row first,
// and loops over the k tiles up to the diagonal, with dq in registers. Each
// output element is written by one thread of one block after a loop in a
// fixed order: no atomics, so the gradients are the same bits on every
// launch. Rows and columns past L are masked and never loaded; any L >= 1
// runs. expf, not __expf: the gradient gates are 1e-3 of max |plain|.
//
// What bounds it on this card: the f32 operations, 2.5 times the forward's
// (the dK/dV kernel 4 products of 2 L^2 D per (b, h), the dQ kernel 3, half
// each when causal); SIMT FMA from shared-memory tiles, as the forward.
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace dl4j_flash;

// p and ds of one 64 x 64 tile at the thread's rows ty + 16 i (of the q tile
// at q0) and columns tx + 16 j (of the k tile at k0), into p_s (when given)
// and ds_s.
template <int D, bool kCausal>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* k_s, const float* v_s, const float* do_s,
    const float* lse_s, const float* di_s, float* p_s, float* ds_s, int q0,
    int k0, bool edge, int L, float scale, int ty, int tx) {
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
      const bool keep = !edge || live<kCausal>(q0 + r, k0 + c, L);
      const float p = keep ? expf(s[i][j] * scale - lr) : 0.f;
      if (p_s != nullptr) p_s[r * kSStride + c] = p;
      ds_s[r * kSStride + c] = p * (dp[i][j] - dr);
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int L,
                         int H, float scale) {
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
  const int nt = (L + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // causal: the most q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
  const int k0 = kt * kTile;
  load_tile<D>(k_s, k, base, k0, L, rs);
  load_tile<D>(v_s, v, base, k0, L, rs);

  float acc_dk[kSub][kOut], acc_dv[kSub][kOut];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) acc_dk[i][jj] = acc_dv[i][jj] = 0.f;

  for (int qt = kCausal ? kt : 0; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(q_s, q, base, q0, L, rs);
    load_tile<D>(do_s, dout, base, q0, L, rs);
    load_vec(lse_s, lse, lbase, q0, L);
    load_vec(di_s, di, lbase, q0, L);
    __syncthreads();
    const bool edge = (kCausal && qt == kt) || q0 + kTile > L || k0 + kTile > L;
    probs_and_ds<D, kCausal>(q_s, k_s, v_s, do_s, lse_s, di_s, p_s, ds_s, q0, k0,
                             edge, L, scale, ty, tx);
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

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < L) {
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const long long off = base + (long long)row * rs + tx + 16 * jj;
        dk[off] = acc_dk[i][jj] * scale;
        dv[off] = acc_dv[i][jj];
      }
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, int L, int H, float scale) {
  constexpr int P = Dims<D>::kStride;
  constexpr int kOut = Dims<D>::kOut;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + Dims<D>::kTileFloats;
  float* k_s = do_s + Dims<D>::kTileFloats;
  float* v_s = k_s + Dims<D>::kTileFloats;
  float* ds_s = v_s + Dims<D>::kTileFloats;  // [64][kSStride]
  float* lse_s = ds_s + kTile * kSStride;    // [64]
  float* di_s = lse_s + kTile;               // [64]
  const int nt = (L + kTile - 1) / kTile;
  const int qt = nt - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
  const int q0 = qt * kTile;
  load_tile<D>(q_s, q, base, q0, L, rs);
  load_tile<D>(do_s, dout, base, q0, L, rs);
  load_vec(lse_s, lse, lbase, q0, L);
  load_vec(di_s, di, lbase, q0, L);

  float acc[kSub][kOut];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = 0.f;

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_s, k, base, k0, L, rs);
    load_tile<D>(v_s, v, base, k0, L, rs);
    __syncthreads();
    const bool edge = (kCausal && kt == qt) || q0 + kTile > L || k0 + kTile > L;
    probs_and_ds<D, kCausal>(q_s, k_s, v_s, do_s, lse_s, di_s, nullptr, ds_s, q0,
                             k0, edge, L, scale, ty, tx);
    __syncthreads();
    // dq[r][d] += sum_c ds[r][c] k[c][d]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[kSub], kv[kOut];
#pragma unroll
      for (int i = 0; i < kSub; ++i) dsv[i] = ds_s[(ty + 16 * i) * kSStride + c];
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) kv[jj] = k_s[c * P + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < L) {
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj)
        dq[base + (long long)row * rs + tx + 16 * jj] = acc[i][jj] * scale;
    }
  }
}

template <int D, bool kCausal>
int run_dkv(const float* q, const float* k, const float* v, const float* dout,
            const float* lse, const float* di, float* dk, float* dv, int B, int L,
            int H, float scale, cudaStream_t stream) {
  const size_t smem = (4 * (size_t)Dims<D>::kTileFloats + 2 * (size_t)kTile * kSStride +
                       2 * (size_t)kTile) * sizeof(float);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  return launch(flash_bwd_dkv_kernel<D, kCausal>, grid, smem, stream, q, k, v, dout,
                lse, di, dk, dv, L, H, scale);
}

template <int D, bool kCausal>
int run_dq(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* di, float* dq, int B, int L, int H,
           float scale, cudaStream_t stream) {
  const size_t smem = (4 * (size_t)Dims<D>::kTileFloats + (size_t)kTile * kSStride +
                       2 * (size_t)kTile) * sizeof(float);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  return launch(flash_bwd_dq_kernel<D, kCausal>, grid, smem, stream, q, k, v, dout,
                lse, di, dq, L, H, scale);
}

template <int D>
int dkv(bool causal, const float* q, const float* k, const float* v,
        const float* dout, const float* lse, const float* di, float* dk, float* dv,
        int B, int L, int H, float scale, cudaStream_t s) {
  return causal ? run_dkv<D, true>(q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s)
                : run_dkv<D, false>(q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
}

template <int D>
int dq(bool causal, const float* q, const float* k, const float* v,
       const float* dout, const float* lse, const float* di, float* dq_, int B,
       int L, int H, float scale, cudaStream_t s) {
  return causal ? run_dq<D, true>(q, k, v, dout, lse, di, dq_, B, L, H, scale, s)
                : run_dq<D, false>(q, k, v, dout, lse, di, dq_, B, L, H, scale, s);
}

bool bad_dims(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

}  // namespace

// Shared memory per block at D = 128: dK/dV 169.5 KiB, dQ 149.5 KiB.
extern "C" int dl4j_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse,
                                      const float* di, float* dk, float* dv, int B,
                                      int L, int H, int D, int causal, float scale,
                                      void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  switch (D) {
    case 16: return dkv<16>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 32: return dkv<32>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 64: return dkv<64>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 128: return dkv<128>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dl4j_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                     const float* dout, const float* lse,
                                     const float* di, float* dq_out, int B, int L,
                                     int H, int D, int causal, float scale,
                                     void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  switch (D) {
    case 16: return dq<16>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 32: return dq<32>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 64: return dq<64>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 128: return dq<128>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
