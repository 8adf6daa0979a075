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
// Design of the dK/dV kernel (attn_dkv_tc.cuh): on the tensor cores in
// 3xTF32, one block of 8 warps per (head, 128 keys, batch row), key block 0
// (the longest causal walk) first across all heads (grid (H, key blocks,
// B)). k and v of the block's keys stay in shared tiles; q, dO, lse and di
// stream through a 2-stage cp.async ring in tiles of 32 query rows at D =
// 128 (64 at D <= 64), from the diagonal on when causal (all of them when
// not); p^T and ds^T in registers as the A operands of p^T dO and ds^T q.
// Rows and keys at or past L are masked (p = 0), zero-filled and never read,
// so any L >= 1 runs; dk takes the scale at the store.
//
// Design of the dQ kernel (SIMT f32 FMA from shared-memory tiles, over
// flash_common.cuh's tile_dot): one block per (q tile of 64 rows, head,
// batch row), longest causal row first; it loops over the k tiles up to the
// diagonal, recomputing p and ds per tile, with dq in registers.
//
// Each output element is written by one thread of one block after a loop in
// a fixed order: no atomics, so the gradients are the same bits on every
// launch. expf, not __expf: the gradient gates are 1e-5 of the largest plain
// gradient.
//
// What bounds them on this card: the f32 operations, 8 D per kept pair in
// dK/dV (s recomputed, dO v^T, p^T dO, ds^T q) and 6 D in dQ. dK/dV's 3xTF32
// split runs three tf32 products per product at 495 TFLOP/s: a least time of
// 0.8331 ms at [1, 8192, 4, 128] causal (2.0516 ms against f32 outside the
// tensor cores, 67 TFLOP/s).
#include <cuda_runtime.h>
#include <math.h>

#include "attn_dkv_tc.cuh"
#include "flash_common.cuh"

namespace {

using namespace dl4j_flash;

// ds of one 64 x 64 tile at the thread's rows ty + 16 i (of the q tile at
// q0) and columns tx + 16 j (of the k tile at k0), into ds_s.
template <int D, bool kCausal>
__device__ __forceinline__ void tile_ds(const float* q_s, const float* k_s,
                                        const float* v_s, const float* do_s,
                                        const float* lse_s, const float* di_s,
                                        float* ds_s, int q0, int k0, bool edge,
                                        int L, float scale, int ty, int tx) {
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
      ds_s[r * kSStride + c] = p * (dp[i][j] - dr);
    }
  }
}

// The dK/dV walk (attn_dkv_tc.cuh) over the q tiles of QT rows: from the
// diagonal tile of the block's keys on when causal, all of them when not.
// mode(i, kw0): -1 when the tile adds nothing to keys kw0 .. kw0 + 15 (all
// past L, or every query before every key), 0 when none of their pairs is
// masked, 1 when some are (past L, or above the diagonal).
template <bool kCausal, int QT>
struct FlashDkvWalk {
  static constexpr bool kFlash = true;
  int L, first, n;
  float scale;
  __device__ FlashDkvWalk(int L_, int k0, float scale_) : L(L_), scale(scale_) {
    first = kCausal ? k0 / QT : 0;
    n = (L + QT - 1) / QT - first;
  }
  __device__ int count() const { return n; }
  __device__ int q0(int i) const { return (first + i) * QT; }
  __device__ int mode(int i, int kw0) const {
    const int q = q0(i);
    if (kw0 >= L || (kCausal && q + QT - 1 < kw0)) return -1;
    return (q + QT > L || kw0 + 16 > L || (kCausal && q < kw0 + 15)) ? 1 : 0;
  }
  __device__ bool keep(int qrow, int key) const {
    return qrow < L && key < L && (!kCausal || qrow >= key);
  }
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(dl4j_attn_tc::kThreads, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int L,
                         int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.y * dl4j_attn_tc::kRows;
  const FlashDkvWalk<kCausal, dl4j_attn_tc::Dkv<D>::kQT> walk(L, k0, scale);
  dl4j_attn_tc::attn_dkv<D>(q, k, v, dout, lse, di, dk, dv, L, H, k0,
                            blockIdx.x, blockIdx.z, walk, -INFINITY, smem);
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
    tile_ds<D, kCausal>(q_s, k_s, v_s, do_s, lse_s, di_s, ds_s, q0, k0, edge, L,
                        scale, ty, tx);
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
  const dim3 grid(H, (L + dl4j_attn_tc::kRows - 1) / dl4j_attn_tc::kRows, B);
  return dl4j_attn_tc::launch(flash_bwd_dkv_kernel<D, kCausal>, grid,
                              dl4j_attn_tc::Dkv<D>::kSmem, stream, q, k, v, dout,
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

template <int D>
int dkv_attrs(bool causal, int* out) {
  using dl4j_attn_tc::Dkv;
  return causal ? dl4j_tc::attrs(flash_bwd_dkv_kernel<D, true>, Dkv<D>::kSmem, out)
                : dl4j_tc::attrs(flash_bwd_dkv_kernel<D, false>, Dkv<D>::kSmem, out);
}

bool bad_dims(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

}  // namespace

// Shared memory per block at D = 128: dK/dV 192.5 KiB, dQ 149.5 KiB.
extern "C" int dl4j_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse,
                                      const float* di, float* dk, float* dv, int B,
                                      int L, int H, int D, int causal, float scale,
                                      void* stream) {
  if (bad_dims(B, L, H) ||
      (L + dl4j_attn_tc::kRows - 1) / dl4j_attn_tc::kRows > 65535)
    return (int)cudaErrorInvalidValue;
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

// {registers, local bytes per thread, dynamic shared bytes} of the dK/dV
// kernel for head dim D into out[3].
extern "C" int dl4j_flash_bwd_dkv_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return dkv_attrs<16>(causal != 0, out);
    case 32: return dkv_attrs<32>(causal != 0, out);
    case 64: return dkv_attrs<64>(causal != 0, out);
    case 128: return dkv_attrs<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
