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
// Both kernels run on the tensor cores in 3xTF32, one block of 8 warps per
// (head, 128 rows of the launch axis, batch row), the longest causal walk
// first across all heads (grid (H, blocks, B)).
//
// Design of the dK/dV kernel (attn_dkv_tc.cuh): key block 0 first. k and v
// of the block's keys stay in shared tiles; q, dO, lse and di stream through
// a 2-stage cp.async ring in tiles of 32 query rows at D = 128 (64 at D <=
// 64), from the diagonal on when causal (all of them when not); p^T and ds^T
// in registers as the A operands of p^T dO and ds^T q; dk takes the scale at
// the store.
//
// Design of the dQ kernel (attn_dq_tc.cuh): the last query block first. q
// and dO of the block's rows stay in shared tiles; k and v stream through the
// ring in tiles of 32 keys at D = 128 (64 at D <= 64), up to the block's last
// row when causal (all of them when not); s, dp and ds in registers, ds as
// the A operand of ds k; the scale on s, and on dq at the store.
//
// Rows and keys at or past L are masked (p = 0), zero-filled and never read,
// so any L >= 1 runs. Each output element is written once, after a loop in a
// fixed order: no atomics, so the gradients are the same bits on every
// launch. expf, not __expf: the gradient gates are 1e-5 of the largest plain
// gradient.
//
// What bounds them on this card: the operations, 8 D per kept pair in dK/dV
// (s recomputed, dO v^T, p^T dO, ds^T q) and 6 D in dQ (s, dO v^T, ds k).
// The 3xTF32 split runs three tf32 products per product at 495 TFLOP/s:
// least times of 0.8331 ms (dK/dV) and 0.6248 ms (dQ) at [1, 8192, 4, 128]
// causal (2.0516 and 1.5387 ms against f32 outside the tensor cores, 67
// TFLOP/s).
//
// bf16 (dl4j_flash_bwd_dkv_bf16, dl4j_flash_bwd_dq_bf16): bf16 q, k, v, dO
// and outputs, f32 lse and di. As the library rounds: ds takes the scale in
// f32, then p and ds go to bf16 before p^T dO, ds^T q and ds k
// (flash_attention.py :900, :918, :1258). Both run on Hopper cores with
// the f32 kernels' grid: dK/dV on attn_dkv_bf16.cuh (key block 0 first; q
// and dO in 64-row tiles by TMA through an mbarrier ring, two warpgroups
// of 64 keys on wgmma), dQ on attn_dq_bf16.cuh (the last query block
// first; k and v in 64-key tiles by TMA through an mbarrier ring, two
// warpgroups of 64 query rows on wgmma, walked by FlashDqWgWalk). Bounds
// at 989 TFLOP/s: 0.1390 ms (dK/dV) and 0.1042 ms (dQ) at [1, 8192, 4,
// 128] causal.
#include <cuda_runtime.h>
#include <math.h>

#include "attn_dkv_bf16.cuh"
#include "attn_dkv_tc.cuh"
#include "attn_dq_bf16.cuh"
#include "attn_dq_tc.cuh"
#include "flash_common.cuh"  // dl4j_cuda_error_string

namespace {

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

// The dQ walk (attn_dq_tc.cuh) over the key tiles of KT keys: the forward's
// FlashWalk with the dQ core's tile. Causal: tiles up to the block's last
// row, q0 + 127; full: all of them. mode(i, w0): -1 when the tile adds
// nothing to rows w0 .. w0 + 15 (all past L, or every key after every row),
// 0 when none of their pairs is masked, 1 when some are (keys past L, or
// above the diagonal). Rows past L are not masked: their q and dO are
// zero-filled and their lse and di read as 0, so their ds is 0, and they are
// never stored.
template <bool kCausal, int KT>
struct FlashDqWalk {
  static constexpr bool kFlash = true;
  int L, n;
  float scale;
  __device__ FlashDqWalk(int L_, int q0, float scale_) : L(L_), scale(scale_) {
    const int all = (L + KT - 1) / KT;
    n = kCausal ? min(all, (q0 + dl4j_attn_tc::kRows + KT - 1) / KT) : all;
  }
  __device__ int count() const { return n; }
  __device__ int key0(int i) const { return i * KT; }
  __device__ int mode(int i, int w0) const {
    const int k0 = i * KT;
    if (w0 >= L || (kCausal && k0 > w0 + 15)) return -1;
    return (k0 + KT > L || (kCausal && k0 + KT - 1 > w0)) ? 1 : 0;
  }
  __device__ bool keep(int row, int col) const {
    return col < L && (!kCausal || col <= row);
  }
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(dl4j_attn_tc::kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, int L, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (L + dl4j_attn_tc::kRows - 1) / dl4j_attn_tc::kRows;
  const int q0 = (nq - 1 - (int)blockIdx.y) * dl4j_attn_tc::kRows;
  const FlashDqWalk<kCausal, dl4j_attn_tc::Dq<D>::kKeys> walk(L, q0, scale);
  dl4j_attn_tc::attn_dq<D>(q, k, v, dout, lse, di, dq, L, H, q0, blockIdx.x,
                           blockIdx.z, walk, -INFINITY, smem);
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
  const dim3 grid(H, (L + dl4j_attn_tc::kRows - 1) / dl4j_attn_tc::kRows, B);
  return dl4j_attn_tc::launch(flash_bwd_dq_kernel<D, kCausal>, grid,
                              dl4j_attn_tc::Dq<D>::kSmem, stream, q, k, v, dout,
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

template <int D>
int dq_attrs(bool causal, int* out) {
  using dl4j_attn_tc::Dq;
  return causal ? dl4j_tc::attrs(flash_bwd_dq_kernel<D, true>, Dq<D>::kSmem, out)
                : dl4j_tc::attrs(flash_bwd_dq_kernel<D, false>, Dq<D>::kSmem, out);
}

namespace dkv16 = dl4j_attn_dkv;

// The walk of the Hopper bf16 dK/dV core (attn_dkv_bf16.cuh) over the q
// tiles of kQT rows: from the diagonal tile of the block's keys on when
// causal, all of them when not. mode(i, kw0) for the 64 keys kw0 .. kw0 + 63
// of a consumer warpgroup: -1 when the tile adds nothing to them (all past
// L, or every query before every key), 1 when the causal mask cuts some of
// their pairs, 0 otherwise. Query rows past L need no mask: the core gives
// them lse +inf and di 0, so p = ds = 0; keys past L are never stored.
template <bool kCausal>
struct FlashDkvWgWalk {
  static constexpr bool kFlash = true;
  int L, first, n;
  float scale;
  __device__ FlashDkvWgWalk(int L_, int k0, float scale_)
      : L(L_), scale(scale_) {
    first = kCausal ? k0 / dkv16::kQT : 0;
    n = (L + dkv16::kQT - 1) / dkv16::kQT - first;
  }
  __device__ int count() const { return n; }
  __device__ int q0(int i) const { return (first + i) * dkv16::kQT; }
  __device__ int mode(int i, int kw0) const {
    const int q = q0(i);
    if (kw0 >= L || (kCausal && q + dkv16::kQT - 1 < kw0)) return -1;
    return (kCausal && q < kw0 + dkv16::kWgKeys - 1) ? 1 : 0;
  }
  __device__ bool keep(int qrow, int key) const {
    return !kCausal || qrow >= key;
  }
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(dkv16::kThreads, 1)
    flash_bwd_dkv_bf16_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
        const float* __restrict__ di, uint16_t* __restrict__ dk,
        uint16_t* __restrict__ dv, int L, int H, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int k0 = blockIdx.y * dkv16::kKeys;
  const FlashDkvWgWalk<kCausal> walk(L, k0, scale);
  dkv16::attn_dkv_ws<D>(&tq, &tdo, &tk, &tv, lse, di, dk, dv, L, H, k0,
                        blockIdx.x, blockIdx.z, walk, -INFINITY,
                        scale * dkv16::kLog2e, smem_w);
}

namespace dq16 = dl4j_attn_dq;

// The walk of the Hopper bf16 dQ core (attn_dq_bf16.cuh) over the key
// tiles of kKT keys: up to the block's last row, q0 + 127, when causal, all
// of them when not. mode(i, w0) for the 64 rows w0 .. w0 + 63 of a
// warpgroup: -1 when the tile adds nothing to them (all past L, or every
// key after every row), 1 when some of their pairs are masked (keys past
// L, or above the diagonal), 0 otherwise. Rows past L need no mask: the
// core gives them lse +inf and di 0, so p = ds = 0, and never stores them.
template <bool kCausal>
struct FlashDqWgWalk {
  static constexpr bool kFlash = true;
  int L, n;
  float scale;
  __device__ FlashDqWgWalk(int L_, int q0, float scale_)
      : L(L_), scale(scale_) {
    const int all = (L + dq16::kKT - 1) / dq16::kKT;
    n = kCausal ? min(all, (q0 + dq16::kRows) / dq16::kKT) : all;
  }
  __device__ int count() const { return n; }
  __device__ int key0(int i) const { return i * dq16::kKT; }
  __device__ int mode(int i, int w0) const {
    const int k0 = i * dq16::kKT;
    if (w0 >= L || (kCausal && k0 > w0 + dq16::kWgRows - 1)) return -1;
    return (k0 + dq16::kKT > L || (kCausal && k0 + dq16::kKT - 1 > w0)) ? 1
                                                                        : 0;
  }
  __device__ bool keep(int row, int col) const {
    return col < L && (!kCausal || col <= row);
  }
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(dq16::kThreads, 1)
    flash_bwd_dq_bf16_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
        const float* __restrict__ di, uint16_t* __restrict__ dq, int L, int H,
        float scale) {
  extern __shared__ __align__(1024) uint8_t smem_w[];
  const int nq = (L + dq16::kRows - 1) / dq16::kRows;
  const int q0 = (nq - 1 - (int)blockIdx.y) * dq16::kRows;
  const FlashDqWgWalk<kCausal> walk(L, q0, scale);
  dq16::attn_dq_ws<D>(&tq, &tdo, &tk, &tv, lse, di, dq, L, H, q0, blockIdx.x,
                      blockIdx.z, walk, -INFINITY, scale * dq16::kLog2e,
                      smem_w);
}

template <int D>
int dkv_bf16(bool causal, const uint16_t* q, const uint16_t* k,
             const uint16_t* v, const uint16_t* dout, const float* lse,
             const float* di, uint16_t* dk, uint16_t* dv, int B, int L, int H,
             float scale, cudaStream_t s) {
  static_assert(dkv16::kKeys == dl4j_attn_tc::kRows, "the f32 kernels' grid");
  const dim3 grid(H, (L + dkv16::kKeys - 1) / dkv16::kKeys, B);
  return causal
             ? dkv16::launch_dkv<D>(flash_bwd_dkv_bf16_kernel<D, true>, grid,
                                    s, q, k, v, dout, B, L, H, lse, di, dk, dv,
                                    L, H, scale)
             : dkv16::launch_dkv<D>(flash_bwd_dkv_bf16_kernel<D, false>, grid,
                                    s, q, k, v, dout, B, L, H, lse, di, dk, dv,
                                    L, H, scale);
}

template <int D>
int dq_bf16(bool causal, const uint16_t* q, const uint16_t* k,
            const uint16_t* v, const uint16_t* dout, const float* lse,
            const float* di, uint16_t* dq_, int B, int L, int H, float scale,
            cudaStream_t s) {
  static_assert(dq16::kRows == dl4j_attn_tc::kRows, "the f32 kernels' grid");
  const dim3 grid(H, (L + dq16::kRows - 1) / dq16::kRows, B);
  return causal
             ? dq16::launch_dq<D>(flash_bwd_dq_bf16_kernel<D, true>, grid, s,
                                  q, k, v, dout, B, L, H, lse, di, dq_, L, H,
                                  scale)
             : dq16::launch_dq<D>(flash_bwd_dq_bf16_kernel<D, false>, grid, s,
                                  q, k, v, dout, B, L, H, lse, di, dq_, L, H,
                                  scale);
}

template <int D>
int dkv_bf16_attrs(bool causal, int* out) {
  constexpr size_t smem = dkv16::Dkv<D>::kSmem;
  return causal ? dl4j_tc::attrs(flash_bwd_dkv_bf16_kernel<D, true>, smem, out)
                : dl4j_tc::attrs(flash_bwd_dkv_bf16_kernel<D, false>, smem, out);
}

template <int D>
int dq_bf16_attrs(bool causal, int* out) {
  constexpr size_t smem = dq16::Dq<D>::kSmem;
  return causal ? dl4j_tc::attrs(flash_bwd_dq_bf16_kernel<D, true>, smem, out)
                : dl4j_tc::attrs(flash_bwd_dq_bf16_kernel<D, false>, smem, out);
}

bool bad_dims(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535 ||
         (L + dl4j_attn_tc::kRows - 1) / dl4j_attn_tc::kRows > 65535;
}

}  // namespace

// Shared memory per block at D = 128: dK/dV 192.5 KiB, dQ 192 KiB (129 KiB
// and 128 KiB at D = 64).
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

// {registers, local bytes per thread, dynamic shared bytes} of the dQ kernel
// for head dim D into out[3].
extern "C" int dl4j_flash_bwd_dq_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return dq_attrs<16>(causal != 0, out);
    case 32: return dq_attrs<32>(causal != 0, out);
    case 64: return dq_attrs<64>(causal != 0, out);
    case 128: return dq_attrs<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q, k, v, dO, dk, dv (raw bf16 bits), f32 lse and di. Shared memory per
// block at D = 128: dK/dV 163 KiB (attn_dkv_bf16.cuh), dQ 225 KiB
// (attn_dq_bf16.cuh).
extern "C" int dl4j_flash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k,
                                       const uint16_t* v, const uint16_t* dout,
                                       const float* lse, const float* di,
                                       uint16_t* dk, uint16_t* dv, int B, int L,
                                       int H, int D, int causal, float scale,
                                       void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  switch (D) {
    case 16: return dkv_bf16<16>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 32: return dkv_bf16<32>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 64: return dkv_bf16<64>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    case 128: return dkv_bf16<128>(c, q, k, v, dout, lse, di, dk, dv, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dl4j_flash_bwd_dq_bf16(const uint16_t* q, const uint16_t* k,
                                      const uint16_t* v, const uint16_t* dout,
                                      const float* lse, const float* di,
                                      uint16_t* dq_out, int B, int L, int H,
                                      int D, int causal, float scale,
                                      void* stream) {
  if (bad_dims(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  switch (D) {
    case 16: return dq_bf16<16>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 32: return dq_bf16<32>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 64: return dq_bf16<64>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    case 128: return dq_bf16<128>(c, q, k, v, dout, lse, di, dq_out, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16
// dK/dV kernel for head dim D into out[3].
extern "C" int dl4j_flash_bwd_dkv_bf16_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return dkv_bf16_attrs<16>(causal != 0, out);
    case 32: return dkv_bf16_attrs<32>(causal != 0, out);
    case 64: return dkv_bf16_attrs<64>(causal != 0, out);
    case 128: return dkv_bf16_attrs<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {registers, local bytes per thread, dynamic shared bytes} of the bf16 dQ
// kernel for head dim D into out[3].
extern "C" int dl4j_flash_bwd_dq_bf16_attrs(int D, int causal, int* out) {
  switch (D) {
    case 16: return dq_bf16_attrs<16>(causal != 0, out);
    case 32: return dq_bf16_attrs<32>(causal != 0, out);
    case 64: return dq_bf16_attrs<64>(causal != 0, out);
    case 128: return dq_bf16_attrs<128>(causal != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shape of the bf16 dK/dV core (attn_dkv_bf16.cuh, under this file's
// and splash_attention_bwd.cu's dK/dV kernels) into out[4]: threads per
// block (two warpgroups), the ring's stages, keys per block and query rows
// per q / dO tile.
extern "C" int dl4j_attn_dkv_bf16_roles(int* out) {
  out[0] = dkv16::kThreads;
  out[1] = dkv16::kStages;
  out[2] = dkv16::kKeys;
  out[3] = dkv16::kQT;
  return 0;
}

// The shape of the bf16 dQ core (attn_dq_bf16.cuh, under this file's and
// splash_attention_bwd.cu's dQ kernels) into out[4]: threads per block (two
// warpgroups), the ring's stages, query rows per block and keys per k / v
// tile.
extern "C" int dl4j_attn_dq_bf16_roles(int* out) {
  out[0] = dq16::kThreads;
  out[1] = dq16::kStages;
  out[2] = dq16::kRows;
  out[3] = dq16::kKT;
  return 0;
}
