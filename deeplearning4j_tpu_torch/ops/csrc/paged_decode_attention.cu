// Paged-KV decode attention for Hopper (sm_90a), fp32 and int8 pages, split
// over pages (FlashDecoding): a page walk, then a combine.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_paged_decode_call` (:865), bodies `_paged_fp_kernel` (:850) and
// `_paged_int8_kernel` (:857) over `_paged_decode_body` (:783). It computes
// what `_xla_paged_reference` (:927) computes for one decode token per row:
//
//   q      [B, 1, H, Dh]          f32, query head h = hkv * G + g, G = H / Hkv
//   pages  [P, block, Hkv, Dh]    f32, or int8 with f32 scales [P, block, Hkv]
//   table  [B, nb]                int32 logical block -> page
//   pos    [B]                    int32, row b attends over positions [0, pos[b]]
//   out    [B, 1, H, Dh]          f32
//
// Per (row, kv-head): pages j = 0 .. last = min(nb - 1, pos[b] / block),
// table[b, j] read here in the kernel; score = q.k / sqrt(Dh); positions past
// pos[b] take no part; an f32 online softmax (running max m, sum l,
// accumulator acc); out = acc / l. int8 rows dequantize in the loop, cast
// then multiply in f32 (the ops/kvquant.py contract).
//
// Kernel 1, paged_decode_kernel, grid (S splits, Hkv, B), 4 warps a block:
// split s walks the contiguous pages [s P, min((s + 1) P, last + 1)), P =
// ceil(nb / S), S from the wrapper (`cuda_kernels._paged_splits`: about two
// blocks per SM, from the shapes alone, so the same shapes give the same
// bits). Inside a block, work item (g, c) is query head g over the split's
// pages c, c + C, c + 2C, ..., C = max(1, 4 / G) page classes a head, and the
// 4 warps take the G C items in turn: one warp per page of a head, with no
// barrier in the walk. A warp's lanes run over head dims (d = lane + 32 i);
// it loads the K and V values of up to 32 / ceil(Dh / 32) positions of a
// page into registers at once (all in flight together, each live row read
// once, 128 coalesced bytes a load for f32), takes each position's q.k with
// a warp xor-sum (every lane then holds every score, the same bits), and
// updates m, l and its dims of acc without more shuffles. After one barrier
// the block merges its items per query head in a fixed order and writes
// (acc, m, l) of the split to an f32 workspace [B, Hkv, S, G, Dh + 2]; a
// split with no live page writes m = -inf, l = 0. With S = 1 it writes
// acc / l to out instead, and kernel 2 is not launched.
//
// Kernel 2, paged_decode_combine_kernel: one warp per (row, query head)
// walks the S partials in order: M = max m_s, out = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s over the splits with l_s > 0 (so no -inf - -inf
// NaN). Split 0 always holds page 0, which is live (pos >= 0), so the sum is
// positive. Every element is written once in a fixed order: no atomics, the
// same bits on every launch. expf, not __expf.
//
// What bounds it on this card: the bytes of live K/V rows (plus their scales
// for int8 pages) read from device memory, once each; the arithmetic is about
// 4 * G flops per K/V element, far below the card's ratio of flops to bytes.
// Nothing of the gathered cache is written back; the workspace is S G (Dh +
// 2) floats per (row, kv-head).
//
// Differences from the TPU kernel:
//  - The Pallas grid ran the page axis in order on one core and carried
//    (m, l, acc) in VMEM scratch between grid steps. CUDA blocks run in
//    parallel in no order, so the page axis is split into S blocks and
//    their partial softmax states meet in a second pass (kernel 2), in a
//    fixed order; the sums run in another order than on the TPU.
//  - The Pallas grid was bounded by nb for free. Here the loop bound is capped
//    by nb explicitly: rows at the overflow sentinel (pos = 1 << 30) and idle
//    slots deeper than this step's table bucket must not walk past the table.
//  - Masked offsets inside the last page are skipped, not multiplied by a zero
//    probability, so a non-finite row beyond pos can never reach the output.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;  // head dims: at most 8 per lane

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NL = ceil(Dh / 32) head dims per lane (1, 2, 4 or 8); positions loaded
// together: 32 / NL, 64 registers of K and V values a lane.
template <typename PageT, bool kQuant, int NL>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const PageT* __restrict__ k_pages,
    const PageT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ table,
    const int32_t* __restrict__ pos, float* __restrict__ out,
    float* __restrict__ ws, int H, int Hkv, int Dh, int block, int nb, int S) {
  constexpr int kChunk = 32 / NL;
  extern __shared__ float part[];  // [G C][Dh + 2]: acc, m, l of each item
  const int s = blockIdx.x;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int C = max(1, kWarps / G);
  const int W = Dh + 2;
  const int lane = threadIdx.x & 31;

  const int depth = pos[b];  // >= 0 by construction
  const int last = min(nb - 1, depth / block);
  const int P = (nb + S - 1) / S;
  const int j0 = s * P;
  const int j1 = min(j0 + P, last + 1);
  const float sqrt_dh = sqrtf((float)Dh);
  const long long rs = (long long)Hkv * Dh;  // page row stride
  const float* q_row = q + ((long long)b * H + (long long)hkv * G) * Dh;

  for (int item = threadIdx.x >> 5; item < G * C; item += kWarps) {
    const int g = item / C;
    float qr[NL], acc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int d = lane + 32 * i;
      qr[i] = d < Dh ? q_row[g * Dh + d] : 0.f;
      acc[i] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j = j0 + item % C; j < j1; j += C) {
      const long long page = table[(long long)b * nb + j];
      const int n_valid = min(block, depth - j * block + 1);
      const long long base = (page * block * Hkv + hkv) * Dh;
      for (int t0 = 0; t0 < n_valid; t0 += kChunk) {
        float kr[kChunk][NL], vr[kChunk][NL];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const bool in = t0 + u < n_valid;
          float ks = 1.f, vs = 1.f;
          if (kQuant && in) {
            const long long so = (page * block + t0 + u) * Hkv + hkv;
            ks = k_scales[so];
            vs = v_scales[so];
          }
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            const int d = lane + 32 * i;
            const long long off = base + (t0 + u) * rs + d;
            const bool ld = in && d < Dh;
            // cast, then multiply by the row's scale (kvquant's order)
            kr[u][i] = ld ? (float)k_pages[off] * ks : 0.f;
            vr[u][i] = ld ? (float)v_pages[off] * vs : 0.f;
          }
        }
        float sc[kChunk];
        float mx = m;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (t0 + u >= n_valid) break;  // warp-uniform
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < NL; ++i) dot = fmaf(qr[i], kr[u][i], dot);
          sc[u] = warp_sum(dot) / sqrt_dh;
          mx = fmaxf(mx, sc[u]);
        }
        const float alpha = expf(m - mx);  // 0 on the first chunk
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) acc[i] *= alpha;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (t0 + u >= n_valid) break;
          const float p = expf(sc[u] - mx);
          sum += p;
#pragma unroll
          for (int i = 0; i < NL; ++i) acc[i] = fmaf(p, vr[u][i], acc[i]);
        }
        l = l * alpha + sum;
        m = mx;
      }
    }
    float* pr = part + item * W;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) pr[d] = acc[i];
    }
    if (lane == 0) {
      pr[Dh] = m;
      pr[Dh + 1] = l;
    }
  }
  __syncthreads();

  // merge the block's items per query head, page class 0 first
  for (int e = threadIdx.x; e < G * W; e += kThreads) {
    const int g = e / W;
    const int d = e - g * W;
    const float* pg = part + g * C * W;
    float M = -INFINITY;
    for (int c = 0; c < C; ++c) M = fmaxf(M, pg[c * W + Dh]);
    float a = 0.f, lsum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float lc = pg[c * W + Dh + 1];
      if (lc > 0.f) {
        const float w = expf(pg[c * W + Dh] - M);
        lsum += w * lc;
        if (d < Dh) a += w * pg[c * W + d];
      }
    }
    if (S == 1) {
      if (d < Dh) out[((long long)b * H + (long long)hkv * G + g) * Dh + d] = a / lsum;
    } else {
      ws[(((long long)b * Hkv + hkv) * S + s) * G * W + (long long)g * W + d] =
          d < Dh ? a : (d == Dh ? M : lsum);
    }
  }
}

// One warp per (row, query head): the S partials of kernel 1, in order.
template <int NL>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ ws, float* __restrict__ out, int B, int H,
    int Hkv, int Dh, int S) {
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * H + h
  if (pair >= B * H) return;
  const int lane = threadIdx.x & 31;
  const int b = pair / H;
  const int h = pair - b * H;
  const int G = H / Hkv;
  const int W = Dh + 2;
  const long long step = (long long)G * W;  // floats from one split to the next
  const float* p0 = ws + ((long long)b * Hkv + h / G) * S * step + (h % G) * W;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, p0[s * step + Dh]);
  float acc[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) acc[i] = 0.f;
  float lsum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ps = p0 + s * step;
    const float ls = ps[Dh + 1];
    if (!(ls > 0.f)) continue;  // a split with no live page
    const float w = expf(ps[Dh] - M);
    lsum += w * ls;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) acc[i] += w * ps[d];
    }
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) out[(long long)pair * Dh + d] = acc[i] / lsum;
  }
}

// shared memory of one page-walk block: (acc, m, l) of its G C work items
size_t walk_smem(int G, int Dh) {
  return (size_t)G * (size_t)max(1, kWarps / G) * (Dh + 2) * sizeof(float);
}

template <typename PageT, bool kQuant, int NL>
int run(const float* q, const PageT* k, const PageT* v, const float* ks,
        const float* vs, const int32_t* table, const int32_t* pos, float* out,
        float* ws, int B, int H, int Hkv, int Dh, int block, int nb, int S,
        cudaStream_t stream) {
  const size_t smem = walk_smem(H / Hkv, Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<PageT, kQuant, NL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<PageT, kQuant, NL><<<dim3(S, Hkv, B), kThreads, smem,
                                           stream>>>(
      q, k, v, ks, vs, table, pos, out, ws, H, Hkv, Dh, block, nb, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const int blocks = (B * H + kWarps - 1) / kWarps;
  paged_decode_combine_kernel<NL><<<blocks, kThreads, 0, stream>>>(
      ws, out, B, H, Hkv, Dh, S);
  return (int)cudaGetLastError();
}

template <typename PageT, bool kQuant>
int launch(const float* q, const PageT* k, const PageT* v, const float* ks,
           const float* vs, const int32_t* table, const int32_t* pos,
           float* out, float* ws, int B, int H, int Hkv, int Dh, int block,
           int nb, int S, cudaStream_t stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || nb < 1 || block < 1 || Dh < 1 ||
      Dh > kMaxDh || S < 1 || S > nb || B > 65535 || Hkv > 65535 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nl = (Dh + 31) / 32;
#define DL4J_PAGED(NL)                                                      \
  run<PageT, kQuant, NL>(q, k, v, ks, vs, table, pos, out, ws, B, H, Hkv,   \
                         Dh, block, nb, S, stream)
  if (nl <= 1) return DL4J_PAGED(1);
  if (nl <= 2) return DL4J_PAGED(2);
  if (nl <= 4) return DL4J_PAGED(4);
  return DL4J_PAGED(8);
#undef DL4J_PAGED
}

template <typename Kernel>
int kernel_attrs(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

template <int NL>
int attrs_nl(bool quant, bool combine, int G, int Dh, int* out) {
  if (combine) return kernel_attrs(paged_decode_combine_kernel<NL>, 0, out);
  const size_t smem = walk_smem(G, Dh);
  return quant ? kernel_attrs(paged_decode_kernel<int8_t, true, NL>, smem, out)
               : kernel_attrs(paged_decode_kernel<float, false, NL>, smem, out);
}

}  // namespace

// ws: an f32 workspace of B Hkv S G (Dh + 2) floats (unused when S = 1).
extern "C" int dl4j_paged_decode_f32(const float* q, const float* k_pages,
                                     const float* v_pages, const int32_t* table,
                                     const int32_t* pos, float* out, float* ws,
                                     int B, int H, int Hkv, int Dh, int block,
                                     int nb, int S, void* stream) {
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr, table, pos,
                              out, ws, B, H, Hkv, Dh, block, nb, S,
                              (cudaStream_t)stream);
}

extern "C" int dl4j_paged_decode_i8(const float* q, const int8_t* k_pages,
                                    const int8_t* v_pages, const float* k_scales,
                                    const float* v_scales, const int32_t* table,
                                    const int32_t* pos, float* out, float* ws,
                                    int B, int H, int Hkv, int Dh, int block,
                                    int nb, int S, void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, table,
                              pos, out, ws, B, H, Hkv, Dh, block, nb, S,
                              (cudaStream_t)stream);
}

// {registers, local bytes per thread, dynamic shared bytes} of the page walk
// (int8 pages when quant) or, with combine, of the combine, as G query heads
// per kv-head at head dim Dh launch them, into out[3].
extern "C" int dl4j_paged_decode_attrs(int quant, int combine, int G, int Dh,
                                       int* out) {
  if (G < 1 || Dh < 1 || Dh > kMaxDh) return (int)cudaErrorInvalidValue;
  const int nl = (Dh + 31) / 32;
  const bool q = quant != 0, c = combine != 0;
  if (nl <= 1) return attrs_nl<1>(q, c, G, Dh, out);
  if (nl <= 2) return attrs_nl<2>(q, c, G, Dh, out);
  if (nl <= 4) return attrs_nl<4>(q, c, G, Dh, out);
  return attrs_nl<8>(q, c, G, Dh, out);
}

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
