// Paged-KV decode attention for Hopper (sm_90a), fp32 and int8 pages.
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
// Per (row, kv-head): walk pages j = 0 .. min(nb - 1, pos[b] / block), reading
// table[b, j] here in the kernel; score = q.k / sqrt(Dh); positions past pos[b]
// take no part; f32 online softmax (running max m, sum l, accumulator acc);
// out = acc / l. int8 rows dequantize in the loop, cast then multiply in f32
// (the ops/kvquant.py contract).
//
// What bounds it on this card: the bytes of live K/V rows (plus their scales
// for int8 pages) read from device memory, once each; the arithmetic is about
// 4 * G flops per K/V element, far below the card's ratio of flops to bytes.
// The design reads each live row exactly once into shared memory, dequantized,
// shared by the G query heads of its kv-head, and never reads pages past the
// row's depth; nothing of the gathered cache is ever written back.
//
// Differences from the TPU kernel:
//  - The Pallas grid ran the page axis in order on one core and carried
//    (m, l, acc) in VMEM scratch between grid steps. CUDA blocks run in
//    parallel in no order, so one block owns one (row, kv-head) pair and its
//    page walk is a loop inside the block, with the online softmax in shared
//    memory and registers.
//  - The Pallas grid was bounded by nb for free. Here the loop bound is capped
//    by nb explicitly: rows at the overflow sentinel (pos = 1 << 30) and idle
//    slots deeper than this step's table bucket must not walk past the table.
//  - Masked offsets inside the last page are skipped, not multiplied by a zero
//    probability, so a non-finite row beyond pos can never reach the output.
//  - One block per (row, kv-head) gives B * Hkv blocks, fewer than the 132 SMs
//    at the serving shapes. A split over pages with a second reduction pass
//    (FlashDecoding) would fill the card; that is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// accumulator elements per thread: G * Dh <= kThreads * kMaxAcc
constexpr int kMaxAcc = 16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename PageT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const PageT* __restrict__ k_pages,
    const PageT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ table,
    const int32_t* __restrict__ pos, float* __restrict__ out, int H, int Hkv,
    int Dh, int block, int nb) {
  extern __shared__ float smem[];
  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  float* q_s = smem;              // [G, Dh]
  float* k_s = q_s + G * Dh;      // [block, Dh] this page's K rows, f32
  float* v_s = k_s + block * Dh;  // [block, Dh] this page's V rows, f32
  float* p_s = v_s + block * Dh;  // [G, block] scores, then probabilities
  float* m_s = p_s + G * block;   // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* a_s = l_s + G;           // [G] rescale factor of this page
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* q_row = q + ((long long)b * H + (long long)hkv * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) q_s[i] = q_row[i];
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  const int depth = pos[b];  // >= 0 by construction
  const int last = min(nb - 1, depth / block);
  const float sqrt_dh = sqrtf((float)Dh);
  const long long row_stride = (long long)Hkv * Dh;

  for (int j = 0; j <= last; ++j) {
    const long long page = table[(long long)b * nb + j];
    const int n_valid = min(block, depth - j * block + 1);
    const long long base = (page * block * Hkv + hkv) * Dh;
    __syncthreads();  // the previous page's readers are done with the tiles
    for (int i = tid; i < n_valid * Dh; i += kThreads) {
      const int t = i / Dh;
      const int d = i - t * Dh;
      const long long off = base + t * row_stride + d;
      float kv = (float)k_pages[off];
      float vv = (float)v_pages[off];
      if (kQuant) {
        const long long so = (page * block + t) * Hkv + hkv;
        kv *= k_scales[so];
        vv *= v_scales[so];
      }
      k_s[i] = kv;
      v_s[i] = vv;
    }
    __syncthreads();
    // scores: one warp per (query head, position), lanes split the head dim
    for (int w = warp; w < G * n_valid; w += kWarps) {
      const int g = w / n_valid;
      const int t = w - g * n_valid;
      float s = 0.f;
      for (int d = lane; d < Dh; d += 32) s += q_s[g * Dh + d] * k_s[t * Dh + d];
      s = warp_sum(s);
      if (lane == 0) p_s[g * block + t] = s / sqrt_dh;
    }
    __syncthreads();
    // online softmax statistics: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, p_s[g * block + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n_valid; t += 32) {
        const float e = expf(p_s[g * block + t] - m_new);
        p_s[g * block + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * v[t, d]
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < G * Dh) {
        const int g = e / Dh;
        const int d = e - g * Dh;
        float a = acc[r] * a_s[g];
        for (int t = 0; t < n_valid; ++t) a += p_s[g * block + t] * v_s[t * Dh + d];
        acc[r] = a;
      }
    }
  }
  __syncthreads();
  float* o_row = out + ((long long)b * H + (long long)hkv * G) * Dh;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < G * Dh) o_row[e] = acc[r] / l_s[e / Dh];
  }
}

template <typename PageT, bool kQuant>
int launch(const float* q, const PageT* k, const PageT* v, const float* ks,
           const float* vs, const int32_t* table, const int32_t* pos,
           float* out, int B, int H, int Hkv, int Dh, int block, int nb,
           cudaStream_t stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || nb < 1 || block < 1 || Dh < 1 ||
      (H / Hkv) * Dh > kThreads * kMaxAcc || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem =
      ((size_t)G * Dh + 2 * (size_t)block * Dh + (size_t)G * block + 3 * (size_t)G) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<PageT, kQuant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B);
  paged_decode_kernel<PageT, kQuant><<<grid, kThreads, smem, stream>>>(
      q, k, v, ks, vs, table, pos, out, H, Hkv, Dh, block, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dl4j_paged_decode_f32(const float* q, const float* k_pages,
                                     const float* v_pages, const int32_t* table,
                                     const int32_t* pos, float* out, int B, int H,
                                     int Hkv, int Dh, int block, int nb,
                                     void* stream) {
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr, table, pos,
                              out, B, H, Hkv, Dh, block, nb,
                              (cudaStream_t)stream);
}

extern "C" int dl4j_paged_decode_i8(const float* q, const int8_t* k_pages,
                                    const int8_t* v_pages, const float* k_scales,
                                    const float* v_scales, const int32_t* table,
                                    const int32_t* pos, float* out, int B, int H,
                                    int Hkv, int Dh, int block, int nb,
                                    void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, table,
                              pos, out, B, H, Hkv, Dh, block, nb,
                              (cudaStream_t)stream);
}

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
