// The bf16 core of the fused NHWC conv2d + bias + activation forward
// (conv2d_bias_act.cu), for Hopper (sm_90a): x, w, b, out and pre in bf16,
// the products on the tensor cores as bf16 mma.sync m16n8k16 with f32
// accumulators, the bias and the activation in f32, and one rounding to
// bf16 at the store.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_conv2d_bias_act_forward` (:119, pallas_call :144, body `_conv_kernel`
// :92) at bf16: its dot takes `preferred_element_type=f32` (:102-103), the
// bias and activation run on the f32 block (:116), and the output is cast to
// x.dtype once (:158). Products of two bf16 values are exact in f32, so this
// kernel and the plain version (cuda_kernels.conv2d_bias_act_ref at bf16)
// differ only in the order of the f32 sums and, at worst, in the one
// rounding that follows.
//
// Layout and geometry as the f32 kernel's (conv2d_bias_act.cu): x [B, H, W,
// C], w [KH, KW, C, OC] read as the [K, OC] matrix, K = KH * KW * C in (ki,
// kj, c) order, out and pre [B, OH, OW, OC] read as [M, OC]; the wrapper
// gives the stride and the top/left pads.
//
// Design: the f32 kernel's implicit GEMM with bf16 tiles. A block of 8 warps
// owns a 128 x 64 tile of [M, OC], two blocks per SM, and walks K in slices
// of 32 (two 16-deep k-steps) through a 3-stage ring in shared memory, one
// barrier per slice:
//   - A, the [128 x 32] slice of the virtual im2col matrix, straight from x:
//     16-byte cp.async chunks of 8 channels of one (ki, kj) tap when C % 8
//     == 0 and x is 16-byte aligned (AlexNet's conv2 and conv3); 4-byte
//     cp.async pairs when C is even (LeNet's conv2, C = 20); else (C = 3 at
//     AlexNet's conv1, K = 27) one 2-byte load and shared store per element,
//     as cp.async copies 4 bytes at least. Padded positions and rows or k
//     past M and K are zeros, so K's tail up to the 16-deep k-step adds
//     nothing.
//   - B, the [32 x 64] slice of w, stored [k][n]: 16-byte chunks when OC % 8
//     == 0 and w is aligned, else one element at a time (LeNet's OC = 50),
//     zeros past K and OC.
//   - Warp (wm, wn), 4 x 2 of them, owns 32 rows (two m-tiles) x 32 columns
//     (four n-tiles). Per k-step, one ldmatrix.x4 per m-tile gives its A
//     fragment, one ldmatrix.x4.trans per two n-tiles their B fragments
//     (tc_common.cuh), and eight mma.
//   - Swizzles (at_bf16): A rows of 32 bf16 at chunk c ^ ((r / 2) & 3), B
//     rows of 64 at c ^ (r & 7): the eight rows of every ldmatrix matrix fall
//     in distinct 16-byte slots, no bank conflicts and no padding.
//   - Accuracy: each K slice sums in fresh accumulators that join the
//     running f32 sum in one rounded add, as the f32 kernel does (the tensor
//     cores may truncate as they accumulate); K reaches 1152 at conv3.
//   - Epilogue: z = acc + bias and act(z) in f32 (activations.cuh), both
//     rounded to bf16 (to nearest even, cvt.rn) as they are stored, in pairs
//     of adjacent columns where OC is even.
// No atomics and no split-K: a launch gives the same bits every time.
//
// What bounds it on this card: at AlexNet's conv2 and conv3 (B = 512) the
// operations, 2 M OC K = 19.33 GFLOP each, 0.0195 ms at 989 TFLOP/s (bf16
// dense); conv1 (K = 27) by its bytes, nearly all of them its 67 MB bf16
// output (0.020 ms at 3.35 TB/s). Why mma.sync and not wgmma: it keeps the
// f32 kernel's block, ring and im2col addressing; wgmma with TMA needs the
// im2col tile as a TMA box (or a gather warp) and is later work.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"
#include "tc_common.cuh"

namespace dl4j_conv_bf16 {

using namespace dl4j_tc;

constexpr int kBM = 128;  // output rows (m) per block
constexpr int kBN = 64;   // output columns (oc) per block
constexpr int kBK = 32;   // K per slice: two 16-deep k-steps
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMT = 2;                 // m-tiles of 16 rows per warp
constexpr int kWM = kBM / (16 * kMT);  // warps along m: 4 (and 2 along n)
constexpr int kA = kBM * kBK;          // bf16 of an A slice
constexpr int kB = kBK * kBN;          // bf16 of a B slice
constexpr size_t kSmem = (size_t)kStages * (kA + kB) * sizeof(uint16_t);

struct Geom {
  long long M;
  int K, B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act;
};

// bf16 bits of v, rounded to nearest even
__device__ __forceinline__ uint16_t to_bf16(float v) {
  return (uint16_t)(pack_bf16(v, 0.f) & 0xffffu);
}

__device__ __forceinline__ float from_bf16(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// kAVec: channels per A copy (8: 16-byte cp.async, 2: 4-byte, 1: plain
// 2-byte loads); kVecB: 16-byte B copies
template <int kAVec, bool kVecB>
__global__ void __launch_bounds__(kThreads, 2)
    conv2d_bias_act_bf16_kernel(const uint16_t* __restrict__ x,
                                const uint16_t* __restrict__ w,
                                const uint16_t* __restrict__ bias,
                                uint16_t* __restrict__ out,
                                uint16_t* __restrict__ pre, Geom g) {
  extern __shared__ __align__(16) uint16_t smem_bf16[];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int slices = (g.K + kBK - 1) / kBK;

  // this thread copies chunk ac (k = 8 ac ... 8 ac + 7 of the slice) of A's
  // rows ar + 64 j
  const int ac = tid & 3;
  const int ar = tid >> 2;
  long long a_base[2];   // offset of x[n, 0, 0, 0]
  int a_ih[2], a_iw[2];  // top-left input position of the window
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long m = m0 + ar + 64 * j;
    const long long mm = m < g.M ? m : 0;
    const int ow = (int)(mm % g.OW);
    const long long q = mm / g.OW;
    const int oh = (int)(q % g.OH);
    a_base[j] = (q / g.OH) * g.H * g.W * g.C;
    a_ih[j] = m < g.M ? oh * g.SH - g.PT : -(1 << 30);  // never in range
    a_iw[j] = ow * g.SW - g.PL;
  }

  auto fetch = [&](int sl) {
    uint16_t* As = smem_bf16 + (sl % kStages) * (kA + kB);
    uint16_t* Bs = As + kA;
    const int kb = sl * kBK;
#pragma unroll
    for (int e = 0; e < 8; e += kAVec) {
      const int k = kb + 8 * ac + e;
      const int tap = k / g.C;
      const int c = k - tap * g.C;
      const int ki = tap / g.KW;
      const int kj = tap - ki * g.KW;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ih = a_ih[j] + ki;
        const int iw = a_iw[j] + kj;
        const bool in = k < g.K && (unsigned)ih < (unsigned)g.H &&
                        (unsigned)iw < (unsigned)g.W;
        const uint16_t* src =
            in ? x + a_base[j] + ((long long)ih * g.W + iw) * g.C + c : x;
        uint16_t* dst = As + at_bf16<kBK>(ar + 64 * j, ac) + e;
        if constexpr (kAVec == 8) {
          cp_async16_bf16(dst, src, in);
        } else if constexpr (kAVec == 2) {
          cp_async4(reinterpret_cast<float*>(dst),
                    reinterpret_cast<const float*>(src), in);
        } else {
          *dst = in ? __ldg(src) : (uint16_t)0;
        }
      }
    }
    // B: one 16-byte chunk (8 columns) of one k row per thread
    const int kr = tid >> 3;
    const int cc = tid & 7;
    const int k = kb + kr;
    const int n = n0 + 8 * cc;
    uint16_t* dst = Bs + at_bf16<kBN>(kr, cc);
    if constexpr (kVecB) {
      const bool in = k < g.K && n < g.OC;
      cp_async16_bf16(dst, in ? w + (long long)k * g.OC + n : w, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = k < g.K && n + e < g.OC;
        dst[e] = in ? __ldg(w + (long long)k * g.OC + n + e) : (uint16_t)0;
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int l8 = (lane >> 3) & 1;
  const int l16 = lane >> 4;
  const int wm = (warp % kWM) * 16 * kMT;  // the warp's first tile row
  const int wn = (warp / kWM) * 32;        // and first tile column

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][p][e] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) fetch(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice sl landed
    __syncthreads();  // everyone's; and everyone is done with slice sl - 1
    if (sl + kStages - 1 < slices) fetch(sl + kStages - 1);
    cp_async_commit();
    const uint16_t* As = smem_bf16 + (sl % kStages) * (kA + kB);
    const uint16_t* Bs = As + kA;
    float part[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][p][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B fragments of n-tiles 2 nn and 2 nn + 1: b[nn][0..1], b[nn][2..3]
      uint32_t b[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        ldsm_x4_trans(b[nn], Bs + at_bf16<kBN>(16 * kk + lr + 8 * l8,
                                               (wn >> 3) + 2 * nn + l16));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4];  // rows +0 / +8 (l8), k lo / hi (l16)
        ldsm_x4(a, As + at_bf16<kBK>(wm + 16 * mt + lr + 8 * l8,
                                     2 * kk + l16));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          mma_bf16(part[mt][2 * nn], a, b[nn][0], b[nn][1]);
          mma_bf16(part[mt][2 * nn + 1], a, b[nn][2], b[nn][3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][p][e] += part[mt][p][e];
  }
  cp_async_wait<0>();

  // the lane's columns: n-tile p holds columns nb + 8 p and nb + 8 p + 1
  const int nb = n0 + wn + 2 * t;
  float bv[4][2];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nb + 8 * p + e;
      bv[p][e] = n < g.OC ? from_bf16(bias[n]) : 0.f;
    }
  const bool pairs = (g.OC & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long m = m0 + wm + 16 * mt + gq + 8 * r;
      if (m >= g.M) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int n = nb + 8 * p;
        if (n >= g.OC) continue;
        const float z0 = acc[mt][p][2 * r] + bv[p][0];
        const float z1 = acc[mt][p][2 * r + 1] + bv[p][1];
        const float y0 = dl4j::activate(g.act, z0);
        const float y1 = dl4j::activate(g.act, z1);
        const long long off = m * g.OC + n;
        if (pairs) {  // n even, so the pair is 4-byte aligned
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(y0, y1);
          if (pre != nullptr)
            *reinterpret_cast<uint32_t*>(pre + off) = pack_bf16(z0, z1);
        } else {
          out[off] = to_bf16(y0);
          if (pre != nullptr) pre[off] = to_bf16(z0);
          if (n + 1 < g.OC) {
            out[off + 1] = to_bf16(y1);
            if (pre != nullptr) pre[off + 1] = to_bf16(z1);
          }
        }
      }
    }
}

template <int kAVec, bool kVecB>
int run(const uint16_t* x, const uint16_t* w, const uint16_t* b, uint16_t* out,
        uint16_t* pre, const Geom& g, long long mt, cudaStream_t stream) {
  const auto kernel = conv2d_bias_act_bf16_kernel<kAVec, kVecB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)mt, (g.OC + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, w, b, out, pre, g);
  return (int)cudaGetLastError();
}

// The A copy width C channels allow: 8 (16 bytes) when C % 8 == 0 and x is
// 16-byte aligned, 2 (4 bytes) when C is even and x 4-byte aligned, else 1.
inline int a_vec(int C, uintptr_t x) {
  if (C % 8 == 0 && (x & 15) == 0) return 8;
  if (C % 2 == 0 && (x & 3) == 0) return 2;
  return 1;
}

inline int launch(const uint16_t* x, const uint16_t* w, const uint16_t* b,
                  uint16_t* out, uint16_t* pre, const Geom& g, long long mt,
                  cudaStream_t s) {
  const int av = a_vec(g.C, (uintptr_t)x);
  const bool vb = g.OC % 8 == 0 && ((uintptr_t)w & 15) == 0;
  if (av == 8)
    return vb ? run<8, true>(x, w, b, out, pre, g, mt, s)
              : run<8, false>(x, w, b, out, pre, g, mt, s);
  if (av == 2)
    return vb ? run<2, true>(x, w, b, out, pre, g, mt, s)
              : run<2, false>(x, w, b, out, pre, g, mt, s);
  return vb ? run<1, true>(x, w, b, out, pre, g, mt, s)
            : run<1, false>(x, w, b, out, pre, g, mt, s);
}

// attrs (tc_common.cuh) of the variant C and OC launch, x and w aligned
inline int variant_attrs(int C, int OC, int* out) {
  const int av = a_vec(C, 0);
  const bool vb = OC % 8 == 0;
  if (av == 8)
    return vb ? attrs(conv2d_bias_act_bf16_kernel<8, true>, kSmem, out)
              : attrs(conv2d_bias_act_bf16_kernel<8, false>, kSmem, out);
  if (av == 2)
    return vb ? attrs(conv2d_bias_act_bf16_kernel<2, true>, kSmem, out)
              : attrs(conv2d_bias_act_bf16_kernel<2, false>, kSmem, out);
  return vb ? attrs(conv2d_bias_act_bf16_kernel<1, true>, kSmem, out)
            : attrs(conv2d_bias_act_bf16_kernel<1, false>, kSmem, out);
}

}  // namespace dl4j_conv_bf16
