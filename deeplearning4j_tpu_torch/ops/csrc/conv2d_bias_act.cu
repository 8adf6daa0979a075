// Fused NHWC conv2d + bias + activation, forward, for Hopper (sm_90a), f32 in
// and out, the products on the tensor cores in 3xTF32. The bf16 kernels (bf16
// in and out, f32 accumulation) are its siblings in conv_bf16.cuh, with
// their entry points at the end of this file: a rule on the shape (the
// route, conv_bf16.cuh `wgmma_route`) gives C % 64 == 0 and OC % 8 == 0
// within the encoding of TMA's im2col mode (AlexNet's conv2 and conv3) to an
// implicit GEMM on wgmma fed through an mbarrier ring by a producer
// warpgroup, bound by its operations (0.0195 ms at 989 TFLOP/s each); every
// other shape to a bf16 mma.sync kernel.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_conv2d_bias_act_forward` (:119, pallas_call :144, body `_conv_kernel` :92):
//
//   x    [B, H, W, C]        f32, NHWC
//   w    [KH, KW, C, OC]     f32, HWIO; flattened it is the [K, OC] matrix,
//                            K = KH * KW * C in (ki, kj, c) order
//   b    [OC]                f32
//   out  [B, OH, OW, OC]     f32 = act(conv(x, w) + b); as a matrix [M, OC],
//                            M = B * OH * OW
//   pre  [B, OH, OW, OC]     f32 = conv(x, w) + b, the pre-activation, written
//                            only when the pointer is not null (the training
//                            path keeps it for the activation's gradient)
//
// Geometry (stride, the top/left pads, OH, OW) comes from the wrapper, which
// computes it as `_conv_geometry` (:72) does, SAME's asymmetric pads included;
// input rows and columns outside [0, H) x [0, W) read as zero.
//
// Design: an implicit GEMM on mma.sync m16n8k8 tf32 in 3xTF32 (tc_common.cuh).
// A block of 8 warps owns a 128 x 64 tile of the [M, OC] output, two blocks
// per SM, and walks K in slices of 32 through a 3-stage cp.async ring in
// shared memory, one barrier per slice:
//   - A, the [128 x 32] slice of the virtual im2col matrix, comes straight
//     from x: when C % 4 == 0 (and x is 16-byte aligned) each 16-byte copy is
//     four channels of one (ki, kj) tap, contiguous in NHWC; otherwise (C = 3
//     at AlexNet's conv1) one 4-byte copy per element. Padded positions and
//     rows or k past M and K are zero-filled (src-size 0). Each thread copies
//     chunk tid % 8 of rows tid / 8 + 32 j, whose (n, oh, ow) it decomposes
//     once; per slice it decomposes its k into (ki, kj, c) once.
//   - B, the [32 x 64] slice of w, by 16-byte copies when OC % 4 == 0 (4-byte
//     ones otherwise), zeros past K and OC.
//   - Warp (wm, wn), 4 x 2 of them, owns 32 rows (two m-tiles) x 32 columns.
//     Per two k-steps a lane reads one float4 of A's rows g and g + 8
//     per m-tile (k = 16i + 4t ... + 3: k-step 2i takes 16i + 4t (column t)
//     and + 1 (column t + 4), k-step 2i + 1 the other two) and one float4 of
//     B's rows 16i + 4t + e, which is column g of four n-tiles: n-tile p's
//     column g is output column 4g + p of the warp. So the C fragments hold
//     8 consecutive output columns 8t ... 8t + 7 of rows g and g + 8, stored
//     as two float4. hi and lo are split in registers as the fragments load;
//     each B value serves two m-tiles, each A value four n-tiles.
//   - Occupancy: two blocks (16 warps) per SM hide the latency of the shared
//     loads and the per-slice barrier better than one block of a 128 x 128
//     tile did (12% faster at AlexNet's conv2 in a throwaway comparison on
//     the card), though the 128-register cap spills 80-88 bytes a thread.
//   - Accuracy: the tensor cores truncate as they accumulate, so each K slice
//     sums in fresh accumulators (12 products deep) that join the running f32
//     sum in one rounded add; K reaches 1152 at AlexNet's conv3.
//   - Swizzles: A rows [32] at chunk c ^ ((r & 6) ^ ((r & 1) << 2)) (the
//     attention tiles' swizzle), B rows [64] at chunk c ^ (((k >> 2) & 3) <<
//     1); both put each quarter warp's float4 reads, and the copies' writes,
//     on distinct chunk slots: no bank conflicts.
//   - Epilogue: bias, the activation (activations.cuh) and the optional pre
//     output from the accumulators, masked at the M and OC edges.
// No atomics and no split-K: the reduction runs in one fixed order, so a
// launch gives the same bits every time. No im2col matrix is ever written to
// device memory (the TPU kernel still materialised a kw-fold row expansion).
//
// What bounds it on this card: at AlexNet's conv2 and conv3 (B = 512) the
// operations, 2 M OC K (19.33 GFLOP each): 0.289 ms each against f32 outside
// the tensor cores (67 TFLOP/s), 0.117 ms with three tf32 products per
// product at 495 TFLOP/s; conv1 (K = 27) is bound by its bytes, nearly all of
// them its 134 MB output (0.042 ms at 3.35 TB/s).
//
// Differences from the TPU kernel: the Pallas grid ran (batch tile, output
// row, kernel row) in order and accumulated the kernel rows in the resident
// output block; here one block owns a whole output tile and the reduction
// over (ki, kj, c) is a loop inside the block. Why mma.sync and not wgmma:
// tc_common.cuh (for tf32, wgmma needs both operands K-major in shared
// memory, so w would need a transpose, and the lo halves their own tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"
#include "conv_bf16.cuh"
#include "tc_common.cuh"

namespace {

using namespace dl4j_tc;

constexpr int kBM = 128;  // output rows (m) per block
constexpr int kBN = 64;   // output columns (oc) per block
constexpr int kBK = 32;   // K per slice
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMT = 2;                 // m-tiles of 16 rows per warp
constexpr int kWM = kBM / (16 * kMT);  // warps along m: 4 (and 2 along n)
constexpr int kA = kBM * kBK;          // floats of an A slice
constexpr int kB = kBK * kBN;          // floats of a B slice
constexpr size_t kSmem = (size_t)kStages * (kA + kB) * sizeof(float);

struct Geom {
  long long M;
  int K, B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act;
};

// float offset of chunk c of row k in a swizzled B slice [32][64]
__device__ __forceinline__ int b_at(int k, int c) {
  return k * kBN + 4 * (c ^ (((k >> 2) & 3) << 1));
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads, 2)
    conv2d_bias_act_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, float* __restrict__ pre,
                           Geom g) {
  extern __shared__ __align__(16) float smem[];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int slices = (g.K + kBK - 1) / kBK;

  // this thread copies chunk ac (k = 4 ac ... 4 ac + 3 of the slice) of A's
  // rows ar + 32 j
  const int ac = tid & 7;
  const int ar = tid >> 3;
  long long a_base[4];  // offset of x[n, 0, 0, 0]
  int a_ih[4], a_iw[4];  // top-left input position of the window
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + ar + 32 * j;
    const long long mm = m < g.M ? m : 0;
    const int ow = (int)(mm % g.OW);
    const long long q = mm / g.OW;
    const int oh = (int)(q % g.OH);
    a_base[j] = (q / g.OH) * g.H * g.W * g.C;
    a_ih[j] = m < g.M ? oh * g.SH - g.PT : -(1 << 30);  // never in range
    a_iw[j] = ow * g.SW - g.PL;
  }

  auto fetch = [&](int sl) {
    float* As = smem + (sl % kStages) * (kA + kB);
    float* Bs = As + kA;
    const int kb = sl * kBK;
    if constexpr (kVecA) {
      const int k = kb + 4 * ac;
      const int tap = k / g.C;
      const int c = k - tap * g.C;
      const int ki = tap / g.KW;
      const int kj = tap - ki * g.KW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ih = a_ih[j] + ki;
        const int iw = a_iw[j] + kj;
        const bool in = k < g.K && (unsigned)ih < (unsigned)g.H &&
                        (unsigned)iw < (unsigned)g.W;
        const float* src =
            in ? x + a_base[j] + ((long long)ih * g.W + iw) * g.C + c : x;
        cp_async16(As + at<kBK>(ar + 32 * j, ac), src, in);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kb + 4 * ac + e;
        const int tap = k / g.C;
        const int c = k - tap * g.C;
        const int ki = tap / g.KW;
        const int kj = tap - ki * g.KW;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ih = a_ih[j] + ki;
          const int iw = a_iw[j] + kj;
          const bool in = k < g.K && (unsigned)ih < (unsigned)g.H &&
                          (unsigned)iw < (unsigned)g.W;
          const float* src =
              in ? x + a_base[j] + ((long long)ih * g.W + iw) * g.C + c : x;
          cp_async4(As + at<kBK>(ar + 32 * j, ac) + e, src, in);
        }
      }
    }
    constexpr int kChunks = kBN / 4;  // 16-byte chunks of a B row
#pragma unroll
    for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
      const int i = it * kThreads + tid;
      const int kr = i / kChunks;
      const int cc = i % kChunks;
      const int k = kb + kr;
      const int n = n0 + 4 * cc;
      float* dst = Bs + b_at(kr, cc);
      if constexpr (kVecB) {
        const bool in = k < g.K && n < g.OC;
        cp_async16(dst, in ? w + (long long)k * g.OC + n : w, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = k < g.K && n + e < g.OC;
          cp_async4(dst + e, in ? w + (long long)k * g.OC + n + e : w, in);
        }
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
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
    const float* As = smem + (sl % kStages) * (kA + kB);
    const float* Bs = As + kA;
    float part[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][p][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 16; ++i) {
      // B rows 16i + 4t + e, column g of n-tiles p = 0..3: bh[e][p], bl[e][p]
      uint32_t bh[4][4], bl[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 bv = *reinterpret_cast<const float4*>(
            Bs + b_at(16 * i + 4 * t + e, (wn >> 2) + gq));
        split(bv.x, bh[e][0], bl[e][0]);
        split(bv.y, bh[e][1], bl[e][1]);
        split(bv.z, bh[e][2], bl[e][2]);
        split(bv.w, bh[e][3], bl[e][3]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm + 16 * mt + gq;
        const float4 a0 =
            *reinterpret_cast<const float4*>(As + at<kBK>(r, 4 * i + t));
        const float4 a1 =
            *reinterpret_cast<const float4*>(As + at<kBK>(r + 8, 4 * i + t));
        uint32_t ah[2][4], al[2][4];
        split(a0.x, ah[0][0], al[0][0]);
        split(a1.x, ah[0][1], al[0][1]);
        split(a0.y, ah[0][2], al[0][2]);
        split(a1.y, ah[0][3], al[0][3]);
        split(a0.z, ah[1][0], al[1][0]);
        split(a1.z, ah[1][1], al[1][1]);
        split(a0.w, ah[1][2], al[1][2]);
        split(a1.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          mma3(part[mt][p], ah[0], al[0], bh[0][p], bh[1][p], bl[0][p],
               bl[1][p]);
          mma3(part[mt][p], ah[1], al[1], bh[2][p], bh[3][p], bl[2][p],
               bl[3][p]);
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

  // the lane's output columns nb ... nb + 7: column x is n-tile x % 4, C
  // fragment column 2t (x < 4) or 2t + 1
  const int nb = n0 + wn + 8 * t;
  float bv[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) bv[x] = nb + x < g.OC ? bias[nb + x] : 0.f;
  const bool vec = (g.OC & 3) == 0 && nb + 8 <= g.OC;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long m = m0 + wm + 16 * mt + gq + 8 * r;
      if (m >= g.M) continue;
      float z[8], y[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        z[x] = acc[mt][x & 3][2 * r + (x >> 2)] + bv[x];
        y[x] = dl4j::activate(g.act, z[x]);
      }
      const long long off = m * g.OC + nb;
      if (vec) {
        float4* o4 = reinterpret_cast<float4*>(out + off);
        o4[0] = make_float4(y[0], y[1], y[2], y[3]);
        o4[1] = make_float4(y[4], y[5], y[6], y[7]);
        if (pre != nullptr) {
          float4* p4 = reinterpret_cast<float4*>(pre + off);
          p4[0] = make_float4(z[0], z[1], z[2], z[3]);
          p4[1] = make_float4(z[4], z[5], z[6], z[7]);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (nb + x >= g.OC) continue;
          out[off + x] = y[x];
          if (pre != nullptr) pre[off + x] = z[x];
        }
      }
    }
}

template <bool kVecA, bool kVecB>
int run(const float* x, const float* w, const float* b, float* out, float* pre,
        const Geom& g, long long mt, cudaStream_t stream) {
  const auto kernel = conv2d_bias_act_kernel<kVecA, kVecB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)mt, (g.OC + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, w, b, out, pre, g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Shared memory per block: 72 KiB (two blocks per SM).
extern "C" int dl4j_conv2d_bias_act_f32(const float* x, const float* w, const float* b,
                                        float* out, float* pre, int B, int H, int W,
                                        int C, int KH, int KW, int OC, int OH, int OW,
                                        int SH, int SW, int PT, int PL, int act,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || KH < 1 || KW < 1 || OC < 1 || OH < 1 ||
      OW < 1 || SH < 1 || SW < 1 || act < 0 || act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * OH * OW;
  const long long mt = (M + kBM - 1) / kBM;
  const long long K = (long long)KH * KW * C;
  if (mt > 2147483647LL || (OC + kBN - 1) / kBN > 65535 ||
      K > 2147483647LL - kBK)
    return (int)cudaErrorInvalidValue;
  const Geom g{M, (int)K, B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act};
  const bool vec_a = C % 4 == 0 && aligned16(x);
  const bool vec_b = OC % 4 == 0 && aligned16(w);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec_a)
    return vec_b ? run<true, true>(x, w, b, out, pre, g, mt, s)
                 : run<true, false>(x, w, b, out, pre, g, mt, s);
  return vec_b ? run<false, true>(x, w, b, out, pre, g, mt, s)
               : run<false, false>(x, w, b, out, pre, g, mt, s);
}

// {registers, local bytes per thread, dynamic shared bytes} into out[3] of
// the kernel variant that C input and OC output channels launch (16-byte
// aligned x and w assumed).
extern "C" int dl4j_conv2d_bias_act_attrs(int C, int OC, int* out) {
  if (C < 1 || OC < 1) return (int)cudaErrorInvalidValue;
  const bool vec_a = C % 4 == 0;
  const bool vec_b = OC % 4 == 0;
  if (vec_a)
    return vec_b ? attrs(conv2d_bias_act_kernel<true, true>, kSmem, out)
                 : attrs(conv2d_bias_act_kernel<true, false>, kSmem, out);
  return vec_b ? attrs(conv2d_bias_act_kernel<false, true>, kSmem, out)
               : attrs(conv2d_bias_act_kernel<false, false>, kSmem, out);
}

// The bf16 kernels (conv_bf16.cuh): x, w, b, out and pre as bf16 bits, the
// arguments otherwise those of dl4j_conv2d_bias_act_f32. The route picks the
// kernel; the wgmma kernel's tensor maps or launch failing returns the error
// (no other kernel takes its shape). Shared memory per block: 225 KiB
// (wgmma, one persistent block per SM) or 36 KiB (mma.sync).
extern "C" int dl4j_conv2d_bias_act_bf16(const uint16_t* x, const uint16_t* w,
                                         const uint16_t* b, uint16_t* out,
                                         uint16_t* pre, int B, int H, int W, int C,
                                         int KH, int KW, int OC, int OH, int OW,
                                         int SH, int SW, int PT, int PL, int act,
                                         void* stream) {
  namespace cb = dl4j_conv_bf16;
  if (B < 1 || H < 1 || W < 1 || C < 1 || KH < 1 || KW < 1 || OC < 1 || OH < 1 ||
      OW < 1 || SH < 1 || SW < 1 || act < 0 || act >= dl4j::kNumActs)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * OH * OW;
  const long long mt = (M + cb::kBM - 1) / cb::kBM;
  const long long K = (long long)KH * KW * C;
  if (mt > 2147483647LL || (OC + cb::kBN - 1) / cb::kBN > 65535 ||
      K > 2147483647LL - cb::wg::kBK)
    return (int)cudaErrorInvalidValue;
  const cb::Geom g{M, (int)K, B, H, W, C, KH, KW, OC, OH, OW, SH, SW, PT, PL, act};
  return cb::launch(x, w, b, out, pre, g, mt, (cudaStream_t)stream);
}

// {registers, local bytes per thread, dynamic shared bytes} into out[3] of
// the bf16 kernel that C input and OC output channels launch (aligned x and
// w assumed).
extern "C" int dl4j_conv2d_bias_act_bf16_attrs(int C, int OC, int* out) {
  if (C < 1 || OC < 1) return (int)cudaErrorInvalidValue;
  return dl4j_conv_bf16::variant_attrs(C, OC, out);
}

// The route of a bf16 launch (conv_bf16.cuh wgmma_route): 1 for the wgmma
// kernel, 0 for the mma.sync kernel, with the arguments of
// dl4j_conv2d_bias_act_bf16 (x and w as addresses).
extern "C" int dl4j_conv2d_bias_act_bf16_route(const void* x, const void* w,
                                               int B, int H, int W, int C,
                                               int KH, int KW, int OC, int OH,
                                               int OW, int SH, int SW, int PT,
                                               int PL) {
  const long long M = (long long)B * OH * OW;
  const dl4j_conv_bf16::Geom g{M, (int)((long long)KH * KW * C), B, H, W, C,
                               KH, KW, OC, OH, OW, SH, SW, PT, PL, 0};
  return dl4j_conv_bf16::wgmma_route(g, (uintptr_t)x, (uintptr_t)w) ? 1 : 0;
}

// The warp specialisation of the bf16 wgmma kernel into out[7]: threads per
// block, the producer warpgroup's and each consumer warpgroup's registers
// after setmaxnreg, the ring's stages, the output tile's rows and columns,
// K per slice.
extern "C" int dl4j_conv_bf16_wgmma_roles(int* out) {
  namespace wg = dl4j_conv_bf16::wg;
  out[0] = wg::kThreads;
  out[1] = wg::kProducerRegs;
  out[2] = wg::kConsumerRegs;
  out[3] = wg::kStages;
  out[4] = wg::kBM;
  out[5] = wg::kBN;
  out[6] = wg::kBK;
  return 0;
}
