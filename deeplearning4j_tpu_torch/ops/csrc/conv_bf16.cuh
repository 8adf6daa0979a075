// The bf16 cores of the fused NHWC conv2d + bias + activation forward
// (conv2d_bias_act.cu), for Hopper (sm_90a): x, w, b, out and pre in bf16,
// the products on the tensor cores with f32 accumulators, the bias and the
// activation in f32, and one rounding to bf16 at the store. Two kernels,
// chosen by a rule on the shape in launch() (the route):
//   - "wgmma" (C % 64 == 0, OC % 8 == 0, x and w 16-byte aligned, M <= 2^31
//     - 129, a geometry that TMA's im2col mode encodes: AlexNet's conv2 and
//     conv3; wgmma_route): an implicit GEMM on wgmma, fed through an
//     mbarrier ring by a producer warpgroup, A by TMA in im2col mode
//     (conv_bf16_wgmma_kernel);
//   - "mma_sync" (every other shape: AlexNet's conv1, C = 3; LeNet's conv2,
//     C = 20, OC = 50; C a multiple of 8 but not of 64): bf16 mma.sync
//     m16n8k16 (conv2d_bias_act_bf16_kernel).
// Neither hands a shape to the other: a launch the route gives the wgmma
// kernel that fails (its tensor maps, its launch) returns the error.
//
// Both replace the Pallas TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_conv2d_bias_act_forward` (:119, pallas_call :144, body `_conv_kernel`
// :92) at bf16: its dot takes `preferred_element_type=f32` (:102-103), the
// bias and activation run on the f32 block (:116), and the output is cast to
// x.dtype once (:158). Products of two bf16 values are exact in f32, so these
// kernels and the plain version (cuda_kernels.conv2d_bias_act_ref at bf16)
// differ only in the order of the f32 sums and, at worst, in the one
// rounding that follows.
//
// Layout and geometry as the f32 kernel's (conv2d_bias_act.cu): x [B, H, W,
// C], w [KH, KW, C, OC] read as the [K, OC] matrix, K = KH * KW * C in (ki,
// kj, c) order, out and pre [B, OH, OW, OC] read as [M, OC]; the wrapper
// gives the stride and the top/left pads. No atomics and no split-K in
// either kernel: a launch gives the same bits every time.
//
// What bounds them on this card: at AlexNet's conv2 and conv3 (B = 512) the
// operations, 2 M OC K = 19.33 GFLOP each, 0.0195 ms at 989 TFLOP/s (bf16
// dense); conv1 (K = 27) by its bytes, nearly all of them its 67 MB bf16
// output (0.020 ms at 3.35 TB/s).
//
// The wgmma kernel. The mma.sync kernel below reached 0.11-0.12 of the
// operations bound at conv2 and conv3: every thread both gathered and
// multiplied, a __syncthreads ended every 32-deep K slice, each warp owned
// 32 x 32 of the tile, and each slice summed into fresh accumulators. What
// this design does about it:
//   - a persistent grid (one block per SM; tile i of [M / 128, OC / 128],
//     column tiles innermost, goes to block i mod the grid) of three
//     warpgroups: warpgroup 0 is the producer (setmaxnreg.dec to
//     kProducerRegs), warpgroups 1 and 2 the consumers (setmaxnreg.inc to
//     kConsumerRegs), each owning 64 rows of the 128 x 128 output tile.
//     The producer runs ahead across tiles, so the next tile's first
//     slices land while the consumers run this one's epilogue;
//   - K in 64-deep slices (one 128-byte row of bf16) through a ring of
//     kStages = 6 stages, a full and an empty mbarrier per stage, no
//     __syncthreads in the loop. conv2 walks 9 slices a tile, conv3 18;
//   - A, the [128 x 64] slice of the virtual im2col matrix, never in device
//     memory. C % 64 == 0, so a slice is 64 channels of one (ki, kj) tap,
//     and one TMA load in im2col mode brings it: a 4-d map over x (C, W, H,
//     B) whose bounding box has corners -pad and pad - (k - 1) per spatial
//     dimension and traversal strides (SW, SH), so a load walks 128 window
//     origins from the tile's first one (W, then H, then B; rows past M
//     walk into images past B), each shifted by the tap (kj, ki); padding
//     and rows past M arrive as zeros. The 128-byte swizzle puts chunk c of
//     row r at r * 128 + 16 (c ^ (r & 7)), what the wgmma descriptor reads.
//     A gather by the producer's 128 threads (16-byte cp.async chunks of 8
//     channels, which would also take C % 8 == 0, slices across taps) took
//     1.26x (conv2) and 1.34x (conv3) this kernel's time on an H100 (tools/
//     conv_bf16_time.py), and no model of the repo has such a conv;
//   - B, the [64 x 128] slice of w, by TMA: a 2-d map over [K, OC] (row
//     stride OC * 2 bytes, hence OC % 8 == 0), two 64-column boxes of
//     128-byte swizzled rows, zeros past K and OC; expect_tx on the same
//     full barrier as A's bytes;
//   - each consumer, per slice: wait full (the TMA loads and the wgmma
//     reads are both in the async proxy), four wgmma m64n128k16 with both
//     operands in shared memory, A K-major, B through the transposed
//     (MN-major) descriptor whose leading byte offset spans the two boxes,
//     then the stage is released. Accuracy: each 32-deep half slice (two k-steps) sums in
//     fresh accumulators that join the running f32 sum in one rounded add,
//     as the mma.sync kernel does. One chain over all of K (the tensor
//     cores truncate as they accumulate) flipped 2.4x (conv2, K = 576) and
//     4.2x (conv3, K = 1152) as many bf16 roundings against the plain
//     version, and moved the bf16 AlexNet loss curve past its gate; the
//     two waits a slice cost little, as the loads bound the loop;
//   - epilogue: z = acc + bias and act(z) in f32 (activations.cuh), rounded
//     once (cvt.rn) into a 128-byte-swizzled staging tile per consumer,
//     stored by TMA (rows past M and columns past OC clipped by the map);
//     pre the same way when asked for. The activation is a template
//     argument, chosen once a tile, in one of two forms (see stage_regs);
//   - the warpgroup index and the slice count are broadcast from lane 0, so
//     ptxas sees every branch around a wgmma as uniform (a wgmma it cannot
//     prove uniform is serialised).
// Shared memory: 6 x (A 16 KiB + B 16 KiB) + 2 x 16 KiB staging + the
// barriers + 1 KiB to align on 1024 bytes (225 KiB). Registers: ptxas
// allocated this kernel within the launch's 168 a thread whatever
// setmaxnreg.inc asks; that holds a consumer's sums and fresh part, 128 of
// them, with the epilogue in two forms. What bounds it now: the operands'
// bytes from L2, 32 KiB a slice (A is loaded again for every tap and
// every column tile, B again for every row tile): 302 MB at conv2,
// about 4.8 TB/s at its 0.0631 ms on an H100.
//
// The mma.sync kernel: the f32 kernel's implicit GEMM with bf16 tiles. A
// block of 8 warps owns a 128 x 64 tile of [M, OC], two blocks per SM, and
// walks K in slices of 32 (two 16-deep k-steps) through a 3-stage ring in
// shared memory, one barrier per slice:
//   - A, the [128 x 32] slice of the virtual im2col matrix, straight from x:
//     16-byte cp.async chunks of 8 channels of one (ki, kj) tap when C % 8
//     == 0 and x is 16-byte aligned; 4-byte cp.async pairs when C is even
//     (LeNet's conv2, C = 20); else (C = 3 at AlexNet's conv1, K = 27) one
//     2-byte load and shared store per element, as cp.async copies 4 bytes
//     at least. Padded positions and rows or k past M and K are zeros, so
//     K's tail up to the 16-deep k-step adds nothing.
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
//     running f32 sum in one rounded add, as the f32 kernel does.
//   - Epilogue: z = acc + bias and act(z) in f32 (activations.cuh), both
//     rounded to bf16 (to nearest even, cvt.rn) as they are stored, in pairs
//     of adjacent columns where OC is even.
// What still bounds it at conv1 (C = 3): its bytes, at 0.14 of that bound:
// the A gather is one 2-byte load and shared store per element.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits.h>

#include "activations.cuh"
#include "sm90_common.cuh"
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

// -- the wgmma kernel (see the notes at the top) ------------------------------

namespace wg {

using namespace dl4j_sm90;

constexpr int kBM = 128;   // output rows per tile
constexpr int kBN = 128;   // output columns per tile: two 64-column boxes
constexpr int kBK = 64;    // K per slice: one 128-byte swizzle row of bf16
constexpr int kStages = 6;
constexpr int kThreads = 384;       // the producer and two consumers
constexpr int kConsumerWarps = 8;   // arrivals that empty a stage
constexpr int kProducerRegs = 88;   // setmaxnreg of the producer
constexpr int kConsumerRegs = 208;  // and of the consumers: 128 x 88 + 256 x
                                    // 208 = 384 x 168, the launch's share
constexpr int kRowBytes = 128;      // a swizzled row of 64 bf16
constexpr int kAtom = 8 * kRowBytes;        // 8 rows: the swizzle's period
constexpr int kA = kBM * kRowBytes;         // an A slice, 16 KiB
constexpr int kBox = kBK * kRowBytes;       // a [64 k][64 n] box of B, 8 KiB
constexpr int kStage = kA + 2 * kBox;       // 32 KiB
constexpr int kStg = 64 * 2 * kRowBytes;    // a consumer's [64][128] staging
constexpr int kBars = kStages * kStage + 2 * kStg;
constexpr size_t kSmem = kBars + 16 * kStages + 1024;

// The producer warpgroup: its thread 0 issues, slice by slice of every tile
// of this block, A by TMA in im2col mode and B by TMA.
__device__ __forceinline__ void produce(const CUtensorMap* tw,
                                        const CUtensorMap* tx, const Geom& g,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int slices, int tiles,
                                        int ntn) {
  if (threadIdx.x != 0) return;
  tma_prefetch(tw);
  tma_prefetch(tx);
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * kBM;
    const int n0 = (tile % ntn) * kBN;
    // the window of output row m0: the walk's start; rows past M walk into
    // images past B, which read as zeros
    const int ow = m0 % g.OW;
    const int q = m0 / g.OW;
    const int n = q / g.OH;
    const int w0 = ow * g.SW - g.PL;
    const int h0 = (q - n * g.OH) * g.SH - g.PT;
    for (int sl = 0; sl < slices; ++sl, ++it) {
      const int st = it % kStages;
      uint8_t* stage = smem + st * kStage;
      mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(full + st, kA + 2 * kBox);
      const int k = sl * kBK;  // one tap: C % 64 == 0
      const int tap = k / g.C;
      const int ki = tap / g.KW;
      tma_load_im2col_4d(stage, tx, full + st, k - tap * g.C, w0, h0, n,
                         tap - ki * g.KW, ki);
      tma_load_2d(stage + kA, tw, full + st, n0, k);
      tma_load_2d(stage + kA + kBox, tw, full + st, n0 + 64, k);
    }
  }
}

// The epilogue stages act(acc + bias) of this thread's 64 outputs (rows 16
// warp + gq + 8 r, columns n0 + 8 j + 2 t + e of acc[4 j + 2 r + e]),
// rounded to bf16, into the consumer's staging tile: two [64][64] boxes of
// 128-byte swizzled rows, as the output's tensor map stores them. The
// activation is a template argument, chosen once a tile (a runtime code
// inside an unrolled loop lets the compiler evaluate every activation for
// every element). Two forms:
//   - stage_regs, unrolled from registers, for the activations without a
//     call (their arithmetic is inline; relu, AlexNet's, among them);
//   - stage_mem, from a local copy of the sums in a loop that is not
//     unrolled, for the others: their division slow paths are calls, and
//     sums live across a call were kept in local memory through the
//     mainloop too (spills that made the kernel 5x slower).
template <int A>
__device__ __forceinline__ void stage_regs(const float (&acc)[64],
                                           const float (&bv)[32],
                                           uint8_t* stg, int warp, int gq,
                                           int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + gq + 8 * r;
      const float v0 = dl4j::activate(A, acc[4 * j + 2 * r] + bv[2 * j]);
      const float v1 =
          dl4j::activate(A, acc[4 * j + 2 * r + 1] + bv[2 * j + 1]);
      const int off = (j >> 3) * (64 * kRowBytes) + row * kRowBytes +
                      (((j & 7) ^ (row & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(stg + off) = pack_bf16(v0, v1);
    }
}

template <int A>
__device__ __forceinline__ void stage_mem(const float* z,
                                          const uint16_t* __restrict__ bias,
                                          int n0, int OC, uint8_t* stg,
                                          int warp, int gq, int t) {
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * t;  // OC % 8 == 0: n and n + 1 alike
    const float b0 = n < OC ? from_bf16(bias[n]) : 0.f;
    const float b1 = n < OC ? from_bf16(bias[n + 1]) : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + gq + 8 * r;
      const float v0 = dl4j::activate(A, z[4 * j + 2 * r] + b0);
      const float v1 = dl4j::activate(A, z[4 * j + 2 * r + 1] + b1);
      const int off = (j >> 3) * (64 * kRowBytes) + row * kRowBytes +
                      (((j & 7) ^ (row & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(stg + off) = pack_bf16(v0, v1);
    }
  }
}

// the activations whose arithmetic makes no call: stage_regs
__device__ __forceinline__ bool act_inline(int act) {
  return act == dl4j::kIdentity || act == dl4j::kRelu ||
         act == dl4j::kLeakyRelu || act == dl4j::kHardTanh ||
         act == dl4j::kHardSigmoid || act == dl4j::kCube;
}

__device__ __forceinline__ void stage_regs_act(int act,
                                               const float (&acc)[64],
                                               const float (&bv)[32],
                                               uint8_t* stg, int warp, int gq,
                                               int t) {
  switch (act) {
#define DL4J_STAGE(A) \
  case dl4j::A: stage_regs<dl4j::A>(acc, bv, stg, warp, gq, t); break;
    DL4J_STAGE(kRelu)
    DL4J_STAGE(kLeakyRelu)
    DL4J_STAGE(kHardTanh)
    DL4J_STAGE(kHardSigmoid)
    DL4J_STAGE(kCube)
#undef DL4J_STAGE
    default: stage_regs<dl4j::kIdentity>(acc, bv, stg, warp, gq, t);
  }
}

__device__ __forceinline__ void stage_mem_act(int act, const float* z,
                                              const uint16_t* __restrict__ bias,
                                              int n0, int OC, uint8_t* stg,
                                              int warp, int gq, int t) {
  switch (act) {
#define DL4J_STAGE(A) \
  case dl4j::A: stage_mem<dl4j::A>(z, bias, n0, OC, stg, warp, gq, t); break;
    DL4J_STAGE(kTanh)
    DL4J_STAGE(kSigmoid)
    DL4J_STAGE(kElu)
    DL4J_STAGE(kSelu)
    DL4J_STAGE(kSoftplus)
    DL4J_STAGE(kSoftsign)
    DL4J_STAGE(kRationalTanh)
    DL4J_STAGE(kRectifiedTanh)
    DL4J_STAGE(kGelu)
    DL4J_STAGE(kSwish)
#undef DL4J_STAGE
    default: stage_mem<dl4j::kIdentity>(z, bias, n0, OC, stg, warp, gq, t);
  }
}

// A consumer warpgroup: rows 64 wgi .. 64 wgi + 63 of each tile of this
// block.
__device__ __forceinline__ void consume(const CUtensorMap* tout,
                                        const CUtensorMap* tpre,
                                        const uint16_t* __restrict__ bias,
                                        const Geom& g, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int slices, int tiles, int ntn,
                                        bool has_pre) {
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const uint32_t ring = smem_u32(smem);
  uint8_t* stg = smem + kStages * kStage + wgi * kStg;
  float acc[64], part[64];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * kBM + 64 * wgi;
    const int n0 = (tile % ntn) * kBN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int sl = 0; sl < slices; ++sl, ++it) {
      const int st = it % kStages;
      mbar_wait(full + st, (it / kStages) & 1);
      const uint32_t a = ring + st * kStage + wgi * 64 * kRowBytes;
      const uint32_t b = ring + st * kStage + kA;
      // each 32-deep half of the slice sums in fresh accumulators (the
      // first wgmma's scale-d is 0), which join the running sum in one
      // rounded f32 add: the tensor cores truncate as they accumulate
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(part[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
          wgmma_ss_n128_tb(part, gmma_desc(a + 32 * kk, 16, kAtom, 1),
                           gmma_desc(b + kk * 16 * kRowBytes, kBox, kAtom, 1),
                           kk > 2 * half);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          reg_fence(part[i]);
          acc[i] += part[i];
        }
      }
      if (lane == 0) mbar_arrive(empty + st);  // the slice is read
    }
    // the epilogue: act(z), then z when pre is asked for, through the
    // staging tile, each pass stored by TMA
    auto flush = [&](auto&& fill) {
      for (int pass = 0; pass < (has_pre ? 2 : 1); ++pass) {
        if (tid == 0) bulk_wait_read<0>();  // the last store has read stg
        bar_sync(1 + wgi, 128);
        fill(pass);
        fence_proxy_async();  // the staging writes, to the TMA store
        bar_sync(1 + wgi, 128);
        if (tid == 0 && m0 < g.M) {
          const CUtensorMap* map = pass == 0 ? tout : tpre;
          tma_store_2d(map, stg, n0, m0);
          if (n0 + 64 < g.OC)
            tma_store_2d(map, stg + 64 * kRowBytes, n0 + 64, m0);
          bulk_commit();
        }
      }
    };
    if (act_inline(g.act)) {
      float bv[32];  // the bias of columns n0 + 8 j + 2 t + e
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          bv[2 * j + e] = n < g.OC ? from_bf16(bias[n]) : 0.f;
        }
      flush([&](int pass) {
        if (pass == 0)
          stage_regs_act(g.act, acc, bv, stg, warp, gq, t);
        else
          stage_regs<dl4j::kIdentity>(acc, bv, stg, warp, gq, t);
      });
    } else {
      float z[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) z[i] = acc[i];
      flush([&](int pass) {
        if (pass == 0)
          stage_mem_act(g.act, z, bias, n0, g.OC, stg, warp, gq, t);
        else
          stage_mem<dl4j::kIdentity>(z, bias, n0, g.OC, stg, warp, gq, t);
      });
    }
  }
  if (tid == 0) bulk_wait<0>();  // the stores are done with shared memory
}

// One block per SM over ``tiles`` output tiles of [M / 128, OC / 128]
// (ntn column tiles a row). tw maps w as [K, OC], tx x for im2col loads,
// tout and tpre out and pre as [M, OC] (tpre only read when has_pre).
__global__ void __launch_bounds__(kThreads, 1)
    conv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tout,
                           const __grid_constant__ CUtensorMap tpre,
                           const uint16_t* __restrict__ bias, Geom g,
                           int tiles, int ntn, int has_pre) {
  extern __shared__ __align__(16) uint8_t smem_wg[];
  uint8_t* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);  // the producer's expect_tx
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the slice count and the role broadcast from lane 0: uniform branches
  const int slices = __shfl_sync(0xffffffffu, (g.K + kBK - 1) / kBK, 0);
  if (__shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) == 0) {
    regs_dealloc<kProducerRegs>();
    produce(&tw, &tx, g, smem, full, empty, slices, tiles, ntn);
  } else {
    regs_alloc<kConsumerRegs>();
    consume(&tout, &tpre, bias, g, smem, full, empty, slices, tiles, ntn,
            has_pre != 0);
  }
}

// The im2col map's bounding box: the corners are -pad before and pad - (k -
// 1) after each spatial dimension, so the walk visits exactly the OW x OH
// window origins at the stride; {lower W, lower H, upper W, upper H}.
inline void im2col_corners(const Geom& g, int (&c)[4]) {
  c[0] = -g.PL;
  c[1] = -g.PT;
  c[2] = (g.OW - 1) * g.SW - g.PL - (g.W - 1);
  c[3] = (g.OH - 1) * g.SH - g.PT - (g.H - 1);
}

inline int sm_count(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// Tensor maps of w, x (im2col), out and pre, then the persistent launch with
// the ring's dynamic shared memory opted in; returns a cudaError_t as int.
// The route (wgmma_route) has checked that the maps can encode g.
inline int run(const uint16_t* x, const uint16_t* w, const uint16_t* b,
               uint16_t* out, uint16_t* pre, const Geom& g,
               cudaStream_t stream) {
  const long long ntn = (g.OC + kBN - 1) / kBN;
  const long long tiles = (g.M + kBM - 1) / kBM * ntn;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx, tout, tpre;
  int c[4];
  im2col_corners(g, c);
  int e = bf16_2d_map(&tw, w, g.K, g.OC, kBK);
  if (e == 0) e = bf16_2d_map(&tout, out, g.M, g.OC, 64);
  if (e == 0) e = bf16_2d_map(&tpre, pre != nullptr ? pre : out, g.M, g.OC, 64);
  if (e == 0)
    e = bf16_nhwc_im2col_map(&tx, x, g.B, g.H, g.W, g.C, c, g.SW, g.SH, kBK,
                             kBM);
  int sms = 0;
  if (e == 0) e = sm_count(&sms);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      conv_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (a != cudaSuccess) return (int)a;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv_bf16_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      tw, tx, tout, tpre, b, g, (int)tiles, (int)ntn, pre != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace wg

// The route, a rule on the shape, and its limits (cuda_kernels.
// conv_bf16_route reads the kRoute constants from this file): the wgmma
// kernel takes a launch when
//   - C is a multiple of kRouteC: a 64-deep K slice is one tap, one TMA
//     im2col load;
//   - OC is a multiple of kRouteOC: the rows of w, out and pre are multiples
//     of 16 bytes, as a tensor map needs;
//   - x and w are kRouteAlign-byte aligned, as a tensor map's base;
//   - M is at most kRouteMaxM: every row index of a tile, m0 + 127, fits an
//     int;
//   - the im2col map of a 4-d tensor encodes the geometry: traversal strides
//     at most kRouteMaxStride, the bounding box's corners (im2col_corners)
//     in [kRouteCornerLo, kRouteCornerHi], KH and KW at most kRouteMaxTap
//     (the load's tap offsets);
// the mma.sync kernel takes every other launch.
constexpr int kRouteC = 64;
constexpr int kRouteOC = 8;
constexpr int kRouteAlign = 16;
constexpr long long kRouteMaxM = 2147483647LL - 128;
constexpr int kRouteMaxStride = 8;
constexpr int kRouteCornerLo = -128;
constexpr int kRouteCornerHi = 127;
constexpr int kRouteMaxTap = 256;
static_assert(kRouteC == wg::kBK, "a K slice is one tap");

inline bool wgmma_route(const Geom& g, uintptr_t x, uintptr_t w) {
  int c[4];
  wg::im2col_corners(g, c);
  bool ok = g.C % kRouteC == 0 && g.OC % kRouteOC == 0 &&
            x % kRouteAlign == 0 && w % kRouteAlign == 0 &&
            g.M <= kRouteMaxM && g.SW <= kRouteMaxStride &&
            g.SH <= kRouteMaxStride && g.KW <= kRouteMaxTap &&
            g.KH <= kRouteMaxTap;
  for (int v : c) ok = ok && v >= kRouteCornerLo && v <= kRouteCornerHi;
  return ok;
}

inline int launch(const uint16_t* x, const uint16_t* w, const uint16_t* b,
                  uint16_t* out, uint16_t* pre, const Geom& g, long long mt,
                  cudaStream_t s) {
  if (wgmma_route(g, (uintptr_t)x, (uintptr_t)w))
    return wg::run(x, w, b, out, pre, g, s);
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

// attrs (tc_common.cuh) of the kernel that a 1 x 1 conv of C and OC
// channels takes, x and w aligned
inline int variant_attrs(int C, int OC, int* out) {
  const Geom g{1, C, 1, 1, 1, C, 1, 1, OC, 1, 1, 1, 1, 0, 0, 0};
  if (wgmma_route(g, 0, 0))
    return attrs(wg::conv_bf16_wgmma_kernel, wg::kSmem, out);
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
