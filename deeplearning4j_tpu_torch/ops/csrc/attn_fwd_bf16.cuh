// The bf16 forward core of the flash and splash attention kernels
// (flash_attention_fwd.cu, splash_attention_fwd.cu), designed for Hopper
// (sm_90a): q, k, v and o in bf16, both products on wgmma with f32
// accumulators, K and V through a TMA ring, warp-specialised warpgroups.
//
// Replaces the forward of the Pallas TPU kernels behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_flash_call` (:589) and
// `_splash_call` (:609) at bf16, and the mma.sync core that preceded it here.
// It computes, per (batch row, head, block of 128 query rows):
//   - flash (Walk::kFlash): s = (q k^T) scale in f32, masked scores -inf, the
//     running max guarded against -inf, p rounded to bf16 before p v as the
//     library's `p.astype(v.dtype)` (flash_attention.py :471): one product;
//   - splash: s = q k^T on q the caller pre-scaled, masked scores the
//     library's mask value, where m also starts; p stays f32 for p v as the
//     library keeps it (splash_attention_kernel.py :819). v is exact in
//     bf16, so p v = p_hi v + p_lo v with p_hi = bf16(p) and p_lo = bf16(p -
//     p_hi): two bf16 products, exact to about 2^-17 of p;
//   - both: o = acc / l in bf16, lse = m + log(l) in f32, natural log.
//
// What bounds it on this card: operations, 4 D per kept (query, key) pair
// at 989 TFLOP/s (bf16 dense), 1.112 ms at [1, 32768, 4, 128] causal and
// 0.0695 ms at [1, 8192, 4, 128] causal; splash issues 6 D a pair (its p v
// is two products), so its share of that bound is capped near 0.67. The
// mma.sync core it replaces reached 0.17-0.26 of it on an H100: one block of 8 warps per SM (184-194
// registers a thread), a 2-stage cp.async ring that all 256 threads fed and
// a __syncthreads per tile, mma.sync, and each warp's products and softmax
// in series. What this design does about it:
//   - a block of three warpgroups (384 threads, one block per SM): warpgroup
//     0 is the producer, setmaxnreg.dec to 40 registers, and one thread of it
//     issues every TMA load; warpgroups 1 and 2 are consumers, setmaxnreg.inc
//     to 232, each owning 64 of the block's 128 query rows (128 x 40 + 256 x
//     232 = 384 x 168, the registers the launch gives the block);
//   - TMA and an mbarrier ring: q once (its own barrier); K and V tiles of
//     128 keys through kStages = 2 stages, with a full and an empty barrier
//     per stage for K and for V apart, so K of the next tile lands while V of
//     this one is still in use. Tensor maps over [B, L, H, D] (D, H, L, B
//     innermost first), built by the host per launch (sm90_common.cuh);
//     rows past L come as zeros (flash's ragged tail, L = 7). Rows of 128,
//     64 or 32 bytes are swizzled by that span (D = 64, 32, 16); at D = 128
//     a tile comes as two 64-column boxes, and the descriptors step over them.
//     The splash producer fetches only the kv blocks its table row lists;
//   - wgmma: s = q k^T as m64n128k16 with both operands in shared memory
//     (K-major descriptors matching the swizzle, D / 16 k-steps); o += p v in
//     the RS form, m64nDk16: p from registers (s's f32 accumulator packed to
//     bf16 pairs is already the A fragment), v through an MN-major
//     (transposed) descriptor of the [key][dim] tile, 8 k-steps; splash
//     issues p_lo v and p_hi v into the same accumulator;
//   - the softmax off the critical path, by ping-pong between the two
//     consumers on named barriers: a consumer takes its turn on the tensor
//     cores (p v of its last tile, then q k^T of its next), hands the turn to
//     the other and runs its softmax while the other's products run. p =
//     exp2(s c - m c) in one FMA and ex2.approx per score, c = scale log2(e)
//     for flash and log2(e) for splash; lse back in natural log. Only tiles
//     the mask cuts (a kind-1 block, the causal diagonal, flash's ragged
//     tail) run mask code; a consumer skips the math of a tile whose every
//     pair is masked for its 64 rows, but not the tile's barriers;
//   - the grid keeps the heaviest-first order (causal q blocks from the last
//     one down); o goes from registers to global memory, lse only for rows <
//     L; no atomics, so every launch gives the same bits.
//
// Shared memory: q 32 KiB + 2 x (K + V) 128 KiB = 160 KiB at D = 128 (80
// KiB at D = 64), plus the barriers and 1 KiB to align the tiles on 1024
// bytes, where the 128-byte swizzle repeats.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "tc_common.cuh"  // pack_bf16, bf16_lo, bf16_hi, attrs

namespace dl4j_attn_ws {

using namespace dl4j_sm90;
using dl4j_tc::bf16_hi;
using dl4j_tc::bf16_lo;
using dl4j_tc::pack_bf16;

constexpr int kRows = 128;          // query rows per block
constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr int kKeys = 128;          // keys per K/V tile
constexpr int kStages = 2;          // K/V tiles in the ring
constexpr int kThreads = 384;       // the producer and two consumers
constexpr int kConsumerWarps = 8;   // arrivals that empty a stage
constexpr int kProducerRegs = 40;   // setmaxnreg of the producer
constexpr int kConsumerRegs = 232;  // and of the consumers
constexpr int kTurn0 = 1, kTurn1 = 2;  // named barriers of the ping-pong
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kKeys, "q and K/V tiles share one box shape");

template <int D>
struct Fwd {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kBoxCols = D > 64 ? 64 : D;  // columns of a TMA box
  static constexpr int kBoxes = D / kBoxCols;       // boxes across a row
  static constexpr int kSpan = 2 * kBoxCols;        // bytes of a box row
  static constexpr uint32_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
  static constexpr int kAtom = 8 * kSpan;     // bytes of 8 swizzled rows
  static constexpr int kBox = kKeys * kSpan;  // bytes of one 128-row box
  static constexpr int kTile = kBoxes * kBox;  // q, or one K or V tile
  static constexpr int kBars = kTile + kStages * 2 * kTile;  // barriers' offset
  static constexpr size_t kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
};

// The walk of the flash forward: kv tiles 0 .. nk - 1, causal up to the
// diagonal tile. mode(i, w0): -1 when tile i adds nothing to rows w0 .. w0
// + 63 (all past L, or all keys after them), 0 when none of their scores
// is masked, 1 when some are.
template <bool kCausal>
struct FlashWalk {
  static constexpr bool kFlash = true;
  int L, nk;
  __device__ FlashWalk(int L_, int q0) : L(L_) {
    const int all = (L + kKeys - 1) / kKeys;
    nk = kCausal ? min(all, q0 / kKeys + 1) : all;
  }
  __device__ int count() const { return nk; }
  __device__ int key0(int i) const { return i * kKeys; }
  __device__ int mode(int i, int w0) const {
    const int k0 = i * kKeys;
    if (w0 >= L || (kCausal && k0 > w0 + kWgRows - 1)) return -1;
    return (k0 + kKeys > L || (kCausal && k0 + kKeys - 1 > w0)) ? 1 : 0;
  }
  __device__ bool keep(int row, int col) const {
    return col < L && (!kCausal || col <= row);
  }
};

// The barriers after the tiles: q full, then K full, V full, K empty, V
// empty, kStages each.
struct Bars {
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
  __device__ explicit Bars(uint64_t* b)
      : q_full(b), k_full(b + 1), v_full(b + 1 + kStages),
        k_empty(b + 1 + 2 * kStages), v_empty(b + 1 + 3 * kStages) {}
};

// The producer's one thread: q, then each listed tile's K and V into the
// ring as their stages empty.
template <int D, class Walk>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint8_t* smem,
                                        const Bars& bar, int q0, int h, int b,
                                        const Walk& walk) {
  using F = Fwd<D>;
  tma_prefetch(tq);
  tma_prefetch(tk);
  tma_prefetch(tv);
  mbar_expect_tx(bar.q_full, F::kTile);
#pragma unroll
  for (int x = 0; x < F::kBoxes; ++x)
    tma_load_4d(smem + x * F::kBox, tq, bar.q_full, x * F::kBoxCols, h, q0, b);
  const int n = walk.count();
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = walk.key0(i);
    uint8_t* kt = smem + F::kTile + st * 2 * F::kTile;
    mbar_wait(bar.k_empty + st, ph ^ 1);
    mbar_expect_tx(bar.k_full + st, F::kTile);
#pragma unroll
    for (int x = 0; x < F::kBoxes; ++x)
      tma_load_4d(kt + x * F::kBox, tk, bar.k_full + st, x * F::kBoxCols, h,
                  k0, b);
    mbar_wait(bar.v_empty + st, ph ^ 1);
    mbar_expect_tx(bar.v_full + st, F::kTile);
#pragma unroll
    for (int x = 0; x < F::kBoxes; ++x)
      tma_load_4d(kt + F::kTile + x * F::kBox, tv, bar.v_full + st,
                  x * F::kBoxCols, h, k0, b);
  }
}

// The online softmax of one tile's scores s (the m64n128 accumulator; this
// thread's rows r0 and r0 + 8, keys k0 + 8 j + 2 t + (e % 2) of s[4 j + e]):
// masks (mode 1), updates m and l, puts p in s and returns each row's
// rescale in alpha. m is in the scores' units; c takes them to log2 units.
template <class Walk>
__device__ __forceinline__ void softmax_tile(float (&s)[64], int mode,
                                             const Walk& walk, int k0, int r0,
                                             int t, float mask, float c,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  if (mode == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!walk.keep(r0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)))
          s[4 * j + e] = mask;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(s[2 * r], s[2 * r + 1]);
#pragma unroll
    for (int j = 1; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float m_use = (Walk::kFlash && m_new == -INFINITY) ? 0.f : m_new;
    const float mc = m_use * c;
    alpha[r] = ex2((m[r] - m_use) * c);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mc));
        sum += s[4 * j + e];
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// A consumer warpgroup: rows w0 .. w0 + 63 of the block, tile by tile in
// turns with the other consumer (see the notes at the top).
template <int D, class Walk>
__device__ __forceinline__ void consume(const uint8_t* smem, const Bars& bar,
                                        uint16_t* __restrict__ o,
                                        float* __restrict__ lse, int L, int H,
                                        int q0, int h, int b, const Walk& walk,
                                        float mask, float c, float lse_scale) {
  using F = Fwd<D>;
  constexpr int NO = D / 2;  // o's accumulator floats per thread
  constexpr bool kSplit = !Walk::kFlash;
  // warpgroup, tile count and modes broadcast from lane 0: ptxas then sees
  // every branch around a wgmma as uniform (a wgmma on a path it cannot
  // prove uniform is serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + kWgRows * wg;
  const int r0 = w0 + 16 * (tid >> 5) + g;  // this thread's rows r0, r0 + 8
  const int n = __shfl_sync(0xffffffffu, walk.count(), 0);
  const uint32_t q_s = smem_u32(smem) + wg * kWgRows * F::kSpan;
  const uint32_t ring = smem_u32(smem) + F::kTile;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float s[64];
  uint32_t p[32], pl[32];  // p (hi) and, for splash, p_lo as A fragments
  float m[2] = {mask, mask}, l[2] = {0.f, 0.f};
  bool pending = false;  // p of the last tile waits for its p v
  int ps = 0;            // that tile's stage and parity
  uint32_t pph = 0;

  mbar_wait(bar.q_full, 0);
  for (int i = 0; i <= n; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const bool cur = i < n;
    const int mode = __shfl_sync(0xffffffffu, cur ? walk.mode(i, w0) : -1, 0);
    // the turn: consumer 0 first; each turn ends with the other's
    if (wg == 0) {
      if (i > 0) bar_sync(kTurn0, 256);
    } else {
      bar_sync(kTurn1, 256);
    }
    if (i > 0) mbar_wait(bar.v_full + ps, pph);
    if (cur) mbar_wait(bar.k_full + st, ph);
#pragma unroll
    for (int x = 0; x < NO; ++x) reg_fence(acc[x]);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      reg_fence(p[x]);
      if constexpr (kSplit) reg_fence(pl[x]);
    }
    wgmma_fence();
    if (pending) {
      const uint32_t vb = ring + ps * 2 * F::kTile + F::kTile;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv =
            gmma_desc(vb + kk * 16 * F::kSpan, F::kBox, F::kAtom, F::kLayout);
        if constexpr (kSplit) {
          const uint32_t a[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                 pl[4 * kk + 3]};
          wgmma_rs<D>(acc, a, dv);
        }
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<D>(acc, a, dv);
      }
    }
    if (cur && mode >= 0) {
      const uint32_t kb = ring + st * 2 * F::kTile;
      constexpr int KS = F::kBoxCols / 16;  // k-steps per box
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / KS) * F::kBox + 32 * (kk % KS);
        wgmma_ss_n128(s, gmma_desc(q_s + off, 16, F::kAtom, F::kLayout),
                      gmma_desc(kb + off, 16, F::kAtom, F::kLayout), kk > 0);
      }
    }
    wgmma_commit();
    if (wg == 0) {
      bar_arrive(kTurn1, 256);
    } else if (cur) {
      bar_arrive(kTurn0, 256);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < NO; ++x) reg_fence(acc[x]);
#pragma unroll
    for (int x = 0; x < 64; ++x) reg_fence(s[x]);
    // the last tile's V and this tile's K are read: release them
    if (i > 0 && lane == 0) mbar_arrive(bar.v_empty + ps);
    if (cur && lane == 0) mbar_arrive(bar.k_empty + st);
    pending = cur && mode >= 0;
    ps = st;
    pph = ph;
    if (!pending) continue;
    float alpha[2];
    softmax_tile(s, mode, walk, walk.key0(i), r0, t, mask, c, m, l, alpha);
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] *= alpha[(x >> 1) & 1];
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      p[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
      if constexpr (kSplit)
        pl[x] = pack_bf16(s[2 * x] - bf16_lo(p[x]),
                          s[2 * x + 1] - bf16_hi(p[x]));
    }
  }

  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long lbase = ((long long)b * H + h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = r0 + 8 * r;
    if (row >= L) continue;
    const float inv = 1.f / lr;
    uint16_t* out = o + base + row * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (t == 0) lse[lbase + row] = m[r] * lse_scale + logf(lr);
  }
}

// The forward of the block's 128 query rows from q0 of head h, batch row b,
// over the tiles ``walk`` lists. Masked scores take ``mask``, where m also
// starts; c takes scores to log2 units (flash: scale log2(e)), lse_scale
// takes m to the natural units of lse (flash: scale). smem_raw: the
// block's dynamic shared memory, Fwd<D>::kSmem bytes.
template <int D, class Walk>
__device__ __forceinline__ void attn_fwd_ws(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    uint16_t* __restrict__ o, float* __restrict__ lse, int L, int H, int q0,
    int h, int b, const Walk& walk, float mask, float c, float lse_scale,
    uint8_t* smem_raw) {
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars bar(reinterpret_cast<uint64_t*>(smem + Fwd<D>::kBars));
  if (threadIdx.x == 0) {
    mbar_init(bar.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full + s, 1);
      mbar_init(bar.v_full + s, 1);
      mbar_init(bar.k_empty + s, kConsumerWarps);
      mbar_init(bar.v_empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // one if / else for the whole kernel: the roles never meet again
  if (__shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) produce<D>(tq, tk, tv, smem, bar, q0, h, b, walk);
  } else {
    regs_alloc<kConsumerRegs>();
    consume<D>(smem, bar, o, lse, L, H, q0, h, b, walk, mask, c, lse_scale);
  }
}

// Tensor maps of q, k, v [B, L, H, D] bf16 for the core's boxes, then the
// launch with the ring's dynamic shared memory opted in; returns a
// cudaError_t as int.
template <int D, typename Kernel, typename... Args>
int launch_ws(Kernel kernel, dim3 grid, cudaStream_t stream, const void* q,
              const void* k, const void* v, int B, int L, int H,
              Args... args) {
  CUtensorMap tq, tk, tv;
  int e = bf16_bthd_map(&tq, q, B, L, H, D, kRows, Fwd<D>::kBoxCols);
  if (e == 0) e = bf16_bthd_map(&tk, k, B, L, H, D, kKeys, Fwd<D>::kBoxCols);
  if (e == 0) e = bf16_bthd_map(&tv, v, B, L, H, D, kKeys, Fwd<D>::kBoxCols);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Fwd<D>::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, kThreads, Fwd<D>::kSmem, stream>>>(tq, tk, tv, args...);
  return (int)cudaGetLastError();
}

}  // namespace dl4j_attn_ws
