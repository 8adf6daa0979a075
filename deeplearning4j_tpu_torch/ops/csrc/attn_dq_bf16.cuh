// The bf16 dQ core of the attention backward, designed for Hopper (sm_90a):
// dq of one block's 128 query rows from bf16 q, k, v, dO, under the splash
// and flash dQ kernels (splash_attention_bwd.cu, flash_attention_bwd.cu).
// All three products on wgmma with f32 accumulators, k and v through a TMA
// ring, two warpgroups.
//
// Replaces, at bf16, the dQ Pallas TPU kernels behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_splash_call` (:609; the
// library's `_splash_attention_bwd_dq`, splash_attention_kernel.py :1405,
// pallas_call :1635) and `_flash_call` (:589; `_flash_attention_bwd_dq`,
// flash_attention.py, pallas_call :1456), and the mma.sync core that
// preceded it here. q, k, v, dO, dq [B, L, H, D] bf16, lse and di [B, H, L]
// f32. Per kept (query, key) pair:
//
//   p  = exp(s - lse)        s = q k^T in f32 (splash: q pre-scaled; flash:
//                            times scale); masked pairs take the mask value
//                            (splash) or -inf (flash), so p = 0
//   ds = p * (dO v^T - di)   dO v^T in f32; flash: ds times scale
//   dq = bf16(ds) k          in f32, written in bf16
//
// which are the libraries' roundings: ds goes to bf16 before ds k (flash
// `ds.astype(k.dtype)` after its scale, flash_attention.py :1258; splash
// :1395), and dq accumulates in f32 as both libraries add each kv block's
// product to an f32 scratch (splash :1392-1396, flash :1248-1258): here
// each 64-key tile's product is summed on the tensor cores in a fresh
// accumulator, then added to dq in one f32 add.
//
// What bounds it on this card: operations, 6 D per kept pair (s, dO v^T,
// ds k) at 989 TFLOP/s (bf16 dense): 1.668 ms at [1, 32768, 4, 128] causal,
// 0.1042 ms at [1, 8192, 4, 128] causal. The mma.sync core it replaces
// reached 0.23-0.27 of it on an H100: 8 warps of 16 query rows and 227-252
// registers, K and V through a 2-stage cp.async ring that all 256 threads
// fed with a __syncthreads per tile, every warp re-reading the whole K and
// V tile by ldmatrix, and expf, the mask and ds in series with the
// products in the same warps. What this design does:
//   - a block of two warpgroups (256 threads, one block per SM), each
//     owning 64 of the block's 128 query rows, the M of every wgmma. No
//     producer warps, as in the dK/dV core: thread 0 issues the TMA loads
//     of q, dO and the ring's first tiles, and the warpgroup that finishes
//     a tile second (a counter per stage in shared memory) issues the
//     loads that refill its stage. (ptxas fits this core in 154-167
//     registers a thread at D = 128, under the 168 that a third
//     warpgroup would leave: a producer or a third consumer warpgroup is
//     untried.)
//   - TMA and an mbarrier ring: q and dO of the block once (their own
//     barrier); k and v tiles of 64 keys through kStages stages, a full
//     barrier per stage for k and for v apart, so s can start before v
//     lands. A thread's two rows' lse (times log2(e)) and di stay in
//     registers for the whole walk. Rows past L (flash's ragged tail) come
//     from TMA as zeros, with lse +inf and di 0, so p = ds = 0 there, and
//     they are never stored. Keys past L are the reduction axis: the walk
//     masks them (mode 1). Tensor maps over [B, L, H, D] built by the host
//     per launch (sm90_common.cuh); rows of 128, 64 or 32 bytes swizzled by
//     that span (D = 128 as two 64-column boxes, 64, 32, 16). The splash
//     kernel fetches only the kv blocks its row of the dQ table lists, two
//     tiles each;
//   - the three products on wgmma, no transpose in shared memory: s = q k^T
//     and dp = dO v^T as m64n64k16 with both operands K-major (D / 16
//     k-steps); dq's tile product bf16(ds) k in the RS form m64nDk16: the
//     f32 accumulator of ds packed to bf16 pairs is already the A fragment,
//     and k is B through an MN-major (transposed) descriptor, 4 k-steps
//     over the tile's 64 keys;
//   - overlap: dp's wgmma is issued before the exp of s and waited for
//     only when ds needs it; ds is packed pair by pair, so p and dp die as
//     they are packed; the two warpgroups interleave on the tensor cores,
//     one's exp and ds under the other's products. Within a warpgroup a
//     tile's ds k is waited for before the next tile's s and dp are
//     issued: issuing them under it (the accumulators in flight across
//     the loop's back edge) made ptxas serialise every wgmma ("non wgmma
//     instructions defining accumulator registers of a wgmma between start
//     and end of the pipeline stage") and ran 1.33x slower on an H100. p =
//     exp2(fma(s, c, -lse log2(e))) on ex2.approx, c = scale log2(e) for
//     flash, log2(e) for splash. Only tiles the mask cuts (a kind-1 block,
//     flash's causal diagonal or its ragged last tile) run mask code; a
//     warpgroup skips the math of a tile whose every pair is masked for
//     its 64 rows, but not the tile's barriers;
//   - the grid keeps the heaviest-first order (the last query block first
//     under causal; the dQ table's rows for splash); dq goes from registers
//     to global memory for rows < L, each element written once: no atomics,
//     so every launch gives the same bits.
//
// The tile is 64 keys at every head dim: at D = 128 a thread holds dq (64
// f32), s and dp (2 x 32), which give way to ds's A fragment (16), and a
// tile's product (64).
//
// Shared memory: q + dO 64 KiB + kStages x (k + v 32 KiB) = 224 KiB at D =
// 128 (112 KiB at D = 64), plus the barriers, the stages' counters and 1
// KiB to align the tiles on 1024 bytes, where the 128-byte swizzle repeats:
// 230,508 bytes of the 232,448 a block may have. Five stages ran 2-4%
// faster than four on an H100.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "tc_common.cuh"  // pack_bf16, attrs

namespace dl4j_attn_dq {

using namespace dl4j_sm90;
using dl4j_tc::pack_bf16;

constexpr int kRows = 128;     // query rows per block
constexpr int kWgRows = 64;    // query rows per warpgroup
constexpr int kKT = 64;        // keys per k / v tile
constexpr int kStages = 5;     // k / v tiles in the ring
constexpr int kThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dq {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kBoxCols = D > 64 ? 64 : D;  // columns of a TMA box
  static constexpr int kBoxes = D / kBoxCols;       // boxes across a row
  static constexpr int kSpan = 2 * kBoxCols;        // bytes of a box row
  static constexpr uint32_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
  static constexpr int kAtom = 8 * kSpan;      // bytes of 8 swizzled rows
  static constexpr int kQBox = kRows * kSpan;  // a 128-row box of q or dO
  static constexpr int kQ = kBoxes * kQBox;    // q or dO of the block
  static constexpr int kKBox = kKT * kSpan;    // a 64-row box of k or v
  static constexpr int kK = kBoxes * kKBox;    // one k or v tile
  static constexpr int kRing = 2 * kQ;         // q, dO, then the stages
  // the barriers (q and dO, then k and v full per stage), then the
  // stages' counters of warpgroups done with them
  static constexpr int kBars = kRing + kStages * 2 * kK;
  static constexpr int kCounts = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = kCounts + 4 * kStages + 1024;
};

struct Bars {
  uint64_t* qdo_full;
  uint64_t* k_full;
  uint64_t* v_full;
  __device__ explicit Bars(uint64_t* b)
      : qdo_full(b), k_full(b + 1), v_full(b + 1 + kStages) {}
};

// The TMA loads of tile i's k and v into stage st, each on its full
// barrier (one thread).
template <int D, class Walk>
__device__ __forceinline__ void load_tile(const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          uint8_t* smem, const Bars& bar,
                                          int i, int st, int h, int b,
                                          const Walk& walk) {
  using F = Dq<D>;
  const int k0 = walk.key0(i);
  uint8_t* kt = smem + F::kRing + st * 2 * F::kK;
  mbar_expect_tx(bar.k_full + st, F::kK);
#pragma unroll
  for (int x = 0; x < F::kBoxes; ++x)
    tma_load_4d(kt + x * F::kKBox, tk, bar.k_full + st, x * F::kBoxCols, h,
                k0, b);
  mbar_expect_tx(bar.v_full + st, F::kK);
#pragma unroll
  for (int x = 0; x < F::kBoxes; ++x)
    tma_load_4d(kt + F::kK + x * F::kKBox, tv, bar.v_full + st,
                x * F::kBoxCols, h, k0, b);
}

// A warpgroup: dq of rows w0 .. w0 + 63, tile by tile, and the refills of
// the stages it finishes second.
template <int D, class Walk>
__device__ __forceinline__ void consume(
    const CUtensorMap* tk, const CUtensorMap* tv, uint8_t* smem,
    const Bars& bar, const float* __restrict__ lse,
    const float* __restrict__ di, uint16_t* __restrict__ dq, int L, int H,
    int q0, int h, int b, const Walk& walk, float mask, float c) {
  using F = Dq<D>;
  constexpr int NA = D / 2;  // dq's floats per thread
  // warpgroup, tile count and modes broadcast from lane 0: ptxas then sees
  // every branch around a wgmma as uniform (a wgmma on a path it cannot
  // prove uniform is serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + kWgRows * wg;
  const int r0 = w0 + 16 * (tid >> 5) + g;  // this thread's rows r0, r0 + 8
  const int n = __shfl_sync(0xffffffffu, walk.count(), 0);
  const long long lbase = ((long long)b * H + h) * L;
  const uint32_t q_s = smem_u32(smem) + wg * kWgRows * F::kSpan;
  const uint32_t do_s = q_s + F::kQ;
  const uint32_t ring = smem_u32(smem) + F::kRing;

  // the rows' lse in log2 units, negated, and di, constant over the walk;
  // rows past L take lse +inf and di 0, so that p = ds = 0 there
  float nl[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool in = row < L;
    nl[r] = in ? -(__ldg(lse + lbase + row) * kLog2e) : -INFINITY;
    dr[r] = in ? __ldg(di + lbase + row) : 0.f;
  }
  float adq[NA], tile[NA];  // dq; one tile's product
#pragma unroll
  for (int x = 0; x < NA; ++x) adq[x] = tile[x] = 0.f;
  float s[32], dp[32];  // s, then p; dp (rows x keys)
  uint32_t da[16];      // bf16(ds) as A fragments

  mbar_wait(bar.qdo_full, 0);
  for (int i = 0; i < n; ++i) {
    const int mode = __shfl_sync(0xffffffffu, walk.mode(i, w0), 0);
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const uint32_t kb = ring + st * 2 * F::kK;
    constexpr int KS = F::kBoxCols / 16;  // k-steps per box
    // s = q k^T as soon as k lands, then dp = dO v^T once v has. Every
    // wgmma of a tile and its waits sit under one branch: a path that
    // ptxas cannot rule out, with a wgmma issued and not waited for,
    // serialises them all
    mbar_wait(bar.k_full + st, ph);
    if (mode < 0) {
      mbar_wait(bar.v_full + st, ph);
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = (kk / KS) * F::kQBox + 32 * (kk % KS);
        const uint32_t ka = (kk / KS) * F::kKBox + 32 * (kk % KS);
        const uint64_t a = gmma_desc(q_s + qa, 16, F::kAtom, F::kLayout);
        const uint64_t bk = gmma_desc(kb + ka, 16, F::kAtom, F::kLayout);
        if (kk == 0) wgmma_ss_n64_first(s, a, bk);
        else wgmma_ss_n64(s, a, bk);
      }
      wgmma_commit();
      mbar_wait(bar.v_full + st, ph);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = (kk / KS) * F::kQBox + 32 * (kk % KS);
        const uint32_t ka = (kk / KS) * F::kKBox + 32 * (kk % KS);
        const uint64_t a = gmma_desc(do_s + qa, 16, F::kAtom, F::kLayout);
        const uint64_t bv =
            gmma_desc(kb + F::kK + ka, 16, F::kAtom, F::kLayout);
        if (kk == 0) wgmma_ss_n64_first(dp, a, bv);
        else wgmma_ss_n64(dp, a, bv);
      }
      wgmma_commit();
      wgmma_wait<1>();  // s
#pragma unroll
      for (int x = 0; x < 32; ++x) reg_fence(s[x]);
      const int k0 = walk.key0(i);
      // s[4 j + e]: row r0 + 8 (e / 2), key k0 + 8 j + 2 t + (e % 2)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e];
          if (mode == 1 &&
              !walk.keep(r0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)))
            x = mask;
          s[4 * j + e] = ex2(fmaf(x, c, nl[e >> 1]));
        }
      wgmma_wait<0>();  // dp
#pragma unroll
      for (int x = 0; x < 32; ++x) reg_fence(dp[x]);
      // ds packed pair by pair into the A fragment, so that p and dp die
      // as they are packed
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          float ds0 = s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]);
          float ds1 = s[4 * j + e + 1] * (dp[4 * j + e + 1] - dr[e >> 1]);
          if constexpr (Walk::kFlash) {
            ds0 *= walk.scale;
            ds1 *= walk.scale;
          }
          da[2 * j + e / 2] = pack_bf16(ds0, ds1);
        }
      // this tile's ds k, summed in a fresh accumulator and joined to dq
      // in one f32 add: a wgmma chain over the whole walk rounds worse
      // than the libraries' sums
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                               da[4 * kk + 3]};
        wgmma_rs<D>(tile, a,
                    gmma_desc(kb + kk * 16 * F::kSpan, F::kKBox, F::kAtom,
                              F::kLayout));
      }
      wgmma_commit();
      wgmma_wait<0>();  // ds k: this tile's k is read
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        reg_fence(tile[x]);
        adq[x] += tile[x];
        tile[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) reg_fence(da[x]);
    }
    // the warpgroup done with the stage second refills it
    if (tid == 0) {
      __threadfence_block();
      int* done = reinterpret_cast<int*>(smem + F::kCounts);
      if ((atomicAdd(done + st, 1) & 1) && i + kStages < n) {
        __threadfence_block();
        load_tile<D>(tk, tv, smem, bar, i + kStages, st, h, b, walk);
      }
    }
  }

  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= L) continue;
    uint16_t* out = dq + base + row * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack_bf16(adq[4 * j + 2 * r], adq[4 * j + 2 * r + 1]);
  }
}

// dq of the block's 128 query rows from q0 of head h, batch row b, over the
// key tiles ``walk`` lists. Masked pairs take ``mask``; c takes scores to
// log2 units (flash: scale log2(e)); flash also scales ds (walk.scale)
// before its rounding, as the library applies it, so dq takes none at the
// store. smem_raw: the block's dynamic shared memory, Dq<D>::kSmem bytes.
template <int D, class Walk>
__device__ __forceinline__ void attn_dq_ws(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const float* __restrict__ lse,
    const float* __restrict__ di, uint16_t* __restrict__ dq, int L, int H,
    int q0, int h, int b, const Walk& walk, float mask, float c,
    uint8_t* smem_raw) {
  using F = Dq<D>;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars bar(reinterpret_cast<uint64_t*>(smem + F::kBars));
  if (threadIdx.x == 0) {
    mbar_init(bar.qdo_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full + s, 1);
      mbar_init(bar.v_full + s, 1);
      reinterpret_cast<int*>(smem + F::kCounts)[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch(tq);
    tma_prefetch(tdo);
    tma_prefetch(tk);
    tma_prefetch(tv);
    mbar_expect_tx(bar.qdo_full, 2 * F::kQ);
#pragma unroll
    for (int x = 0; x < F::kBoxes; ++x) {
      tma_load_4d(smem + x * F::kQBox, tq, bar.qdo_full, x * F::kBoxCols, h,
                  q0, b);
      tma_load_4d(smem + F::kQ + x * F::kQBox, tdo, bar.qdo_full,
                  x * F::kBoxCols, h, q0, b);
    }
    const int n = walk.count();
    for (int i = 0; i < kStages && i < n; ++i)
      load_tile<D>(tk, tv, smem, bar, i, i, h, b, walk);
  }
  consume<D>(tk, tv, smem, bar, lse, di, dq, L, H, q0, h, b, walk, mask, c);
}

// Tensor maps of q, dO (128-row boxes), k and v (64-row boxes) [B, L, H, D]
// bf16, then the launch with the ring's dynamic shared memory opted in;
// returns a cudaError_t as int.
template <int D, typename Kernel, typename... Args>
int launch_dq(Kernel kernel, dim3 grid, cudaStream_t stream, const void* q,
              const void* k, const void* v, const void* dout, int B, int L,
              int H, Args... args) {
  constexpr int C = Dq<D>::kBoxCols;
  CUtensorMap tq, tdo, tk, tv;
  int e = bf16_bthd_map(&tq, q, B, L, H, D, kRows, C);
  if (e == 0) e = bf16_bthd_map(&tdo, dout, B, L, H, D, kRows, C);
  if (e == 0) e = bf16_bthd_map(&tk, k, B, L, H, D, kKT, C);
  if (e == 0) e = bf16_bthd_map(&tv, v, B, L, H, D, kKT, C);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Dq<D>::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, kThreads, Dq<D>::kSmem, stream>>>(tq, tdo, tk, tv, args...);
  return (int)cudaGetLastError();
}

}  // namespace dl4j_attn_dq
