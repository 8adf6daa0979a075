// The bf16 dK/dV core of the attention backward, designed for Hopper
// (sm_90a): dk and dv of one block's 128 keys from bf16 q, k, v, dO, under
// the splash and flash dK/dV kernels (splash_attention_bwd.cu,
// flash_attention_bwd.cu). All four products on wgmma with f32
// accumulators, q and dO through a TMA ring, two consumer warpgroups.
//
// Replaces, at bf16, the dK/dV Pallas TPU kernels behind
// deeplearning4j_tpu/ops/pallas_kernels.py `_splash_call` (:609; the
// library's `_splash_attention_bwd_dkv`, splash_attention_kernel.py :1857,
// pallas_call :2196) and `_flash_call` (:589; `_flash_attention_bwd_dkv`,
// flash_attention.py :941, pallas_call :1121), and the mma.sync core that
// preceded it here. q, k, v, dO, dk, dv [B, L, H, D] bf16, lse and di
// [B, H, L] f32. Per kept (query, key) pair:
//
//   p  = exp(s - lse)        s = q k^T in f32 (splash: q pre-scaled; flash:
//                            times scale); masked pairs take the mask value
//                            (splash) or -inf (flash), so p = 0
//   ds = p * (dO v^T - di)   dO v^T in f32; flash: ds times scale
//   dv = bf16(p)^T dO,  dk = bf16(ds)^T q    in f32, written in bf16
//
// which are the libraries' roundings: p and ds go to bf16 before the two
// products (flash :900 and, after its scale, :918; splash :1788, :1804),
// dk and dv accumulate in f32: each tile's product summed on the tensor
// cores in a fresh accumulator, then added to dk or dv in one f32 add.
//
// What bounds it on this card: operations, 8 D per kept pair (s
// recomputed, dO v^T, p^T dO, ds^T q) at 989 TFLOP/s (bf16 dense): 2.224 ms
// at [1, 32768, 4, 128] causal, 0.1390 ms at [1, 8192, 4, 128] causal. The
// mma.sync core it replaces reached 0.22-0.25 of it on an H100: 8 warps
// of 253-255 registers, dk and dv in 128 of them, so query tiles of 32
// rows, a 2-stage cp.async ring that all 256 threads fed with a
// __syncthreads per tile, every warp re-reading q and dO by ldmatrix, and
// the exp and ds in series with the products. What this design does:
//   - a block of two warpgroups (256 threads, one block per SM), each
//     owning 64 of the block's 128 keys, the M of every wgmma. No producer
//     warps: ptxas holds every thread of this kernel to what the launch
//     gives it whatever setmaxnreg.inc asks, and a warp past the eighth
//     puts three warps on one of the SM's four register files, which cuts
//     every thread to 168 registers (too few at D = 128: the core spilled
//     280-340 bytes there and ptxas serialised its wgmmas). Eight warps
//     leave each thread 255. TMA does the loading instead: thread 0
//     issues k, v and the ring's first tiles, and the warpgroup that
//     finishes a tile second (a counter per stage in shared memory) issues
//     the loads that refill its stage;
//   - TMA and an mbarrier ring: k and v of the block once (their own
//     barrier); q and dO tiles of 64 query rows through kStages stages, a
//     full barrier per stage for q and for dO apart. lse (times log2(e))
//     and di of the next tile's rows are loaded by each warpgroup's 128
//     threads, one value each, under this tile's products, into a double
//     buffer of its own (one named barrier a tile). Rows past L (flash's
//     ragged tail) come from TMA as zeros, with lse +inf and di 0, so p =
//     ds = 0 there: no mask code for them. Keys past L are computed and
//     never stored. Tensor maps over [B, L, H, D] built by the host per
//     launch (sm90_common.cuh); rows of 128, 64 or 32 bytes swizzled by that
//     span (D = 128 as two 64-column boxes, 64, 32, 16). The splash
//     kernel fetches only the q blocks its dK/dV table column lists;
//   - the four products on wgmma, no transpose in shared memory: s^T = k q^T
//     and dp^T = v dO^T as m64n64k16 with both operands K-major in shared
//     memory (D / 16 k-steps); dv += bf16(p^T) dO and dk += bf16(ds^T) q in
//     the RS form m64nDk16: the f32 accumulator of s^T or dp^T packed to
//     bf16 pairs is already the A fragment, and dO or q is B through an
//     MN-major (transposed) descriptor, 4 k-steps over the tile's 64 rows;
//   - overlap: dp^T's wgmma is issued before the exp of s^T and waited for
//     only when ds needs it; ds and both A fragments are made pair by pair,
//     so p and dp^T die as they are packed; dv's and dk's products run one
//     after the other through one fresh accumulator; the two warpgroups
//     interleave on the tensor cores, one's exp and ds under the other's
//     products. p = exp2(fma(s, c, -lse log2(e))) on ex2.approx, c = scale
//     log2(e) for flash, log2(e) for splash. Only tiles the mask cuts (a
//     kind-1 block, flash's causal
//     diagonal) run mask code; a warpgroup skips the math of a tile whose
//     every pair is masked for its 64 keys, but not the tile's barriers;
//   - the grid keeps the heaviest-first order (key block 0 first under
//     causal; the table's columns for splash); dk and dv go from registers
//     to global memory for keys < L, each element written once: no atomics
//     on the outputs, so every launch gives the same bits.
//
// The query tile is 64 rows at every head dim: at D = 128 a thread holds
// dk and dv (2 x 64 f32) and s^T and dp^T (2 x 32), which give way to
// their bf16 A fragments (2 x 16) and a tile's product (64); a 128-row
// tile would need 64 more and does not fit at D = 128, so one tile shape
// serves all four.
//
// Shared memory: k + v 64 KiB + kStages x (q + dO 32 KiB) + the lse and di
// buffers 2 KiB = 162 KiB at D = 128 (82 KiB at D = 64), plus the barriers
// and 1 KiB to align the tiles on 1024 bytes, where the 128-byte swizzle
// repeats.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "tc_common.cuh"  // pack_bf16, attrs

namespace dl4j_attn_dkv {

using namespace dl4j_sm90;
using dl4j_tc::pack_bf16;

constexpr int kKeys = 128;     // keys per block
constexpr int kWgKeys = 64;    // keys per warpgroup
constexpr int kQT = 64;        // query rows per q / dO tile
constexpr int kStages = 3;     // q / dO tiles in the ring
constexpr int kThreads = 256;  // two warpgroups
constexpr int kRowsBar = 1;    // named barriers kRowsBar + warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dkv {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kBoxCols = D > 64 ? 64 : D;  // columns of a TMA box
  static constexpr int kBoxes = D / kBoxCols;       // boxes across a row
  static constexpr int kSpan = 2 * kBoxCols;        // bytes of a box row
  static constexpr uint32_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
  static constexpr int kAtom = 8 * kSpan;      // bytes of 8 swizzled rows
  static constexpr int kKBox = kKeys * kSpan;  // a 128-row box of k or v
  static constexpr int kKV = kBoxes * kKBox;   // k or v of the block
  static constexpr int kQBox = kQT * kSpan;    // a 64-row box of q or dO
  static constexpr int kQ = kBoxes * kQBox;    // one q or dO tile
  static constexpr int kQOff = 2 * kKV;        // the q tiles, then dO's
  static constexpr int kDoOff = kQOff + kStages * kQ;
  // per warpgroup two buffers of a tile's lse (times log2(e)) and di, f32
  static constexpr int kRowsOff = kDoOff + kStages * kQ;
  static constexpr int kRows = 2 * kQT;  // floats a buffer
  static constexpr int kBars = kRowsOff + 2 * 2 * kRows * 4;
  // the barriers (k and v, then q and dO full per stage), then the
  // stages' counters of warpgroups done with them
  static constexpr int kCounts = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = kCounts + 4 * kStages + 1024;
};

struct Bars {
  uint64_t* kv_full;
  uint64_t* q_full;
  uint64_t* do_full;
  __device__ explicit Bars(uint64_t* b)
      : kv_full(b), q_full(b + 1), do_full(b + 1 + kStages) {}
};

// The TMA loads of tile i's q and dO into stage st, each on its full
// barrier (one thread).
template <int D, class Walk>
__device__ __forceinline__ void load_tile(const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          uint8_t* smem, const Bars& bar,
                                          int i, int st, int h, int b,
                                          const Walk& walk) {
  using F = Dkv<D>;
  const int q0 = walk.q0(i);
  mbar_expect_tx(bar.q_full + st, F::kQ);
#pragma unroll
  for (int x = 0; x < F::kBoxes; ++x)
    tma_load_4d(smem + F::kQOff + st * F::kQ + x * F::kQBox, tq,
                bar.q_full + st, x * F::kBoxCols, h, q0, b);
  mbar_expect_tx(bar.do_full + st, F::kQ);
#pragma unroll
  for (int x = 0; x < F::kBoxes; ++x)
    tma_load_4d(smem + F::kDoOff + st * F::kQ + x * F::kQBox, tdo,
                bar.do_full + st, x * F::kBoxCols, h, q0, b);
}

// This thread's value of tile i's rows: lse times log2(e) for threads 0-63,
// di for 64-127, of row q0 + (thread % 64); +inf and 0 past L.
template <class Walk>
__device__ __forceinline__ float row_value(const float* __restrict__ lse,
                                           const float* __restrict__ di,
                                           long long lbase, int L, int tid,
                                           int i, const Walk& walk) {
  const int row = walk.q0(i) + (tid & (kQT - 1));
  const bool in = row < L;
  if (tid < kQT) return in ? __ldg(lse + lbase + row) * kLog2e : INFINITY;
  return in ? __ldg(di + lbase + row) : 0.f;
}

// A warpgroup: dk and dv of keys kw0 .. kw0 + 63, tile by tile, and the
// refills of the stages it finishes second.
template <int D, class Walk>
__device__ __forceinline__ void consume(
    const CUtensorMap* tq, const CUtensorMap* tdo, uint8_t* smem,
    const Bars& bar, const float* __restrict__ lse,
    const float* __restrict__ di, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, int L, int H, int k0, int h, int b,
    const Walk& walk, float mask, float c) {
  using F = Dkv<D>;
  constexpr int NA = D / 2;             // dk's or dv's floats per thread
  constexpr int KS = F::kBoxCols / 16;  // k-steps per box
  // warpgroup, tile count and modes broadcast from lane 0: ptxas then sees
  // every branch around a wgmma as uniform (a wgmma on a path it cannot
  // prove uniform is serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw0 = k0 + kWgKeys * wg;
  const int r0 = kw0 + 16 * (tid >> 5) + g;  // this thread's keys r0, r0 + 8
  const int n = __shfl_sync(0xffffffffu, walk.count(), 0);
  const long long lbase = ((long long)b * H + h) * L;
  const uint32_t k_s = smem_u32(smem) + wg * kWgKeys * F::kSpan;
  const uint32_t v_s = k_s + F::kKV;
  const uint32_t q_ring = smem_u32(smem) + F::kQOff;
  const uint32_t do_ring = smem_u32(smem) + F::kDoOff;
  float* rows =
      reinterpret_cast<float*>(smem + F::kRowsOff) + wg * 2 * F::kRows;
  int* done = reinterpret_cast<int*>(smem + F::kCounts);

  float adk[NA], adv[NA], tile[NA];  // dk, dv; one tile's product
#pragma unroll
  for (int x = 0; x < NA; ++x) adk[x] = adv[x] = 0.f;
  float s[32], dp[32];      // s^T, then p; dp^T, then ds (keys x queries)
  uint32_t pa[16], da[16];  // bf16(p^T), bf16(ds^T) as A fragments

  if (n > 0) rows[tid] = row_value(lse, di, lbase, L, tid, 0, walk);
  bar_sync(kRowsBar + wg, 128);
  mbar_wait(bar.kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int mode = __shfl_sync(0xffffffffu, walk.mode(i, kw0), 0);
    // the next tile's row value, loaded under this tile's products
    const float next =
        i + 1 < n ? row_value(lse, di, lbase, L, tid, i + 1, walk) : 0.f;
    mbar_wait(bar.q_full + st, ph);
    mbar_wait(bar.do_full + st, ph);
    if (mode >= 0) {
      const uint32_t qb = q_ring + st * F::kQ;
      const uint32_t db = do_ring + st * F::kQ;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KS) * F::kKBox + 32 * (kk % KS);
        const uint32_t qa = (kk / KS) * F::kQBox + 32 * (kk % KS);
        const uint64_t a = gmma_desc(k_s + ka, 16, F::kAtom, F::kLayout);
        const uint64_t bq = gmma_desc(qb + qa, 16, F::kAtom, F::kLayout);
        if (kk == 0) wgmma_ss_n64_first(s, a, bq);
        else wgmma_ss_n64(s, a, bq);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk / KS) * F::kKBox + 32 * (kk % KS);
        const uint32_t qa = (kk / KS) * F::kQBox + 32 * (kk % KS);
        const uint64_t a = gmma_desc(v_s + ka, 16, F::kAtom, F::kLayout);
        const uint64_t bo = gmma_desc(db + qa, 16, F::kAtom, F::kLayout);
        if (kk == 0) wgmma_ss_n64_first(dp, a, bo);
        else wgmma_ss_n64(dp, a, bo);
      }
      wgmma_commit();
      wgmma_wait<1>();  // s^T
#pragma unroll
      for (int x = 0; x < 32; ++x) reg_fence(s[x]);
      const float* lse_t = rows + (i & 1) * F::kRows;
      const float* di_t = lse_t + kQT;
      const int q0 = walk.q0(i);
      // s[4 j + e]: key r0 + 8 (e / 2), query q0 + 8 j + 2 t + (e % 2)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e];
          if (mode == 1 && !walk.keep(q0 + 8 * j + 2 * t + (e & 1),
                                      r0 + 8 * (e >> 1)))
            x = mask;
          s[4 * j + e] = ex2(fmaf(x, c, -((e & 1) ? l2.y : l2.x)));
        }
      }
      wgmma_wait<0>();  // dp^T
#pragma unroll
      for (int x = 0; x < 32; ++x) reg_fence(dp[x]);
      // ds, and both A fragments pair by pair, so that p and dp^T die as
      // they are packed
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          float ds0 = s[4 * j + e] * (dp[4 * j + e] - d2.x);
          float ds1 = s[4 * j + e + 1] * (dp[4 * j + e + 1] - d2.y);
          if constexpr (Walk::kFlash) {
            ds0 *= walk.scale;
            ds1 *= walk.scale;
          }
          pa[2 * j + e / 2] = pack_bf16(s[4 * j + e], s[4 * j + e + 1]);
          da[2 * j + e / 2] = pack_bf16(ds0, ds1);
        }
      }
      // this tile's p^T dO, then ds^T q, each summed in a fresh
      // accumulator and joined to dv or dk in one f32 add: a wgmma chain
      // over all of the walk's tiles rounds worse than the libraries' sums
#pragma unroll
      for (int x = 0; x < NA; ++x) tile[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<D>(tile, a,
                    gmma_desc(db + kk * 16 * F::kSpan, F::kQBox, F::kAtom,
                              F::kLayout));
      }
      wgmma_commit();
      wgmma_wait<0>();  // p^T dO: this tile's dO is read
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        reg_fence(tile[x]);
        adv[x] += tile[x];
        tile[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) reg_fence(pa[x]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                               da[4 * kk + 3]};
        wgmma_rs<D>(tile, a,
                    gmma_desc(qb + kk * 16 * F::kSpan, F::kQBox, F::kAtom,
                              F::kLayout));
      }
      wgmma_commit();
      wgmma_wait<0>();  // ds^T q: and its q
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        reg_fence(tile[x]);
        adk[x] += tile[x];
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) reg_fence(da[x]);
    }
    // the warpgroup done with the stage second refills it
    if (tid == 0) {
      __threadfence_block();
      if ((atomicAdd(done + st, 1) & 1) && i + kStages < n) {
        __threadfence_block();
        load_tile<D>(tq, tdo, smem, bar, i + kStages, st, h, b, walk);
      }
    }
    rows[((i + 1) & 1) * F::kRows + tid] = next;
    bar_sync(kRowsBar + wg, 128);
  }

  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= L) continue;
    uint16_t* ok = dk + base + key * rs;
    uint16_t* ov = dv + base + key * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(ok + 8 * j + 2 * t) =
          pack_bf16(adk[4 * j + 2 * r], adk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(ov + 8 * j + 2 * t) =
          pack_bf16(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

// dk and dv of the block's 128 keys from k0 of head h, batch row b, over the
// query tiles ``walk`` lists. Masked pairs take ``mask``; c takes scores to
// log2 units (flash: scale log2(e)); flash also scales ds (walk.scale)
// before its rounding, as the library applies it, so dk takes none at the
// store. smem_raw: the block's dynamic shared memory, Dkv<D>::kSmem bytes.
template <int D, class Walk>
__device__ __forceinline__ void attn_dkv_ws(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const float* __restrict__ lse,
    const float* __restrict__ di, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, int L, int H, int k0, int h, int b,
    const Walk& walk, float mask, float c, uint8_t* smem_raw) {
  using F = Dkv<D>;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars bar(reinterpret_cast<uint64_t*>(smem + F::kBars));
  if (threadIdx.x == 0) {
    mbar_init(bar.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.q_full + s, 1);
      mbar_init(bar.do_full + s, 1);
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
    mbar_expect_tx(bar.kv_full, 2 * F::kKV);
#pragma unroll
    for (int x = 0; x < F::kBoxes; ++x) {
      tma_load_4d(smem + x * F::kKBox, tk, bar.kv_full, x * F::kBoxCols, h,
                  k0, b);
      tma_load_4d(smem + F::kKV + x * F::kKBox, tv, bar.kv_full,
                  x * F::kBoxCols, h, k0, b);
    }
    const int n = walk.count();
    for (int i = 0; i < kStages && i < n; ++i)
      load_tile<D>(tq, tdo, smem, bar, i, i, h, b, walk);
  }
  consume<D>(tq, tdo, smem, bar, lse, di, dk, dv, L, H, k0, h, b, walk, mask,
             c);
}

// Tensor maps of q, dO (64-row boxes), k and v (128-row boxes) [B, L, H, D]
// bf16, then the launch with the ring's dynamic shared memory opted in;
// returns a cudaError_t as int.
template <int D, typename Kernel, typename... Args>
int launch_dkv(Kernel kernel, dim3 grid, cudaStream_t stream, const void* q,
               const void* k, const void* v, const void* dout, int B, int L,
               int H, Args... args) {
  constexpr int C = Dkv<D>::kBoxCols;
  CUtensorMap tq, tdo, tk, tv;
  int e = bf16_bthd_map(&tq, q, B, L, H, D, kQT, C);
  if (e == 0) e = bf16_bthd_map(&tdo, dout, B, L, H, D, kQT, C);
  if (e == 0) e = bf16_bthd_map(&tk, k, B, L, H, D, kKeys, C);
  if (e == 0) e = bf16_bthd_map(&tv, v, B, L, H, D, kKeys, C);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Dkv<D>::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, kThreads, Dkv<D>::kSmem, stream>>>(tq, tdo, tk, tv, args...);
  return (int)cudaGetLastError();
}

}  // namespace dl4j_attn_dkv
