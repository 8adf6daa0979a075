// The forward core of the flash and splash attention kernels
// (flash_attention_fwd.cu, splash_attention_fwd.cu), Hopper (sm_90a): both
// products on the tensor cores in 3xTF32, K/V through an asynchronous ring in
// shared memory, the probabilities in registers.
//
// Layout: q, k, v, o are [B, L, H, D] f32, contiguous, 16-byte aligned (the
// wrappers check it), row stride H * D; lse is [B, H, L] f32.
//
// A CUDA block of 8 warps owns 128 query rows, warp w the 16 rows w0 = q0 +
// 16 w ... w0 + 15, and walks the keys in 64-key tiles. Lane (g, t) = (lane /
// 4, lane % 4) holds what `mma.sync.m16n8k8` tf32 assigns it:
//   - q of rows g and g + 8, read from the block's q tile in shared memory
//     and split anew for each key tile (in registers it spills at D = 128);
//   - s = q k^T of one tile, s[j][e] at row g + 8 (e / 2), key 8 j + 2 t +
//     (e % 2), the C fragments of 8 n-tiles of 8 keys;
//   - the output, acc[n][e] at row g + 8 (e / 2) and a head dim set below;
//     each tile's p v sums apart and joins acc in one fma (tile_pv).
// The softmax runs on the s fragments: the four lanes of a row reduce its max
// with two xor shuffles; each lane keeps a partial sum l, reduced once at the
// end. p then serves as the A operand of p v as it lies: the C fragment holds
// keys (2t, 2t + 1) where the A fragment wants columns (t, t + 4), so within
// each 8-key step column t is key 2t and column t + 4 key 2t + 1, and the B
// fragment reads V's rows in that order. No shared memory and no barrier
// between the two products.
//
// Head dims are relabelled too, so that every shared load is 16 bytes:
//   - q k^T: k-step 2i + h of the 16 dims 16i ... 16i + 15 pairs column t
//     (and t + 4) with d = 16i + 4t + 2h (and + 1): one float4 of k's row,
//     and one of q's, per two k-steps;
//   - p v: with G = 4 (G = 2 at D = 16), n-tile G m + p's column n is head dim
//     8 G m + G n + p: one float4 (float2) of v's row per G n-tiles, and the
//     epilogue writes 2 G consecutive dims of a row per m.
//
// Shared tiles hold [64][D] f32 rows without padding; 16-byte chunk c of row
// r sits at chunk c ^ f(r), f(r) = (r & 6) ^ ((r & 1) << 2) for D >= 32, so
// both the q and k float4 loads (two rows, four chunks per quarter warp) and
// the v loads (four rows, two chunks) touch 8 distinct chunk slots of a
// 128-byte line: no bank conflicts. At D = 16 (four chunks a row) f(r) = (r /
// 2) & 3. The q tile [128][D] keeps the same swizzle.
//
// 3xTF32 and why mma.sync, not wgmma: tc_common.cuh. The tensor cores
// truncate as they accumulate, so no accumulator chains across tiles
// (tile_pv). Plain TF32 keeps 11 significant bits: an error of about 4e-4
// of max |o| at L = 1024, D = 128 (tests/test_torch_attention_tc.py), over
// the 1e-5 the kernels are held to; the split keeps f32-class accuracy (5e-7
// there). At D = 128 the split's lo tiles of k and v would double the ring
// past the 227 KB a block may use, one more reason the split is made in
// registers.
//
// The ring: kStages K+V tile pairs behind the q tile; tile i + kStages - 1 is
// fetched with cp.async.cg (16 bytes, L1 bypassed) right after the barrier
// that opens tile i, so it lands during tile i's math. q comes with tile 0.
// Rows past L are zero-filled (src-size 0). One __syncthreads per tile.
// Shared memory: 96 KiB at D = 64, 192 KiB at D = 128: one block per SM.
//
// The two kernels differ in their walk (which tiles, which masks) and in how
// they treat masked scores; each keeps its own __global__ so the profiler
// sums them apart (chip_smoke.py keys "flash_fwd" and "splash_fwd"). The dQ
// core (attn_dq_tc.cuh) reuses the tiles, the ring and both products here.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace dl4j_attn_tc {

using namespace dl4j_tc;

constexpr int kRows = 128;          // query rows per block
constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kWarps = kRows / 16;  // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;          // K/V tile pairs in the ring

template <int D>
struct Fwd {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head dim");
  static constexpr int kChunks = D / 4;     // 16-byte chunks per row
  static constexpr int kTile = kKeys * D;   // floats of one K or V tile
  static constexpr int kQTile = kRows * D;  // floats of the q tile
  static constexpr size_t kSmem =
      ((size_t)kQTile + (size_t)kStages * 2 * kTile) * sizeof(float);
  static constexpr int kQK = D / 16;        // k-step pairs of q k^T
  static constexpr int kNT = D / 8;         // n-tiles of p v
  static constexpr int kG = D >= 32 ? 4 : 2;  // n-tiles per v load
  static constexpr int kVM = kNT / kG;      // v loads per key row
};

// Rows [row0, row0 + N) of one (b, h) slice (src points at its row 0) into
// a swizzled [N][D] tile; rows past L are zeros.
template <int D, int N>
__device__ __forceinline__ void copy_tile(float* tile,
                                          const float* __restrict__ src,
                                          int row0, int L, long long rs) {
  constexpr int C = Fwd<D>::kChunks;
#pragma unroll
  for (int it = 0; it < N * C / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / C;
    const int c = i % C;
    const int row = row0 + r;
    const bool in = row < L;
    cp_async16(tile + at<D>(r, c),
               src + (long long)(in ? row : 0) * rs + 4 * c, in);
  }
}

// s = q k^T of the warp's 16 rows (from row w of the q tile) and one tile of
// 8 NK keys, two k-steps (one float4 of q and of k) per iteration. The loop
// stays rolled: unrolled twice, it took the same time with the same spills.
template <int D, int NK = kKeys / 8>
__device__ __forceinline__ void tile_scores(const float* q_s, int w,
                                            const float* k_s, int g, int t,
                                            float (&s)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int i = 0; i < Fwd<D>::kQK; ++i) {
    const float4 q0 =
        *reinterpret_cast<const float4*>(q_s + at<D>(w + g, 4 * i + t));
    const float4 q1 =
        *reinterpret_cast<const float4*>(q_s + at<D>(w + g + 8, 4 * i + t));
    uint32_t ah[2][4], al[2][4];
    split(q0.x, ah[0][0], al[0][0]);
    split(q1.x, ah[0][1], al[0][1]);
    split(q0.y, ah[0][2], al[0][2]);
    split(q1.y, ah[0][3], al[0][3]);
    split(q0.z, ah[1][0], al[1][0]);
    split(q1.z, ah[1][1], al[1][1]);
    split(q0.w, ah[1][2], al[1][2]);
    split(q1.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(k_s + at<D>(8 * j + g, 4 * i + t));
      mma3(s[j], ah[0], al[0], kv.x, kv.y);
      mma3(s[j], ah[1], al[1], kv.z, kv.w);
    }
  }
}

// acc = acc * alpha + p v of the warp's 16 rows and one tile of 8 NK keys, p
// in s, alpha[r] the rescale of row g + 8 r. Each tile's p v sums in fresh
// accumulators and meets acc in one rounded f32 fma: the tensor cores
// truncate as they accumulate, and a chain through every tile of a long row
// drifts past the 1e-5 gate (L = 2048, full), a chain of one tile does not.
template <int D, int NK = kKeys / 8>
__device__ __forceinline__ void tile_pv(const float (&s)[NK][4],
                                        const float* v_s, int g, int t,
                                        const float (&alpha)[2],
                                        float (&acc)[D / 8][4]) {
  constexpr int G = Fwd<D>::kG;
#pragma unroll
  for (int m = 0; m < Fwd<D>::kVM; ++m) {
    const int d = 8 * G * m + G * g;  // first head dim of this lane's loads
    float part[G][4];
#pragma unroll
    for (int p = 0; p < G; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[p][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* r0 = v_s + at<D>(8 * j + 2 * t, d >> 2) + (d & 3);
      const float* r1 = v_s + at<D>(8 * j + 2 * t + 1, d >> 2) + (d & 3);
      float v0[G], v1[G];
      if constexpr (G == 4) {
        const float4 a = *reinterpret_cast<const float4*>(r0);
        const float4 b = *reinterpret_cast<const float4*>(r1);
        v0[0] = a.x; v0[1] = a.y; v0[2] = a.z; v0[3] = a.w;
        v1[0] = b.x; v1[1] = b.y; v1[2] = b.z; v1[3] = b.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(r0);
        const float2 b = *reinterpret_cast<const float2*>(r1);
        v0[0] = a.x; v0[1] = a.y;
        v1[0] = b.x; v1[1] = b.y;
      }
#pragma unroll
      for (int p = 0; p < G; ++p) mma3(part[p], ph, pl, v0[p], v1[p]);
    }
#pragma unroll
    for (int p = 0; p < G; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[G * m + p][e] = fmaf(acc[G * m + p][e], alpha[e >> 1], part[p][e]);
  }
}

// The walk of the flash forward: kv tiles 0 .. nk - 1, causal up to the
// diagonal; masked scores are -inf and take no part in max or sum.
template <bool kCausal>
struct FlashWalk {
  static constexpr bool kFlash = true;
  int L, nk;
  float scale;
  __device__ FlashWalk(int L_, int q0, float scale_) : L(L_), scale(scale_) {
    const int all = (L + kKeys - 1) / kKeys;
    nk = kCausal ? min(all, (q0 + kRows) / kKeys) : all;
  }
  __device__ int count() const { return nk; }
  __device__ int key0(int i) const { return i * kKeys; }
  // -1: the tile adds nothing to rows w0 .. w0 + 15; 0: no score of theirs
  // is masked; 1: some are
  __device__ int mode(int i, int w0) const {
    const int k0 = i * kKeys;
    if (w0 >= L || (kCausal && k0 > w0 + 15)) return -1;
    return (k0 + kKeys > L || (kCausal && k0 + kKeys - 1 > w0)) ? 1 : 0;
  }
  __device__ bool keep(int row, int col) const {
    return col < L && (!kCausal || col <= row);
  }
};

// Opt in to the ring's dynamic shared memory, then launch; returns the
// launch's cudaError_t as int.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Row g + 8 r of the warp's output fragments acc (the head dims of p v's
// relabelling), times mul, into out[0 .. D): dims 8 G mm + 2 G t + x, x < 2 G,
// are n-tile G mm + x % G, column 2t (x < G) or 2t + 1, so each lane writes
// 2 G consecutive floats per mm.
template <int D>
__device__ __forceinline__ void store_row(float* out,
                                          const float (&acc)[D / 8][4],
                                          int r, int t, float mul) {
  constexpr int G = Fwd<D>::kG;
#pragma unroll
  for (int mm = 0; mm < Fwd<D>::kVM; ++mm) {
    float w[2 * G];
#pragma unroll
    for (int x = 0; x < 2 * G; ++x)
      w[x] = acc[G * mm + x % G][2 * r + x / G] * mul;
#pragma unroll
    for (int x = 0; x < 2 * G; x += 4)
      *reinterpret_cast<float4*>(out + 8 * G * mm + 2 * G * t + x) =
          make_float4(w[x], w[x + 1], w[x + 2], w[x + 3]);
  }
}

// The forward of the block's 128 query rows from q0 of head h, batch row b,
// over the tiles ``walk`` lists. Walk gives count(), key0(i), mode(i, w0),
// keep(row, col) and kFlash: the flash forward scales the scores and guards
// m. Masked scores take ``mask``, where m also starts: -inf for flash, which
// takes no part in max or sum; the library's mask value for splash (q
// pre-scaled), which does, as in the library.
template <int D, class Walk>
__device__ __forceinline__ void attn_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int L, int H, int q0, int h, int b,
    const Walk& walk, float mask, float* smem) {
  constexpr int T = Fwd<D>::kTile;
  constexpr int NT = Fwd<D>::kNT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + 16 * (threadIdx.x >> 5);
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int n = walk.count();

  float* q_s = smem;
  auto fetch = [&](int i) {
    float* ks = smem + Fwd<D>::kQTile + (i % kStages) * 2 * T;
    const int k0 = walk.key0(i);
    copy_tile<D, kKeys>(ks, k + base, k0, L, rs);
    copy_tile<D, kKeys>(ks + T, v + base, k0, L, rs);
  };
  copy_tile<D, kRows>(q_s, q + base, q0, L, rs);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {mask, mask}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n) fetch(i + kStages - 1);
    cp_async_commit();
    const int mode = walk.mode(i, w0);
    if (mode < 0) continue;  // warp-uniform
    const float* k_s = smem + Fwd<D>::kQTile + (i % kStages) * 2 * T;
    float s[8][4];
    tile_scores<D>(q_s, w0 - q0, k_s, g, t, s);
    const int k0 = walk.key0(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Walk::kFlash) s[j][e] *= walk.scale;
        if (mode == 1 && !walk.keep(w0 + g + 8 * (e >> 1),
                                    k0 + 8 * j + 2 * t + (e & 1)))
          s[j][e] = mask;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[0][2 * r], s[0][2 * r + 1]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use =
          (Walk::kFlash && m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_use);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    tile_pv<D>(s, k_s + T, g, t, alpha, acc);
  }
  cp_async_wait<0>();

  const long long lbase = ((long long)b * H + h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = w0 + g + 8 * r;
    if (row >= L) continue;
    store_row<D>(o + base + row * rs, acc, r, t, 1.f / lr);
    if (t == 0) lse[lbase + row] = m[r] + logf(lr);
  }
}

}  // namespace dl4j_attn_tc
