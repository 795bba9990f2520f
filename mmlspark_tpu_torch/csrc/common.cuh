// Helpers shared by the port's kernels.
//
// Inputs come in f32 or bf16 (__nv_bfloat16); every kernel computes in f32
// and rounds to the input type only where the JAX kernels cast
// (mmt_round). The attention numerics follow the JAX package's Pallas
// kernels: masked scores take the -1e30 sentinel, the running
// max/normalizer/accumulator are updated once per key tile (m_new = max(m, max s); p = exp(s - m_new) on visible
// keys, 0 elsewhere; alpha = exp(m - m_new)), and the output is
// acc / max(l, 1e-30). Only the order of the f32 sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MMT_NEG_INF (-1e30f)
#define MMT_L_FLOOR (1e-30f)
#define MMT_FULL_MASK 0xffffffffu

// the largest head dim the kernels are instantiated for
constexpr int kMmtMaxHeadDim = 64;

// dtype codes of the C interface
constexpr int kMmtF32 = 0;
constexpr int kMmtBF16 = 1;

__device__ __forceinline__ float mmt_to_float(float x) { return x; }
__device__ __forceinline__ float mmt_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Store an f32 value as T (round to nearest even for bf16).
__device__ __forceinline__ void mmt_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void mmt_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and back: the JAX kernels' `.astype(input dtype)` before
// a product (identity for f32).
template <typename T>
__device__ __forceinline__ float mmt_round(float x);
template <>
__device__ __forceinline__ float mmt_round<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float mmt_round<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Prefill tiling: a block holds kMmtRows query rows, each split over 4
// adjacent lanes; lane `sub` of a row owns channels sub, sub + 4, sub + 8,
// ... (so the 4 lanes read 4 consecutive shared-memory words: no bank
// conflicts). K/V tiles of kMmtKeys rows are staged in shared memory.
constexpr int kMmtRows = 32;
constexpr int kMmtLanesPerRow = 4;
constexpr int kMmtThreads = kMmtRows * kMmtLanesPerRow;
constexpr int kMmtKeys = 32;

// One query row (this lane's q channels, its share of the output
// accumulator, and the row's running m, l) against one staged tile of
// kMmtKeys keys: ks/vs hold kMmtKeys rows of MAXD floats, zero past the
// head dim. Tile row r counts where vis(r) holds. Every lane of the warp
// must call it (the score reduction shuffles across the row's 4 lanes).
// P.V takes p rounded to P (the JAX kernels' p.astype(v.dtype)); l sums
// the unrounded p. A row that sees no key of the tile keeps m, l and acc
// exactly (alpha = exp(0), p = 0).
template <int MAXD, typename P, typename Vis>
__device__ __forceinline__ void mmt_online_tile_if(
    const float (&q)[MAXD / kMmtLanesPerRow],
    float (&acc)[MAXD / kMmtLanesPerRow], float& m, float& l,
    const float* __restrict__ ks, const float* __restrict__ vs, int sub,
    float scale, Vis vis) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  float s[kMmtKeys];
#pragma unroll
  for (int r = 0; r < kMmtKeys; ++r) {
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      dot = fmaf(q[c], ks[r * MAXD + c * kMmtLanesPerRow + sub], dot);
    s[r] = dot;
  }
  // butterfly over the row's 4 lanes: all 4 end with the same sums
#pragma unroll
  for (int r = 0; r < kMmtKeys; ++r) {
    s[r] += __shfl_xor_sync(MMT_FULL_MASK, s[r], 1);
    s[r] += __shfl_xor_sync(MMT_FULL_MASK, s[r], 2);
  }
  float mx = MMT_NEG_INF;
#pragma unroll
  for (int r = 0; r < kMmtKeys; ++r) {
    s[r] = vis(r) ? s[r] * scale : MMT_NEG_INF;
    mx = fmaxf(mx, s[r]);
  }
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kMmtKeys; ++r) {
    s[r] = vis(r) ? expf(s[r] - m_new) : 0.f;
    sum += s[r];
  }
  l = l * alpha + sum;
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] *= alpha;
#pragma unroll
  for (int r = 0; r < kMmtKeys; ++r)
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      acc[c] = fmaf(mmt_round<P>(s[r]),
                    vs[r * MAXD + c * kMmtLanesPerRow + sub], acc[c]);
  m = m_new;
}

// mmt_online_tile_if with the arange visibility: tile row r holds key
// first_key + r, visible when first_key + r <= last_visible.
template <int MAXD, typename P = float>
__device__ __forceinline__ void mmt_online_tile(
    const float (&q)[MAXD / kMmtLanesPerRow],
    float (&acc)[MAXD / kMmtLanesPerRow], float& m, float& l,
    const float* __restrict__ ks, const float* __restrict__ vs, int sub,
    int first_key, int last_visible, float scale) {
  mmt_online_tile_if<MAXD, P>(
      q, acc, m, l, ks, vs, sub, scale,
      [=](int r) { return first_key + r <= last_visible; });
}

// Zero a block's K/V staging tiles once: tile loads write only the first
// head_dim channels of each row, so the rest stay 0 and contribute nothing.
template <int MAXD>
__device__ __forceinline__ void mmt_zero_tiles(float* ks, float* vs) {
  for (int i = threadIdx.x; i < kMmtKeys * MAXD; i += blockDim.x) {
    ks[i] = 0.f;
    vs[i] = 0.f;
  }
  __syncthreads();
}

// Rows [j0, j0 + kMmtKeys) (cut at `end`) of two [B, S, H, Dh] tensors'
// (b, h) slice, widened to f32, into kMmtKeys x MAXD shared tiles.
template <typename T, int MAXD>
__device__ __forceinline__ void mmt_stage_rows(const T* __restrict__ x,
                                               const T* __restrict__ y,
                                               float* xs, float* ys,
                                               size_t base, size_t row_stride,
                                               int j0, int end, int head_dim) {
  for (int idx = threadIdx.x; idx < kMmtKeys * head_dim;
       idx += kMmtThreads) {
    const int r = idx / head_dim, d = idx - r * head_dim;
    const int j = j0 + r;
    float a = 0.f, b = 0.f;
    if (j < end) {
      a = mmt_to_float(x[base + j * row_stride + d]);
      b = mmt_to_float(y[base + j * row_stride + d]);
    }
    xs[r * MAXD + d] = a;
    ys[r * MAXD + d] = b;
  }
}

// The backward kernels walk a staged tile kMmtChunk rows at a time: enough
// independent dot products to hide latency, few enough registers (a whole
// 32-row tile of s and dp spills).
constexpr int kMmtChunk = 8;

// kMmtChunk dot products of this lane's channels with staged rows
// [r0, r0 + kMmtChunk), summed over the row's 4 lanes.
template <int MAXD>
__device__ __forceinline__ void mmt_row_dots(const float* a,
                                             const float* tile, int r0,
                                             int sub,
                                             float (&out)[kMmtChunk]) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
#pragma unroll
  for (int r = 0; r < kMmtChunk; ++r) {
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      dot = fmaf(a[c], tile[(r0 + r) * MAXD + c * kMmtLanesPerRow + sub],
                 dot);
    out[r] = dot;
  }
#pragma unroll
  for (int r = 0; r < kMmtChunk; ++r) {
    out[r] += __shfl_xor_sync(MMT_FULL_MASK, out[r], 1);
    out[r] += __shfl_xor_sync(MMT_FULL_MASK, out[r], 2);
  }
}

// This lane's channels (sub, sub + 4, ...) of the row at `at`, widened to
// f32; zeros for a dead row or past the head dim.
template <typename T, int MAXD>
__device__ __forceinline__ void mmt_load_row(
    const T* __restrict__ x, size_t at, bool live, int sub, int head_dim,
    float (&r)[MAXD / kMmtLanesPerRow]) {
#pragma unroll
  for (int c = 0; c < MAXD / kMmtLanesPerRow; ++c) {
    const int ch = c * kMmtLanesPerRow + sub;
    r[c] = (live && ch < head_dim) ? mmt_to_float(x[at + ch]) : 0.f;
  }
}
