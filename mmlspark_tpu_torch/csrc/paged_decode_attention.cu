// Paged decode attention: one query per slot against the slot's paged lane.
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// paged_decode_attention (kernel body _paged_attn_kernel).
//
// What bounds it on the H100: bytes. Every decode step reads each slot's
// live K and V rows (pos + 1 rows of H * Dh f32 each) once and does two
// FMAs per element read, far below the card's f32 rate per byte.
//
// What the design does about it: nothing lane-shaped is ever written, and
// many rows are in flight at once. One block of 8 warps per (slot, head)
// reads its own page-table row; the slot's live virtual rows (index <= pos;
// dead and scratch-aimed table entries are never read) are dealt out to
// the warps in chunks of 8 consecutive rows. A warp issues all 16 loads of
// a chunk (K and V, lanes across the head channels: coalesced) before
// using any, reduces the chunk's 8 scores with independent shuffles, and
// keeps its own running (m, l, acc) in registers — no block barrier inside
// the loop. The 8 warps' partial softmax states merge once at the end.
// Known gap: N * H blocks (64 at the slice's width) fill under half of the
// 132 SMs; splitting a long lane across blocks is later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;  // virtual rows per warp step

__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ out, int n_heads,
    int head_dim, int page_size, int pages_per_slot, float scale) {
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMmtMaxHeadDim];
  const int n = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_stride = (size_t)n_heads * head_dim;
  const size_t head_off = (size_t)h * head_dim;
  // lane owns channels lane and lane + 32
  const bool has0 = lane < head_dim, has1 = lane + 32 < head_dim;
  const float* qh = q + (size_t)n * row_stride + head_off;
  const float q0 = has0 ? qh[lane] : 0.f;
  const float q1 = has1 ? qh[lane + 32] : 0.f;
  const int* table = tables + (size_t)n * pages_per_slot;
  const int n_rows = min(pos[n] + 1, pages_per_slot * page_size);

  float m = MMT_NEG_INF, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int base = warp * kChunk; base < n_rows; base += kWarps * kChunk) {
    float s[kChunk], v0[kChunk], v1[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int row = base + r;
      float k0 = 0.f, k1 = 0.f;
      v0[r] = v1[r] = 0.f;
      if (row < n_rows) {
        const size_t off = ((size_t)table[row / page_size] * page_size +
                            row % page_size) * row_stride + head_off;
        if (has0) {
          k0 = k_pages[off + lane];
          v0[r] = v_pages[off + lane];
        }
        if (has1) {
          k1 = k_pages[off + lane + 32];
          v1[r] = v_pages[off + lane + 32];
        }
      }
      s[r] = fmaf(k1, q1, k0 * q0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kChunk; ++r)
        s[r] += __shfl_xor_sync(MMT_FULL_MASK, s[r], o);
    float mx = MMT_NEG_INF;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      s[r] = (base + r < n_rows) ? s[r] * scale : MMT_NEG_INF;
      mx = fmaxf(mx, s[r]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f, pv0 = 0.f, pv1 = 0.f;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const float p = (base + r < n_rows) ? expf(s[r] - m_new) : 0.f;
      sum += p;
      pv0 = fmaf(p, v0[r], pv0);
      pv1 = fmaf(p, v1[r], pv1);
    }
    l = l * alpha + sum;
    a0 = a0 * alpha + pv0;
    a1 = a1 * alpha + pv1;
    m = m_new;
  }

  // merge the warps' partial states (a warp that saw no row has m = -1e30,
  // l = 0: weight exp(-1e30 - M) = 0)
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (has0) sm_acc[warp][lane] = a0;
  if (has1) sm_acc[warp][lane + 32] = a1;
  __syncthreads();
  float big = MMT_NEG_INF;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w]);
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += sm_l[w] * expf(sm_m[w] - big);
  const float l_safe = fmaxf(total, MMT_L_FLOOR);
  float* oh = out + (size_t)n * row_stride + head_off;
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o = fmaf(sm_acc[w][d], expf(sm_m[w] - big), o);
    oh[d] = o / l_safe;
  }
}

}  // namespace

// q (N, H, Dh); k_pages, v_pages (n_pages, page_size, H, Dh); tables
// (N, pages_per_slot) int32; pos (N,) int32; out (N, H, Dh). All contiguous,
// all on the device, Dh <= 64; launched on `stream`. Returns
// cudaGetLastError().
extern "C" int mmt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* pos, void* out, int n_slots, int n_heads,
    int head_dim, int page_size, int pages_per_slot, float scale,
    void* stream) {
  if (n_slots == 0 || n_heads == 0) return 0;
  if (head_dim > kMmtMaxHeadDim) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_slots, n_heads);
  paged_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pages, (const float*)v_pages,
      (const int*)tables, (const int*)pos, (float*)out, n_heads, head_dim,
      page_size, pages_per_slot, scale);
  return (int)cudaGetLastError();
}
