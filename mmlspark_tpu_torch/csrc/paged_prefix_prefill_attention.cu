// Prefix-prefill attention: the uncached suffix of a prompt against the
// slot's whole paged lane (shared prefix pages first, then its own).
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// paged_prefix_prefill_attention (kernel body _paged_prefix_kernel).
//
// What bounds it on the H100: bytes for short suffixes (each live lane row
// of K and V, H * Dh f32, is read once per 32-row query tile), f32
// operations once the suffix spans several query tiles.
//
// What the design does about it: neither the gathered lane nor the [S, V]
// score matrix is ever written. One block per (head, 32-row query tile),
// each suffix row (virtual position hit_len + row) split over 4 lanes as in
// the flash prefill kernel. The block walks the lane in 32-row tiles
// through the page table, up to the last key its rows can see
// (min(V, hit_len + last row + 1)); rows past that, including every
// unclaimed scratch-aimed table entry, are never read. hit_len is a plain
// int argument: the hit depth is data, never a shape.
// Known gap: a short suffix makes few blocks (H for S <= 32), each walking
// the whole prefix alone; splitting the lane across blocks is later work.

#include "common.cuh"

namespace {

template <int MAXD>
__global__ void __launch_bounds__(kMmtThreads) paged_prefix_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ table,
    float* __restrict__ out, int seq, int n_heads, int head_dim,
    int page_size, int pages_per_slot, int hit_len, float scale) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  mmt_zero_tiles<MAXD>(ks, vs);
  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kMmtRows;
  const int tid = threadIdx.x;
  const int sub = tid % kMmtLanesPerRow;
  const int qi = q0 + tid / kMmtLanesPerRow;
  const bool live = qi < seq;
  const size_t row_stride = (size_t)n_heads * head_dim;
  const int lane_len = pages_per_slot * page_size;

  float qr[kCh], acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int ch = c * kMmtLanesPerRow + sub;
    qr[c] = (live && ch < head_dim)
                ? q[(size_t)qi * row_stride + (size_t)h * head_dim + ch]
                : 0.f;
    acc[c] = 0.f;
  }
  float m = MMT_NEG_INF, l = 0.f;
  // the lane has lane_len keys; row qi sees keys <= hit_len + qi
  const int last_visible = min(hit_len + qi, lane_len - 1);
  const int kv_end = min(lane_len, hit_len + min(seq, q0 + kMmtRows));

  for (int j0 = 0; j0 < kv_end; j0 += kMmtKeys) {
    for (int idx = tid; idx < kMmtKeys * head_dim; idx += kMmtThreads) {
      const int r = idx / head_dim, d = idx - r * head_dim;
      const int j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < kv_end) {
        const size_t src = ((size_t)table[j / page_size] * page_size +
                            j % page_size) * row_stride +
                           (size_t)h * head_dim + d;
        kv = k_pages[src];
        vv = v_pages[src];
      }
      ks[r * MAXD + d] = kv;
      vs[r * MAXD + d] = vv;
    }
    __syncthreads();
    mmt_online_tile<MAXD>(qr, acc, m, l, ks, vs, sub, j0, last_visible,
                          scale);
    __syncthreads();
  }

  if (live) {
    const float l_safe = fmaxf(l, MMT_L_FLOOR);
    float* o = out + (size_t)qi * row_stride + (size_t)h * head_dim;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) o[ch] = acc[c] / l_safe;
    }
  }
}

template <int MAXD>
void launch(const float* q, const float* kp, const float* vp, const int* tbl,
            float* out, int seq, int n_heads, int head_dim, int page_size,
            int pages_per_slot, int hit_len, float scale,
            cudaStream_t stream) {
  const dim3 grid(n_heads, (seq + kMmtRows - 1) / kMmtRows);
  paged_prefix_kernel<MAXD><<<grid, kMmtThreads, 0, stream>>>(
      q, kp, vp, tbl, out, seq, n_heads, head_dim, page_size,
      pages_per_slot, hit_len, scale);
}

}  // namespace

// q, out (S, H, Dh); k_pages, v_pages (n_pages, page_size, H, Dh); table
// (pages_per_slot,) int32. Contiguous f32/int32 on the device, Dh <= 64;
// launched on `stream`. Returns cudaGetLastError().
extern "C" int mmt_paged_prefix_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, void* out, int seq, int n_heads, int head_dim,
    int page_size, int pages_per_slot, int hit_len, float scale,
    void* stream) {
  if (seq == 0 || n_heads == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k_pages,
              *vf = (const float*)v_pages;
  const int* tf = (const int*)table;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim <= 16)
    launch<16>(qf, kf, vf, tf, of, seq, n_heads, head_dim, page_size,
               pages_per_slot, hit_len, scale, s);
  else if (head_dim <= kMmtMaxHeadDim)
    launch<kMmtMaxHeadDim>(qf, kf, vf, tf, of, seq, n_heads, head_dim,
                           page_size, pages_per_slot, hit_len, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
