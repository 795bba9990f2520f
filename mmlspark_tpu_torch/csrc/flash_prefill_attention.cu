// Causal flash attention for the cold prefill (forward, normalized).
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// flash_prefill_attention -> flash_attention forward (_flash_fwd ->
// _flash_call -> _flash_kernel), as the prefill builders call it.
//
// What bounds it on the H100: f32 operations at the prompt lengths the
// decoder serves (4 * Dh FLOPs per causal (query, key) pair against 16
// bytes per row of q, k, v and out); bytes only for prompts of a few rows.
//
// What the design does about it: no [S, S] score matrix ever leaves the
// block, and the arithmetic runs as independent FMA chains. One block per
// (batch * head, 32-row query tile); each query row is split over 4 lanes
// that hold a quarter of its q channels and output accumulator in
// registers. 32-row K/V tiles up to the tile's causal diagonal are staged
// in shared memory; a tile's 32 scores are 32 independent dot products
// (reduced across the row's 4 lanes by two shuffles), and P.V updates each
// lane's channels independently. Later tiles are never loaded. Any S and
// any Dh <= 64 run unpadded: rows past S and keys past each row's diagonal
// are masked in the kernel. f32 FMA on the CUDA cores; tensor-core tiles
// (wgmma, with an error-compensated split for f32) are later work.

#include "common.cuh"

namespace {

template <int MAXD>
__global__ void __launch_bounds__(kMmtThreads) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int seq,
    int n_heads, int head_dim, float scale) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  mmt_zero_tiles<MAXD>(ks, vs);
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int q0 = blockIdx.y * kMmtRows;
  const int tid = threadIdx.x;
  const int sub = tid % kMmtLanesPerRow;
  const int qi = q0 + tid / kMmtLanesPerRow;
  const bool live = qi < seq;
  const size_t row_stride = (size_t)n_heads * head_dim;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * head_dim;

  float qr[kCh], acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int ch = c * kMmtLanesPerRow + sub;
    qr[c] = (live && ch < head_dim) ? q[base + qi * row_stride + ch] : 0.f;
    acc[c] = 0.f;
  }
  float m = MMT_NEG_INF, l = 0.f;

  // causal: no row of this tile sees a key past its last row
  const int kv_end = min(seq, q0 + kMmtRows);
  for (int j0 = 0; j0 < kv_end; j0 += kMmtKeys) {
    for (int idx = tid; idx < kMmtKeys * head_dim; idx += kMmtThreads) {
      const int r = idx / head_dim, d = idx - r * head_dim;
      const int j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < kv_end) {
        kv = k[base + j * row_stride + d];
        vv = v[base + j * row_stride + d];
      }
      ks[r * MAXD + d] = kv;
      vs[r * MAXD + d] = vv;
    }
    __syncthreads();
    mmt_online_tile<MAXD>(qr, acc, m, l, ks, vs, sub, j0, qi, scale);
    __syncthreads();
  }

  if (live) {
    const float l_safe = fmaxf(l, MMT_L_FLOOR);
    float* o = out + base + qi * row_stride;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) o[ch] = acc[c] / l_safe;
    }
  }
}

template <int MAXD>
void launch(const float* q, const float* k, const float* v, float* out,
            int batch, int seq, int n_heads, int head_dim, float scale,
            cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (seq + kMmtRows - 1) / kMmtRows);
  flash_prefill_kernel<MAXD><<<grid, kMmtThreads, 0, stream>>>(
      q, k, v, out, seq, n_heads, head_dim, scale);
}

}  // namespace

// q, k, v, out (B, S, H, Dh), contiguous f32 on the device, Dh <= 64;
// launched on `stream`. Returns cudaGetLastError() (cudaErrorInvalidValue
// for a head_dim the kernel has no instance for).
extern "C" int mmt_flash_prefill_attention(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int seq, int n_heads,
                                           int head_dim, float scale,
                                           void* stream) {
  if (batch == 0 || seq == 0 || n_heads == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim <= 16)
    launch<16>(qf, kf, vf, of, batch, seq, n_heads, head_dim, scale, s);
  else if (head_dim <= kMmtMaxHeadDim)
    launch<kMmtMaxHeadDim>(qf, kf, vf, of, batch, seq, n_heads, head_dim,
                           scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
