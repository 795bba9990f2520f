// The ring-attention block step (K8): position-aware attention partials of
// one (query block, key/value block) pair, and the FlashAttention-2
// backward of such a pair, as three kernels (forward; dq; dk and dv).
//
// Replaces the TPU kernels of mmlspark_tpu/parallel/pallas_attention.py:
// flash_block_attn (_flash_call -> _flash_kernel) and its folded twin
// folded_block_attn (_fring_call -> _fring_kernel), which return the
// (m, l, o-unnormalized) partials the ring merges; and the folded ring
// backward _fring_bwd_call (_frdq_kernel, _frdkv_kernel). Their only
// caller is parallel/ring_attention.py: every layer of the
// sequence-parallel train step runs the forward once per ring step, and
// its backward ring runs dq and dk/dv once per step. The TPU twins differ
// only in layout (the folded one dodges the TPU's lane padding at short
// head dims); these read [B, S, H, Dh] directly and serve both.
//
// The mask comes from positions, not indices, so one kernel serves every
// ring step: key j counts for query i when k_pos[j] != INT32_MAX (the pad
// sentinel) and, if causal, k_pos[j] <= q_pos[i]. Full, diagonal and no
// visibility fall out of the positions. Positions are per batch row
// ([B, S] int32), so the ranks of a hosted mesh share one launch with
// their ranks folded into the batch.
//
// What bounds them on the H100: operations, as K7 (attention_train.cu):
// a full block at B 2, S 1024, H 8, Dh 64 is 4.3 GFLOP forward (4 Dh per
// pair), 6.4 dq and 8.6 dk/dv, against 10-15 MB of operands. What the
// design does about it: K7's tiling (one block per (batch * head, 32-row
// tile), a row over 4 lanes, scores rebuilt in registers, no [Sq, Sk]
// matrix in device memory), with a tile skipped whole when none of its
// pairs is visible, the TPU kernels' _tile_live test: a ring block with
// no visibility costs one pass over its key positions. Inputs f32 or
// bf16, every sum f32; bf16 rounds where the JAX kernels cast (p before
// p.v and p.do, ds before ds.k and ds.q). Outputs are f32: the
// unnormalized o with m and l, and the three grads. Any Sq and Sk, no
// padding, Dh <= 64. f32 FMAs on the CUDA cores: wgmma is later work.

#include <climits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the JAX package's _PAD_POS: a padded key, never visible
constexpr int kPadPos = INT_MAX;
constexpr int kWarps = kMmtThreads / 32;

__device__ __forceinline__ bool visible(int kp, int qp, int causal) {
  return kp != kPadPos && (!causal || kp <= qp);
}

// The block-wide max (kMax) or min of x; every thread gets it. `scratch`
// holds kWarps ints; the call synchronises the block.
template <bool kMax>
__device__ __forceinline__ int block_reduce(int x, int* scratch) {
  x = kMax ? __reduce_max_sync(MMT_FULL_MASK, x)
           : __reduce_min_sync(MMT_FULL_MASK, x);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  int r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    r = kMax ? max(r, scratch[w]) : min(r, scratch[w]);
  return r;
}

// Warp 0 stages the key positions of the tile at j0 (the pad sentinel past
// sk) and sets *live when a query at or before qmax sees one of them (for
// the non-causal mask: when one is not padding). The caller syncs.
__device__ __forceinline__ void stage_key_positions(
    const int* __restrict__ k_pos, size_t base, int j0, int sk, int qmax,
    int causal, int* kp_s, int* live) {
  if (threadIdx.x < kMmtKeys) {
    const int j = j0 + threadIdx.x;
    const int kp = j < sk ? k_pos[base + j] : kPadPos;
    kp_s[threadIdx.x] = kp;
    const bool any = __any_sync(MMT_FULL_MASK, visible(kp, qmax, causal));
    if (threadIdx.x == 0) *live = any;
  }
}

// Forward partials: o (f32, [B, Sq, H, Dh], unnormalized), m and l (f32,
// [B, H, Sq]). A row that sees no key ends with m = -1e30, l = 0, o = 0.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) ring_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  __shared__ int kp_s[kMmtKeys];
  __shared__ int scratch[kWarps];
  __shared__ int live_s;
  mmt_zero_tiles<MAXD>(ks, vs);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.y * kMmtRows;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int qi = q0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = qi < sq;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;
  const int qp = live ? q_pos[(size_t)b * sq + qi] : INT_MIN;
  const int qmax = block_reduce<true>(qp, scratch);

  float qr[kCh], acc[kCh];
  mmt_load_row<T, MAXD>(q, qbase + qi * rs, live, sub, head_dim, qr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  float m = MMT_NEG_INF, l = 0.f;
  for (int j0 = 0; j0 < sk; j0 += kMmtKeys) {
    stage_key_positions(k_pos, (size_t)b * sk, j0, sk, qmax, causal, kp_s,
                        &live_s);
    __syncthreads();
    const bool tile_live = live_s;
    if (tile_live) {
      mmt_stage_rows<T, MAXD>(k, v, ks, vs, kbase, rs, j0, sk, head_dim);
      __syncthreads();
      mmt_online_tile_if<MAXD, T>(
          qr, acc, m, l, ks, vs, sub, scale,
          [&](int r) { return visible(kp_s[r], qp, causal); });
    }
    // every thread is done with live_s, kp_s and the tiles
    __syncthreads();
  }
  if (live) {
    float* op = o + qbase + qi * rs;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) op[ch] = acc[c];
    }
    if (sub == 0) {
      m_out[(size_t)bh * sq + qi] = m;
      l_out[(size_t)bh * sq + qi] = l;
    }
  }
}

// dq = scale * sum_j ds_ij k_j, ds = p (dp - delta), p = exp(s - lse) on
// visible pairs (lse = +1e30 on a row with no visible key: p = 0).
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) ring_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  __shared__ int kp_s[kMmtKeys];
  __shared__ int scratch[kWarps];
  __shared__ int live_s;
  mmt_zero_tiles<MAXD>(ks, vs);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.y * kMmtRows;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int qi = q0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = qi < sq;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;
  const int qp = live ? q_pos[(size_t)b * sq + qi] : INT_MIN;
  const int qmax = block_reduce<true>(qp, scratch);

  float qr[kCh], dor[kCh], acc[kCh];
  mmt_load_row<T, MAXD>(q, qbase + qi * rs, live, sub, head_dim, qr);
  mmt_load_row<T, MAXD>(dout, qbase + qi * rs, live, sub, head_dim, dor);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  const float lse_i = live ? lse[(size_t)bh * sq + qi] : 0.f;
  const float delta_i = live ? delta[(size_t)bh * sq + qi] : 0.f;
  for (int j0 = 0; j0 < sk; j0 += kMmtKeys) {
    stage_key_positions(k_pos, (size_t)b * sk, j0, sk, qmax, causal, kp_s,
                        &live_s);
    __syncthreads();
    const bool tile_live = live_s;
    if (tile_live) {
      mmt_stage_rows<T, MAXD>(k, v, ks, vs, kbase, rs, j0, sk, head_dim);
      __syncthreads();
#pragma unroll 1
      for (int r0 = 0; r0 < kMmtKeys; r0 += kMmtChunk) {
        float s[kMmtChunk], dp[kMmtChunk];
        mmt_row_dots<MAXD>(qr, ks, r0, sub, s);
        mmt_row_dots<MAXD>(dor, vs, r0, sub, dp);
#pragma unroll
        for (int r = 0; r < kMmtChunk; ++r) {
          const bool vis = live && visible(kp_s[r0 + r], qp, causal);
          const float p = vis ? expf(s[r] * scale - lse_i) : 0.f;
          const float ds = mmt_round<T>(p * (dp[r] - delta_i));
#pragma unroll
          for (int c = 0; c < kCh; ++c)
            acc[c] = fmaf(ds, ks[(r0 + r) * MAXD + c * kMmtLanesPerRow + sub],
                          acc[c]);
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    float* op = dq + qbase + qi * rs;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) op[ch] = acc[c] * scale;
    }
  }
}

// dv_j = sum_i p_ij do_i, dk_j = scale * sum_i ds_ij q_i: the block owns 32
// key rows and walks the query tiles, skipping those that see none of them.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) ring_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float qs[kMmtKeys * MAXD];
  __shared__ float dos[kMmtKeys * MAXD];
  __shared__ float ls[kMmtRows];
  __shared__ float dls[kMmtRows];
  __shared__ int qp_s[kMmtRows];
  __shared__ int scratch[kWarps];
  __shared__ int live_s;
  mmt_zero_tiles<MAXD>(qs, dos);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int k0 = blockIdx.y * kMmtKeys;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int kj = k0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = kj < sk;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;
  const int kp = live ? k_pos[(size_t)b * sk + kj] : kPadPos;
  // the block's first key position: a query tile sees one of the block's
  // keys only if its last query sees this one
  const int kmin = block_reduce<false>(kp, scratch);

  float kr[kCh], vr[kCh], dk_acc[kCh], dv_acc[kCh];
  mmt_load_row<T, MAXD>(k, kbase + kj * rs, live, sub, head_dim, kr);
  mmt_load_row<T, MAXD>(v, kbase + kj * rs, live, sub, head_dim, vr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  for (int i0 = 0; i0 < sq; i0 += kMmtRows) {
    if (threadIdx.x < kMmtRows) {
      const int i = i0 + threadIdx.x;
      const int qp = i < sq ? q_pos[(size_t)b * sq + i] : INT_MIN;
      qp_s[threadIdx.x] = qp;
      const bool any = __any_sync(
          MMT_FULL_MASK, i < sq && visible(kmin, qp, causal));
      if (threadIdx.x == 0) live_s = any;
    }
    __syncthreads();
    const bool tile_live = live_s;
    if (tile_live) {
      mmt_stage_rows<T, MAXD>(q, dout, qs, dos, qbase, rs, i0, sq,
                              head_dim);
      if (threadIdx.x < kMmtRows) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < sq ? lse[(size_t)bh * sq + i] : 0.f;
        dls[threadIdx.x] = i < sq ? delta[(size_t)bh * sq + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int r0 = 0; r0 < kMmtRows; r0 += kMmtChunk) {
        float s[kMmtChunk], dp[kMmtChunk];
        mmt_row_dots<MAXD>(kr, qs, r0, sub, s);
        mmt_row_dots<MAXD>(vr, dos, r0, sub, dp);
#pragma unroll
        for (int r = 0; r < kMmtChunk; ++r) {
          const int qi = i0 + r0 + r;
          const bool vis =
              live && qi < sq && visible(kp, qp_s[r0 + r], causal);
          const float p = vis ? expf(s[r] * scale - ls[r0 + r]) : 0.f;
          const float pr = mmt_round<T>(p);
          const float ds = mmt_round<T>(p * (dp[r] - dls[r0 + r]));
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const int at = (r0 + r) * MAXD + c * kMmtLanesPerRow + sub;
            dv_acc[c] = fmaf(pr, dos[at], dv_acc[c]);
            dk_acc[c] = fmaf(ds, qs[at], dk_acc[c]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    float* ok = dk + kbase + kj * rs;
    float* ov = dv + kbase + kj * rs;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) {
        ok[ch] = dk_acc[c] * scale;
        ov[ch] = dv_acc[c];
      }
    }
  }
}

struct Shape {
  int batch, sq, sk, n_heads, head_dim;
  float scale;
  int causal;
};

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta, *q_pos, *k_pos;
  void *out0, *out1, *out2;
};

template <typename T, int MAXD>
void launch_at(int which, const Ptrs& p, const Shape& s, cudaStream_t st) {
  const int rows = which == 2 ? s.sk : s.sq;
  const dim3 grid(s.batch * s.n_heads, (rows + kMmtRows - 1) / kMmtRows);
  const T *q = (const T*)p.q, *k = (const T*)p.k, *v = (const T*)p.v;
  const int *qp = (const int*)p.q_pos, *kp = (const int*)p.k_pos;
  if (which == 0)
    ring_fwd_kernel<T, MAXD><<<grid, kMmtThreads, 0, st>>>(
        q, k, v, qp, kp, (float*)p.out0, (float*)p.out1, (float*)p.out2,
        s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal);
  else if (which == 1)
    ring_bwd_dq_kernel<T, MAXD><<<grid, kMmtThreads, 0, st>>>(
        q, k, v, (const T*)p.dout, (const float*)p.lse,
        (const float*)p.delta, qp, kp, (float*)p.out0, s.sq, s.sk,
        s.n_heads, s.head_dim, s.scale, s.causal);
  else
    ring_bwd_dkdv_kernel<T, MAXD><<<grid, kMmtThreads, 0, st>>>(
        q, k, v, (const T*)p.dout, (const float*)p.lse,
        (const float*)p.delta, qp, kp, (float*)p.out0, (float*)p.out1,
        s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal);
}

template <typename T>
void launch_dim(int which, const Ptrs& p, const Shape& s, cudaStream_t st) {
  if (s.head_dim <= 16)
    launch_at<T, 16>(which, p, s, st);
  else
    launch_at<T, kMmtMaxHeadDim>(which, p, s, st);
}

// which: 0 forward, 1 dq, 2 dk/dv. Nothing to launch when the kernel's
// own rows (queries, or keys for dk/dv) are empty.
int run(int which, const Ptrs& p, const Shape& s, int dtype, void* stream) {
  if (s.batch < 0 || s.sq < 0 || s.sk < 0 || s.n_heads < 0 ||
      s.head_dim < 1 || s.head_dim > kMmtMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  const int rows = which == 2 ? s.sk : s.sq;
  if (s.batch == 0 || rows == 0 || s.n_heads == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dim<float>(which, p, s, st);
  else if (dtype == kMmtBF16)
    launch_dim<bf16>(which, p, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), all `dtype` (kMmtF32 or
// kMmtBF16); q_pos (B, Sq) and k_pos (B, Sk) int32 (INT32_MAX: a padded
// key); o (B, Sq, H, Dh), m and l (B, H, Sq), all f32. Contiguous, on the
// device; Dh <= 64. One launch on `stream`. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape or dtype without an instance).
extern "C" int mmt_ring_block_fwd(const void* q, const void* k, const void* v,
                                  const void* q_pos, const void* k_pos,
                                  void* o, void* m, void* l, int batch,
                                  int sq, int sk, int n_heads, int head_dim,
                                  float scale, int causal, int dtype,
                                  void* stream) {
  const Ptrs p{q, k, v, nullptr, nullptr, nullptr, q_pos, k_pos, o, m, l};
  return run(0, p, Shape{batch, sq, sk, n_heads, head_dim, scale, causal},
             dtype, stream);
}

// The pair's q, k, v and positions as above, the output's cotangent dout
// (B, Sq, H, Dh) in `dtype`, the ring's lse (+1e30 on a row with no
// visible key) and delta = sum(dout * out, -1) over the f32 normalised
// output, both (B, H, Sq) f32; dq (B, Sq, H, Dh) f32. One launch.
extern "C" int mmt_ring_block_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* q_pos, const void* k_pos,
                                     void* dq, int batch, int sq, int sk,
                                     int n_heads, int head_dim, float scale,
                                     int causal, int dtype, void* stream) {
  const Ptrs p{q, k, v, dout, lse, delta, q_pos, k_pos, dq, nullptr,
               nullptr};
  return run(1, p, Shape{batch, sq, sk, n_heads, head_dim, scale, causal},
             dtype, stream);
}

// As mmt_ring_block_bwd_dq; dk, dv (B, Sk, H, Dh) f32. One launch.
extern "C" int mmt_ring_block_bwd_dkdv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* q_pos, const void* k_pos,
                                       void* dk, void* dv, int batch, int sq,
                                       int sk, int n_heads, int head_dim,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  const Ptrs p{q, k, v, dout, lse, delta, q_pos, k_pos, dk, dv, nullptr};
  return run(2, p, Shape{batch, sq, sk, n_heads, head_dim, scale, causal},
             dtype, stream);
}
