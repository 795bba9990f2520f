// Differentiable flash attention: the forward with its log-sum-exp, and the
// FlashAttention-2 backward as two kernels (dq; dk and dv).
//
// Replaces the TPU kernels of mmlspark_tpu/parallel/pallas_attention.py:
// flash_attention_folded (K7: forward _ffwd_call -> _ffwd_kernel, backward
// _fbwd_call -> _fdq_kernel and _fdkv_kernel), which the transformer's train
// step runs on every layer, and the Pallas backward of flash_attention (K5:
// _flash_bwd_call -> _flash_dq_kernel and _flash_dkv_kernel), whose forward
// (_flash_call) also comes here when lse is needed. The folded kernels exist
// to dodge the TPU's 128-lane padding at short head dims; these read
// [B, S, H, Dh] directly, so one set of kernels serves both.
//
// What bounds them on the H100: operations. At the train step's shape
// (B 8, S 1024, H 8, Dh 64, causal) the forward does 4 * Dh FLOPs per
// visible (query, key) pair (s and p.v) and the backward 10 * Dh (s, dp,
// dv, dq, dk), against 2-4 bytes per element of q, k, v, out and the
// grads: 8.6 and 21.5 GFLOP against about 50 MB per layer. (The two
// backward kernels each rebuild s and dp: they do 14 * Dh.)
//
// What the design does about it: no [S, S] matrix reaches device memory in
// either direction; scores are rebuilt in registers from q, k and the saved
// lse. One block per (batch * head, 32-row tile); each row is split over 4
// lanes that hold a quarter of its channels (lane `sub` owns channels sub,
// sub + 4, ...), so the 4 lanes read 4 consecutive shared-memory words. The
// forward and dq blocks own query rows and stream 32-key tiles of K and V
// (only up to the tile's causal diagonal); the dk/dv block owns key rows and
// streams 32-query tiles of q, do, lse and delta from its diagonal on, which
// is the JAX q-innermost grid turned into a loop inside the block. A
// tile's scores are independent dot products (two shuffles reduce each over
// the row's 4 lanes): 32 at a time in the forward, 8 at a time in the
// backward, whose every row also carries dp (a whole tile of both
// spilled: 255 registers and 4.5 KB of stack in the first build). Inputs are f32 or bf16; tiles are widened to f32
// in shared memory and every sum is f32. bf16 rounds where the JAX kernels
// cast: p before p.v (forward) and p.do (dv), ds before ds.k (dq) and ds.q
// (dk). Grads are written in f32, as the JAX kernels write them. Any S, any
// Sq != Sk under the arange causal mask (query i sees key j <= i), any
// Dh <= 64. f32 FMAs on the CUDA cores: wgmma for the bf16 products is
// later work.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The last key a query row sees, and the end of the keys a 32-row query
// tile starting at q0 needs.
__device__ __forceinline__ int last_key(int qi, int sk, int causal) {
  return causal ? min(qi, sk - 1) : sk - 1;
}
__device__ __forceinline__ int keys_end(int q0, int sk, int causal) {
  return causal ? min(sk, q0 + kMmtRows) : sk;
}

// Forward: normalized out (OutT) and lse = m + log l per (b, h, row), 1e30
// for a row that sees no key (its p, and so its grads, are then 0).
template <typename T, typename OutT, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, OutT* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  mmt_zero_tiles<MAXD>(ks, vs);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.y * kMmtRows;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int qi = q0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = qi < sq;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;

  float qr[kCh], acc[kCh];
  mmt_load_row<T, MAXD>(q, qbase + qi * rs, live, sub, head_dim, qr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  float m = MMT_NEG_INF, l = 0.f;
  const int last = last_key(qi, sk, causal);
  const int kv_end = keys_end(q0, sk, causal);
  for (int j0 = 0; j0 < kv_end; j0 += kMmtKeys) {
    mmt_stage_rows<T, MAXD>(k, v, ks, vs, kbase, rs, j0, kv_end, head_dim);
    __syncthreads();
    mmt_online_tile<MAXD, T>(qr, acc, m, l, ks, vs, sub, j0, last, scale);
    __syncthreads();
  }
  if (live) {
    const float l_safe = fmaxf(l, MMT_L_FLOOR);
    OutT* o = out + qbase + qi * rs;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) mmt_store(o + ch, acc[c] / l_safe);
    }
    if (sub == 0)
      lse[(size_t)bh * sq + qi] = l > 0.f ? m + logf(l_safe) : 1e30f;
  }
}

// dq = scale * sum_j ds_ij k_j, ds = p (dp - delta), p = exp(s - lse).
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float ks[kMmtKeys * MAXD];
  __shared__ float vs[kMmtKeys * MAXD];
  mmt_zero_tiles<MAXD>(ks, vs);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.y * kMmtRows;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int qi = q0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = qi < sq;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;

  float qr[kCh], dor[kCh], acc[kCh];
  mmt_load_row<T, MAXD>(q, qbase + qi * rs, live, sub, head_dim, qr);
  mmt_load_row<T, MAXD>(dout, qbase + qi * rs, live, sub, head_dim, dor);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  const float lse_i = live ? lse[(size_t)bh * sq + qi] : 0.f;
  const float delta_i = live ? delta[(size_t)bh * sq + qi] : 0.f;
  const int last = last_key(qi, sk, causal);
  const int kv_end = keys_end(q0, sk, causal);
  for (int j0 = 0; j0 < kv_end; j0 += kMmtKeys) {
    mmt_stage_rows<T, MAXD>(k, v, ks, vs, kbase, rs, j0, kv_end, head_dim);
    __syncthreads();
#pragma unroll 1
    for (int r0 = 0; r0 < kMmtKeys; r0 += kMmtChunk) {
      float s[kMmtChunk], dp[kMmtChunk];
      mmt_row_dots<MAXD>(qr, ks, r0, sub, s);
      mmt_row_dots<MAXD>(dor, vs, r0, sub, dp);
#pragma unroll
      for (int r = 0; r < kMmtChunk; ++r) {
        const int j = j0 + r0 + r;
        const float p = (live && j <= last) ? expf(s[r] * scale - lse_i)
                                            : 0.f;
        const float ds = mmt_round<T>(p * (dp[r] - delta_i));
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          acc[c] = fmaf(ds, ks[(r0 + r) * MAXD + c * kMmtLanesPerRow + sub],
                        acc[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* o = dq + qbase + qi * rs;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = c * kMmtLanesPerRow + sub;
      if (ch < head_dim) o[ch] = acc[c] * scale;
    }
  }
}

// dv_j = sum_i p_ij do_i, dk_j = scale * sum_i ds_ij q_i: the block owns 32
// key rows and walks the query tiles that can see them.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMmtThreads) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal) {
  constexpr int kCh = MAXD / kMmtLanesPerRow;
  __shared__ float qs[kMmtKeys * MAXD];
  __shared__ float dos[kMmtKeys * MAXD];
  __shared__ float ls[kMmtRows];
  __shared__ float dls[kMmtRows];
  mmt_zero_tiles<MAXD>(qs, dos);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int k0 = blockIdx.y * kMmtKeys;
  const int sub = threadIdx.x % kMmtLanesPerRow;
  const int kj = k0 + threadIdx.x / kMmtLanesPerRow;
  const bool live = kj < sk;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * head_dim;
  const size_t kbase = (size_t)b * sk * rs + (size_t)h * head_dim;

  float kr[kCh], vr[kCh], dk_acc[kCh], dv_acc[kCh];
  mmt_load_row<T, MAXD>(k, kbase + kj * rs, live, sub, head_dim, kr);
  mmt_load_row<T, MAXD>(v, kbase + kj * rs, live, sub, head_dim, vr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  // causal: queries before k0 see none of this block's keys
  for (int i0 = causal ? k0 : 0; i0 < sq; i0 += kMmtRows) {
    mmt_stage_rows<T, MAXD>(q, dout, qs, dos, qbase, rs, i0, sq, head_dim);
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
        const bool vis = live && qi < sq && (!causal || qi >= kj);
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

template <typename T, typename OutT, int MAXD>
void fwd_at(const void* q, const void* k, const void* v, void* out,
            void* lse, const Shape& s, cudaStream_t st) {
  const dim3 grid(s.batch * s.n_heads, (s.sq + kMmtRows - 1) / kMmtRows);
  attn_fwd_kernel<T, OutT, MAXD><<<grid, kMmtThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (OutT*)out, (float*)lse, s.sq,
      s.sk, s.n_heads, s.head_dim, s.scale, s.causal);
}

template <typename T, typename OutT>
void launch_fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const Shape& s, cudaStream_t st) {
  if (s.head_dim <= 16)
    fwd_at<T, OutT, 16>(q, k, v, out, lse, s, st);
  else
    fwd_at<T, OutT, kMmtMaxHeadDim>(q, k, v, out, lse, s, st);
}

template <typename T, int MAXD>
void dq_at(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const Shape& s,
           cudaStream_t st) {
  const dim3 grid(s.batch * s.n_heads, (s.sq + kMmtRows - 1) / kMmtRows);
  attn_bwd_dq_kernel<T, MAXD><<<grid, kMmtThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, s.sq, s.sk,
      s.n_heads, s.head_dim, s.scale, s.causal);
}

template <typename T>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, const Shape& s,
               cudaStream_t st) {
  if (s.head_dim <= 16)
    dq_at<T, 16>(q, k, v, dout, lse, delta, dq, s, st);
  else
    dq_at<T, kMmtMaxHeadDim>(q, k, v, dout, lse, delta, dq, s, st);
}

template <typename T, int MAXD>
void dkdv_at(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv,
             const Shape& s, cudaStream_t st) {
  const dim3 grid(s.batch * s.n_heads, (s.sk + kMmtKeys - 1) / kMmtKeys);
  attn_bwd_dkdv_kernel<T, MAXD><<<grid, kMmtThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, s.sq,
      s.sk, s.n_heads, s.head_dim, s.scale, s.causal);
}

template <typename T>
void launch_dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, const Shape& s, cudaStream_t st) {
  if (s.head_dim <= 16)
    dkdv_at<T, 16>(q, k, v, dout, lse, delta, dk, dv, s, st);
  else
    dkdv_at<T, kMmtMaxHeadDim>(q, k, v, dout, lse, delta, dk, dv, s, st);
}

bool bad_shape(int batch, int sq, int sk, int n_heads, int head_dim) {
  return batch < 0 || sq < 0 || sk < 0 || n_heads < 0 || head_dim < 1 ||
         head_dim > kMmtMaxHeadDim;
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), all `dtype` (kMmtF32 or
// kMmtBF16); out (B, Sq, H, Dh) in f32 when out_f32, else in `dtype`; lse
// (B, H, Sq) f32. Contiguous, on the device; Dh <= 64. One launch on
// `stream`. Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// or dtype the kernel has no instance for).
extern "C" int mmt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int batch, int sq,
                                 int sk, int n_heads, int head_dim,
                                 float scale, int causal, int dtype,
                                 int out_f32, void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const Shape s{batch, sq, sk, n_heads, head_dim, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_fwd<float, float>(q, k, v, out, lse, s, st);
  else if (dtype == kMmtBF16 && out_f32)
    launch_fwd<bf16, float>(q, k, v, out, lse, s, st);
  else if (dtype == kMmtBF16)
    launch_fwd<bf16, bf16>(q, k, v, out, lse, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The forward's q, k, v, the output's cotangent dout (B, Sq, H, Dh) in
// `dtype`, its lse and delta = sum(dout * out, -1), both (B, H, Sq) f32;
// dq (B, Sq, H, Dh) f32. One launch.
extern "C" int mmt_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int batch, int sq, int sk,
                                    int n_heads, int head_dim, float scale,
                                    int causal, int dtype, void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const Shape s{batch, sq, sk, n_heads, head_dim, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dq<float>(q, k, v, dout, lse, delta, dq, s, st);
  else if (dtype == kMmtBF16)
    launch_dq<bf16>(q, k, v, dout, lse, delta, dq, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// As mmt_attention_bwd_dq; dk, dv (B, Sk, H, Dh) f32. One launch.
extern "C" int mmt_attention_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int sq,
                                      int sk, int n_heads, int head_dim,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sk == 0 || n_heads == 0) return 0;
  const Shape s{batch, sq, sk, n_heads, head_dim, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, s, st);
  else if (dtype == kMmtBF16)
    launch_dkdv<bf16>(q, k, v, dout, lse, delta, dk, dv, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
