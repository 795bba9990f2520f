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
// What bounds them on the H100: bytes. At the train step's shape (B 8,
// S 1024, H 8, Dh 64, causal, bf16) the forward reads q, k, v and writes
// out and lse (0.0101 ms at 3.35 TB/s), dq reads q, k, v, dout, lse, delta
// and writes f32 dq (0.0152 ms), dk/dv the same inputs and f32 dk, dv
// (0.0202 ms); their products (4 * Dh FLOPs per visible pair forward,
// 14 * Dh backward, since both backward kernels rebuild s and dp) take
// 0.0087 and 0.030 ms at the bf16 tensor-core peak. Neither is reached
// without the tensor cores: the CUDA cores' f32 rate is 15x lower.
//
// Dispatch on the input dtype, inside each entry point, one launch each:
//
// * bf16 runs on the tensor cores (the *_wgmma kernels, building blocks
//   in hopper_mma.cuh). One warpgroup (128 threads) per block owns 64 rows
//   of one (batch, head): query rows for the forward and dq, key rows for
//   dk/dv. The block's own rows stay in shared memory (q, or k and v, plus
//   dout for dq); the other side streams through a 2-stage cp.async ring
//   of 64-row bf16 tiles in the 128-byte swizzle, tile j + 1 in flight
//   while tile j computes. Every product is wgmma m64n64k16 with f32 sums:
//   s = q k^T (and dp = dout v^T) from shared memory into registers; the
//   softmax works on the accumulator fragment (row max and sum over the 4
//   threads of a row, the running max kept in log2 units for ex2); p (and
//   ds) are rounded to bf16 in registers and are the A operand of the next
//   product, p v, ds k, p^T dout and ds^T q, whose B tile is read with
//   the transpose flag. bf16 rounds where the JAX kernels cast: p before
//   p.v (forward) and p.do (dv), ds before ds.k (dq) and ds.q (dk); l sums
//   the unrounded p. Only the tiles that cross the causal diagonal or the
//   sequence's end are masked; the forward and dq stop at the diagonal
//   tile, dk/dv starts at it, and the blocks with the most tiles launch
//   first. Dh < 64 is zero-padded in shared memory (one layout, one set of
//   instances); rows past S are zero-filled by the copies; where a row is
//   not 16-byte aligned (Dh % 8 != 0, or an unaligned pointer) the same
//   kernels stage through element loads.
// * f32 keeps the CUDA-core kernels (attn_*_kernel<float>): one block per
//   (batch * head, 32-row tile), each row split over 4 lanes that hold a
//   quarter of its channels; tiles widened to f32 in shared memory; the
//   backward walks a tile 8 rows at a time (a whole tile of s and dp
//   spilled). They hold the f32 parity checks to 1e-4.
//
// Neither route falls back to PyTorch. Grads are written in f32, as the
// JAX kernels write them. Any S, any Sq != Sk under the arange causal mask
// (query i sees key j <= i), any Dh <= 64.

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32 on the CUDA cores

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace hp = hopper;
constexpr int kTile = hp::kTileRows;

using hp::slice;
using hp::store_acc;

// Forward: 64 query rows against the key tiles up to their diagonal.
template <typename OutT>
__global__ void __launch_bounds__(hp::kWarpgroup) attn_fwd_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, OutT* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* ks = qs + hp::kTileElems;      // 2 stages
  bf16* vs = ks + 2 * hp::kTileElems;  // 2 stages
  hp::zero_smem(qs, 5 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* qb = slice(q, b, h, sq, rs, head_dim);
  const bf16* kb = slice(k, b, h, sk, rs, head_dim);
  const bf16* vb = slice(v, b, h, sk, rs, head_dim);
  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  __syncthreads();  // the zeros land before any copy
  if (n_tiles > 0) {
    hp::stage_tile(qs, qb, rs, q0, sq, head_dim, aligned);
    hp::stage_tile(ks, kb, rs, 0, kv_end, head_dim, aligned);
    hp::stage_tile(vs, vb, rs, 0, kv_end, head_dim, aligned);
    hp::cp_commit();
  }
  const float sl2 = scale * hp::kLog2e;
  float o[32], m[2] = {MMT_NEG_INF, MMT_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();  // tile t visible; every thread is done with t - 1
    if (t + 1 < n_tiles) {
      const int nx = (t + 1) & 1, j1 = (t + 1) * kTile;
      hp::stage_tile(ks + nx * hp::kTileElems, kb, rs, j1, kv_end, head_dim,
                     aligned);
      hp::stage_tile(vs + nx * hp::kTileElems, vb, rs, j1, kv_end, head_dim,
                     aligned);
      hp::cp_commit();
    }
    const bf16* kt = ks + (t & 1) * hp::kTileElems;
    const bf16* vt = vs + (t & 1) * hp::kTileElems;
    float s[32];
    hp::wg_fence();
    hp::mma_ss_k64(s, qs, kt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(s);
    const int j0 = t * kTile;
    const bool edge = j0 + kTile > sk || (causal && j0 + kTile - 1 > q0);
    float mx[2] = {MMT_NEG_INF, MMT_NEG_INF};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * sl2;  // log2 units
      if (edge) {
        const int kj = j0 + hp::acc_col(e), qi = q0 + hp::acc_row(e);
        if (kj >= sk || (causal && kj > qi)) x = MMT_NEG_INF;
      }
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], hp::quad_max(mx[i]));
      alpha[i] = hp::exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      // a masked key gives 0, also while the row's max is the sentinel
      const float p = (edge && s[e] == MMT_NEG_INF)
                          ? 0.f
                          : hp::exp2_approx(s[e] - m[i]);
      s[e] = p;
      l[i] += p;
      o[e] *= alpha[i];
    }
    uint32_t pa[16];
    hp::acc_to_a(s, pa);  // p.astype(bf16)
    hp::pin(o);
    hp::pin(pa);
    hp::wg_fence();
    hp::mma_rs_k64(o, pa, vt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(o);
  }
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = hp::quad_sum(l[i]);
    const float l_safe = fmaxf(lt, MMT_L_FLOOR);
    f[i] = 1.f / l_safe;
    const int qi = q0 + hp::acc_row(2 * i);
    if ((threadIdx.x & 3) == 0 && qi < sq)
      lse[(size_t)bh * sq + qi] = lt > 0.f ? m[i] * hp::kLn2 + logf(l_safe)
                                           : 1e30f;
  }
  store_acc(slice(out, b, h, sq, rs, head_dim) + (size_t)q0 * rs, rs, o, f,
            sq - q0, head_dim, aligned);
}

// dq: 64 query rows against the key tiles up to their diagonal.
__global__ void __launch_bounds__(hp::kWarpgroup) attn_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* dos = qs + hp::kTileElems;
  bf16* ks = dos + hp::kTileElems;     // 2 stages
  bf16* vs = ks + 2 * hp::kTileElems;  // 2 stages
  hp::zero_smem(qs, 6 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* kb = slice(k, b, h, sk, rs, head_dim);
  const bf16* vb = slice(v, b, h, sk, rs, head_dim);
  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  __syncthreads();
  if (n_tiles > 0) {
    hp::stage_tile(qs, slice(q, b, h, sq, rs, head_dim), rs, q0, sq,
                   head_dim, aligned);
    hp::stage_tile(dos, slice(dout, b, h, sq, rs, head_dim), rs, q0, sq,
                   head_dim, aligned);
    hp::stage_tile(ks, kb, rs, 0, kv_end, head_dim, aligned);
    hp::stage_tile(vs, vb, rs, 0, kv_end, head_dim, aligned);
    hp::cp_commit();
  }
  // this thread's two rows: lse in log2 units, delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + hp::acc_row(2 * i);
    const bool ok = qi < sq;
    lse2[i] = ok ? lse[(size_t)bh * sq + qi] * hp::kLog2e : 0.f;
    dl[i] = ok ? delta[(size_t)bh * sq + qi] : 0.f;
  }
  const float sl2 = scale * hp::kLog2e;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int nx = (t + 1) & 1, j1 = (t + 1) * kTile;
      hp::stage_tile(ks + nx * hp::kTileElems, kb, rs, j1, kv_end, head_dim,
                     aligned);
      hp::stage_tile(vs + nx * hp::kTileElems, vb, rs, j1, kv_end, head_dim,
                     aligned);
      hp::cp_commit();
    }
    const bf16* kt = ks + (t & 1) * hp::kTileElems;
    const bf16* vt = vs + (t & 1) * hp::kTileElems;
    float s[32], dp[32];
    hp::wg_fence();
    hp::mma_ss_k64(s, qs, kt);
    hp::mma_ss_k64(dp, dos, vt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(s);
    hp::pin(dp);
    const int j0 = t * kTile;
    const bool edge = j0 + kTile > sk || (causal && j0 + kTile - 1 > q0);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float p = hp::exp2_approx(s[e] * sl2 - lse2[i]);
      if (edge) {
        const int kj = j0 + hp::acc_col(e), qi = q0 + hp::acc_row(e);
        if (kj >= sk || (causal && kj > qi)) p = 0.f;
      }
      s[e] = p * (dp[e] - dl[i]);
    }
    uint32_t da[16];
    hp::acc_to_a(s, da);  // ds.astype(bf16)
    hp::pin(acc);
    hp::pin(da);
    hp::wg_fence();
    hp::mma_rs_k64(acc, da, kt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(acc);
  }
  const float f[2] = {scale, scale};
  store_acc(slice(dq, b, h, sq, rs, head_dim) + (size_t)q0 * rs, rs, acc, f,
            sq - q0, head_dim, aligned);
}

// dk, dv: 64 key rows against the query tiles from their diagonal on.
__global__ void __launch_bounds__(hp::kWarpgroup) attn_dkdv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* vs = ks + hp::kTileElems;
  bf16* qs = vs + hp::kTileElems;       // 2 stages
  bf16* dos = qs + 2 * hp::kTileElems;  // 2 stages
  float* ls = reinterpret_cast<float*>(dos + 2 * hp::kTileElems);  // 2 x 64
  float* dls = ls + 2 * kTile;                                     // 2 x 64
  hp::zero_smem(ks, 6 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* qb = slice(q, b, h, sq, rs, head_dim);
  const bf16* db = slice(dout, b, h, sq, rs, head_dim);
  const float* lb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  // causal: queries before k0 see none of this block's keys
  const int i_start = causal ? k0 : 0;
  const int n_tiles = sq > i_start ? (sq - i_start + kTile - 1) / kTile : 0;
  const int tid = threadIdx.x;
  auto stage_queries = [&](int t) {
    const int st = t & 1, i0 = i_start + t * kTile;
    hp::stage_tile(qs + st * hp::kTileElems, qb, rs, i0, sq, head_dim,
                   aligned);
    hp::stage_tile(dos + st * hp::kTileElems, db, rs, i0, sq, head_dim,
                   aligned);
    const int r = tid & (kTile - 1), i = i0 + r;
    const float* src = tid < kTile ? lb : dlb;
    float* dst = (tid < kTile ? ls : dls) + st * kTile + r;
    hp::cp_async4(dst, i < sq ? src + i : src, i < sq ? 4 : 0);
  };
  __syncthreads();
  if (n_tiles > 0) {
    hp::stage_tile(ks, slice(k, b, h, sk, rs, head_dim), rs, k0, sk,
                   head_dim, aligned);
    hp::stage_tile(vs, slice(v, b, h, sk, rs, head_dim), rs, k0, sk,
                   head_dim, aligned);
    stage_queries(0);
    hp::cp_commit();
  }
  const float sl2 = scale * hp::kLog2e;
  const int quad = 2 * (tid & 3);
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      stage_queries(t + 1);
      hp::cp_commit();
    }
    const int st = t & 1, i0 = i_start + t * kTile;
    const bf16* qt = qs + st * hp::kTileElems;
    const bf16* dot = dos + st * hp::kTileElems;
    float s[32], dp[32];  // transposed: rows are keys, columns queries
    hp::wg_fence();
    hp::mma_ss_k64(s, ks, qt);
    hp::mma_ss_k64(dp, vs, dot);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(s);
    hp::pin(dp);
    const bool edge = (causal && i0 < k0 + kTile) || i0 + kTile > sq ||
                      k0 + kTile > sk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the two query columns of this thread in column block j
      const float2 lq =
          *reinterpret_cast<const float2*>(ls + st * kTile + 8 * j + quad);
      const float2 dd =
          *reinterpret_cast<const float2*>(dls + st * kTile + 8 * j + quad);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * j + u;
        const float lse_c = (u & 1) ? lq.y : lq.x;
        const float dl_c = (u & 1) ? dd.y : dd.x;
        float p = hp::exp2_approx(s[e] * sl2 - lse_c * hp::kLog2e);
        if (edge) {
          const int kj = k0 + hp::acc_row(e), qi = i0 + hp::acc_col(e);
          if (kj >= sk || qi >= sq || (causal && qi < kj)) p = 0.f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - dl_c);
      }
    }
    uint32_t pa[16], da[16];
    hp::acc_to_a(s, pa);   // p.astype(bf16)
    hp::acc_to_a(dp, da);  // ds.astype(bf16)
    hp::pin(dva);
    hp::pin(dka);
    hp::pin(pa);
    hp::pin(da);
    hp::wg_fence();
    hp::mma_rs_k64(dva, pa, dot);
    hp::mma_rs_k64(dka, da, qt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(dva);
    hp::pin(dka);
  }
  const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
  const size_t at = (size_t)k0 * rs;
  store_acc(slice(dk, b, h, sk, rs, head_dim) + at, rs, dka, fk, sk - k0,
            head_dim, aligned);
  store_acc(slice(dv, b, h, sk, rs, head_dim) + at, rs, dva, fv, sk - k0,
            head_dim, aligned);
}

// dynamic shared memory of each kernel: its tiles, dk/dv's lse and delta
// stages, and 1 KB to align the tiles to the swizzle atom
constexpr int kFwdSmem = 5 * hp::kTileElems * 2 + 1024;
constexpr int kDqSmem = 6 * hp::kTileElems * 2 + 1024;
constexpr int kDkdvSmem = 6 * hp::kTileElems * 2 + 4 * kTile * 4 + 1024;

using hp::allow_smem;
using hp::rows_aligned;

struct Shape {
  int batch, sq, sk, n_heads, head_dim;
  float scale;
  int causal;
};

// f32: the CUDA-core kernels

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

// bf16: the tensor-core kernels, one block per (batch * head, 64-row tile)

template <typename OutT>
void launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                      void* lse, const Shape& s, cudaStream_t st) {
  static_assert(kFwdSmem <= 48 * 1024, "the forward's tiles fit the default");
  const dim3 grid(s.batch * s.n_heads, (s.sq + kTile - 1) / kTile);
  attn_fwd_wgmma<OutT><<<grid, hp::kWarpgroup, kFwdSmem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (OutT*)out,
      (float*)lse, s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal,
      rows_aligned(s.head_dim, {q, k, v, out}));
}

void launch_dq_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, const Shape& s, cudaStream_t st) {
  static bool raised = false;
  allow_smem(attn_dq_wgmma, kDqSmem, raised);
  const dim3 grid(s.batch * s.n_heads, (s.sq + kTile - 1) / kTile);
  attn_dq_wgmma<<<grid, hp::kWarpgroup, kDqSmem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, s.sq, s.sk,
      s.n_heads, s.head_dim, s.scale, s.causal,
      rows_aligned(s.head_dim, {q, k, v, dout, dq}));
}

void launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Shape& s, cudaStream_t st) {
  static bool raised = false;
  allow_smem(attn_dkdv_wgmma, kDkdvSmem, raised);
  const dim3 grid(s.batch * s.n_heads, (s.sk + kTile - 1) / kTile);
  attn_dkdv_wgmma<<<grid, hp::kWarpgroup, kDkdvSmem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, s.sq,
      s.sk, s.n_heads, s.head_dim, s.scale, s.causal,
      rows_aligned(s.head_dim, {q, k, v, dout, dk, dv}));
}

bool bad_shape(int batch, int sq, int sk, int n_heads, int head_dim) {
  return batch < 0 || sq < 0 || sk < 0 || n_heads < 0 || head_dim < 1 ||
         head_dim > kMmtMaxHeadDim;
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), all `dtype` (kMmtF32 or
// kMmtBF16); out (B, Sq, H, Dh) in f32 when out_f32, else in `dtype`; lse
// (B, H, Sq) f32. Contiguous, on the device; Dh <= 64. One launch on
// `stream`: bf16 on the tensor cores, f32 on the CUDA cores. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape or dtype the
// kernels have no instance for).
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
    launch_fwd_wgmma<float>(q, k, v, out, lse, s, st);
  else if (dtype == kMmtBF16)
    launch_fwd_wgmma<bf16>(q, k, v, out, lse, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The forward's q, k, v, the output's cotangent dout (B, Sq, H, Dh) in
// `dtype`, its lse and delta = sum(dout * out, -1), both (B, H, Sq) f32;
// dq (B, Sq, H, Dh) f32. One launch, dispatched as the forward's.
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
    launch_dq_wgmma(q, k, v, dout, lse, delta, dq, s, st);
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
    launch_dkdv_wgmma(q, k, v, dout, lse, delta, dk, dv, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
