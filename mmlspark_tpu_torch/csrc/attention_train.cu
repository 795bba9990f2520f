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
// without the tensor cores: the CUDA cores' f32 rate is 15x lower. In f32
// the same products, three tf32 ones each, bound them (attention_tf32.cuh).
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
// * f32 runs on the tensor cores in 3xTF32 (attn_fwd_tf32, attn_dq_tf32,
//   attn_dkdv_tf32 with K7's index mask, from attention_tf32.cuh, which
//   K8's f32 route shares): mma.sync m16n8k8 tf32, blocks of 32 own rows
//   whose two warp halves take alternate 32-row halves of each 64-row
//   stage of a 2-stage cp.async ring; the header says more. They hold the
//   f32 parity checks to 1e-4.
//
// Neither route falls back to PyTorch. Grads are written in f32, as the
// JAX kernels write them. Any S, any Sq != Sk under the arange causal mask
// (query i sees key j <= i), any Dh <= 64.

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// The f32 route's arguments (K7 has no positions).
attn_tf32::Args f32_args(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* out0, void* out1,
                         void* out2, const Shape& s) {
  return {(const float*)q, (const float*)k, (const float*)v,
          (const float*)dout, (const float*)lse, (const float*)delta,
          nullptr, nullptr, (float*)out0, (float*)out1, (float*)out2,
          s.batch, s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal};
}

bool bad_shape(int batch, int sq, int sk, int n_heads, int head_dim) {
  return batch < 0 || sq < 0 || sk < 0 || n_heads < 0 || head_dim < 1 ||
         head_dim > kMmtMaxHeadDim;
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), all `dtype` (kMmtF32 or
// kMmtBF16); out (B, Sq, H, Dh) in f32 when out_f32, else in `dtype`; lse
// (B, H, Sq) f32. Contiguous, on the device; Dh <= 64. One launch on
// `stream`: bf16 on wgmma, f32 in 3xTF32 on mma.sync. Returns
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
    return attn_tf32::launch<false>(
        0, f32_args(q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr, s),
        st);
  if (dtype == kMmtBF16 && out_f32)
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
    return attn_tf32::launch<false>(
        1, f32_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, s), st);
  if (dtype == kMmtBF16)
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
    return attn_tf32::launch<false>(
        2, f32_args(q, k, v, dout, lse, delta, dk, dv, nullptr, s), st);
  if (dtype == kMmtBF16)
    launch_dkdv_wgmma(q, k, v, dout, lse, delta, dk, dv, s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
