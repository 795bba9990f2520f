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
// visibility fall out of the positions, which need not be sorted.
// Positions are per batch row ([B, S] int32), so the ranks of a hosted
// mesh share one launch with their ranks folded into the batch.
//
// What bounds them on the H100: operations. At the ring's launch shape
// (B 8 = 4 hosted ranks x 2, S 1024, H 8, Dh 64, bf16) a full block is
// 67.1M visible pairs: the forward's 4 Dh FLOPs a pair (s and p.v) are
// 17.2 GFLOP, 0.0174 ms at the bf16 tensor-core peak, against 42.5 MB
// (q, k, v read, f32 o, m, l written, positions) or 0.0127 ms at 3.35
// TB/s; dq's 6 Dh (s, dp, ds.k) 25.8 GFLOP, 0.0261 ms, against 51 MB,
// 0.0152 ms; dk/dv's 8 Dh (s, dp, p^T.do, ds^T.q) 34.4 GFLOP, 0.0348 ms,
// against 68 MB, 0.0202 ms. A diagonal block has half the pairs, a block
// with no visible pair none: the work depends on the positions.
//
// Dispatch on the input dtype, inside each entry point, one launch each;
// neither route falls back to the other or to PyTorch:
//
// * bf16 runs on the tensor cores (ring_*_wgmma, building blocks in
//   hopper_mma.cuh, the layout of K7's kernels in attention_train.cu). One
//   warpgroup (128 threads) per block owns 64 rows of one (batch, head):
//   query rows for the forward and dq, which keep q (and dout) in shared
//   memory and stream k and v; key rows for dk/dv, which keeps k and v and
//   streams q, dout, lse, delta and the query positions. The stream is a
//   2-stage cp.async ring of 64-row bf16 tiles in the 128-byte swizzle.
//   Every product is wgmma m64n64k16 with f32 sums: s = q k^T and
//   dp = dout v^T from shared memory; p v, ds k, p^T dout and ds^T q take
//   the accumulator repacked as the A operand, with B read with the
//   transpose flag. The softmax runs on the accumulator fragment in log2
//   units (ex2); m goes out in natural units. Dh < 64 is zero-padded in
//   shared memory; rows that are not 16-byte aligned (Dh % 8 != 0, or an
//   unaligned pointer) stage through element loads.
// * f32 runs on the tensor cores in 3xTF32 (attn_fwd_tf32, attn_dq_tf32,
//   attn_dkdv_tf32 with K8's position mask, from attention_tf32.cuh, which
//   K7's f32 route shares): mma.sync m16n8k8 tf32, blocks of 32 own rows
//   walking the same live-tile list, whose two warp halves take the two
//   32-row halves of each listed 64-row tile; the header says more. They
//   hold the f32 parity checks to 1e-4.
//
// The live-tile list (both routes; build_list in attention_tf32.cuh).
// Before its loop, each block reads the positions once: its own rows'
// (64 in bf16, 32 in f32; the least and greatest over the rows below Sq,
// or below Sk for dk/dv; keys leave out the pad sentinel) and
// those of every 64-row tile on the other side, one warp a tile. A tile
// is
// * dead when no pair is visible: every key is padding, or (causal) the
//   least key position is above the greatest query position;
// * full when every pair is visible: no key is padding (nor past the
//   keys' end) and (causal) the greatest key position is at most the
//   least query position;
// * partial otherwise.
// Dead tiles go into no list; the cp.async ring stages only listed tiles,
// with their positions, and only partial tiles are masked, element by
// element, against the positions in shared memory. A block whose tiles
// are all dead (a ring step's ranks r < t) costs one pass over positions.
// The list lives in dynamic shared memory, one int a tile: at most
// kMaxTiles = 4096 tiles, so Sk (Sq for dk/dv) up to 262144; beyond that
// the entry returns cudaErrorInvalidValue.
//
// Rounding (bf16) where the JAX kernels cast: p before p.v (the
// forward) and p^T.do (dv), ds before ds.k (dq) and ds^T.q (dk); l sums
// the unrounded p. Outputs are f32: the unnormalized o with m and l, and
// the three grads. A row that sees no key comes out exactly m = -1e30,
// l = 0, o = 0 (a masked key gives p = 0 also while the row's running max
// is the sentinel); in the backward, lse = +1e30 on such a row (and, for
// dk/dv, on staged rows past Sq) makes p exactly 0. Rows past the block's
// own end compute on zero rows and are never stored. Any Sq and Sk,
// Dh <= 64.

#include <climits>

#include "attention_tf32.cuh"
#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using attn_tf32::build_list;
using attn_tf32::kMaxTiles;
using attn_tf32::kPadPos;
using attn_tf32::visible;
using attn_tf32::warp_span;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace hp = hopper;
constexpr int kTile = hp::kTileRows;
constexpr int kTileBytes = hp::kTileElems * 2;

// The key tile at j0 into one stage of the forward's and dq's stream: k
// and v (cp.async, left in flight), and the keys' positions into kp (the
// pad sentinel past sk).
__device__ __forceinline__ void stage_key_tile(
    bf16* ks, bf16* vs, int* kp, const bf16* __restrict__ kb,
    const bf16* __restrict__ vb, const int* __restrict__ kpb, size_t rs,
    int j0, int sk, int head_dim, bool aligned) {
  hp::stage_tile(ks, kb, rs, j0, sk, head_dim, aligned);
  hp::stage_tile(vs, vb, rs, j0, sk, head_dim, aligned);
  const int r = threadIdx.x;
  if (r < kTile) {
    if (j0 + r < sk)
      hp::cp_async4(kp + r, kpb + j0 + r, 4);
    else
      kp[r] = kPadPos;
  }
}

// Forward: 64 query rows against the listed key tiles. o unnormalized;
// m in natural units; a row that sees no key: m = -1e30, l = 0, o = 0.
__global__ void __launch_bounds__(hp::kWarpgroup) ring_fwd_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* ks = qs + hp::kTileElems;      // 2 stages
  bf16* vs = ks + 2 * hp::kTileElems;  // 2 stages
  int* kp_s = reinterpret_cast<int*>(vs + 2 * hp::kTileElems);  // 2 x 64
  int* qp_s = kp_s + 2 * kTile;
  int* count = qp_s + kTile;
  int* list = count + 4;
  hp::zero_smem(qs, 5 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int tid = threadIdx.x;
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* kb = hp::slice(k, b, h, sk, rs, head_dim);
  const bf16* vb = hp::slice(v, b, h, sk, rs, head_dim);
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  if (tid < kTile) qp_s[tid] = q0 + tid < sq ? qpb[q0 + tid] : 0;
  // its barriers also land the zeros and qp_s before any copy or read
  const int n_live = build_list(kpb, sk, warp_span(qpb, q0, sq, false, false),
                                true, causal, list, count);
  auto stage_keys = [&](int t) {
    const int st = t & 1;
    stage_key_tile(ks + st * hp::kTileElems, vs + st * hp::kTileElems,
                   kp_s + st * kTile, kb, vb, kpb, rs, (list[t] >> 1) * kTile,
                   sk, head_dim, aligned);
  };
  if (n_live > 0) {
    hp::stage_tile(qs, hp::slice(q, b, h, sq, rs, head_dim), rs, q0, sq,
                   head_dim, aligned);
    stage_keys(0);
    hp::cp_commit();
  }
  const float sl2 = scale * hp::kLog2e;
  float acc[32], m[2] = {MMT_NEG_INF, MMT_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int t = 0; t < n_live; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();  // tile t visible; every thread is done with t - 1
    if (t + 1 < n_live) {
      stage_keys(t + 1);
      hp::cp_commit();
    }
    const int st = t & 1;
    const bool partial = list[t] & 1;
    const bf16* kt = ks + st * hp::kTileElems;
    const bf16* vt = vs + st * hp::kTileElems;
    const int* kp = kp_s + st * kTile;
    float s[32];
    hp::wg_fence();
    hp::mma_ss_k64(s, qs, kt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(s);
    float mx[2] = {MMT_NEG_INF, MMT_NEG_INF};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * sl2;  // log2 units
      if (partial &&
          !visible(kp[hp::acc_col(e)], qp_s[hp::acc_row(e)], causal))
        x = MMT_NEG_INF;
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
      const float p = (partial && s[e] == MMT_NEG_INF)
                          ? 0.f
                          : hp::exp2_approx(s[e] - m[i]);
      s[e] = p;
      l[i] += p;
      acc[e] *= alpha[i];
    }
    uint32_t pa[16];
    hp::acc_to_a(s, pa);  // p.astype(bf16)
    hp::pin(acc);
    hp::pin(pa);
    hp::wg_fence();
    hp::mma_rs_k64(acc, pa, vt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(acc);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = hp::quad_sum(l[i]);
    const int qi = q0 + hp::acc_row(2 * i);
    if ((tid & 3) == 0 && qi < sq) {
      // the sentinel as it is, not scaled by ln 2
      m_out[(size_t)bh * sq + qi] = lt > 0.f ? m[i] * hp::kLn2 : MMT_NEG_INF;
      l_out[(size_t)bh * sq + qi] = lt;
    }
  }
  const float f[2] = {1.f, 1.f};
  hp::store_acc(hp::slice(o, b, h, sq, rs, head_dim) + (size_t)q0 * rs, rs,
                acc, f, sq - q0, head_dim, aligned);
}

// dq: 64 query rows against the listed key tiles.
__global__ void __launch_bounds__(hp::kWarpgroup) ring_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* dos = qs + hp::kTileElems;
  bf16* ks = dos + hp::kTileElems;     // 2 stages
  bf16* vs = ks + 2 * hp::kTileElems;  // 2 stages
  int* kp_s = reinterpret_cast<int*>(vs + 2 * hp::kTileElems);  // 2 x 64
  int* qp_s = kp_s + 2 * kTile;
  int* count = qp_s + kTile;
  int* list = count + 4;
  hp::zero_smem(qs, 6 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int tid = threadIdx.x;
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* kb = hp::slice(k, b, h, sk, rs, head_dim);
  const bf16* vb = hp::slice(v, b, h, sk, rs, head_dim);
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  if (tid < kTile) qp_s[tid] = q0 + tid < sq ? qpb[q0 + tid] : 0;
  const int n_live = build_list(kpb, sk, warp_span(qpb, q0, sq, false, false),
                                true, causal, list, count);
  auto stage_keys = [&](int t) {
    const int st = t & 1;
    stage_key_tile(ks + st * hp::kTileElems, vs + st * hp::kTileElems,
                   kp_s + st * kTile, kb, vb, kpb, rs, (list[t] >> 1) * kTile,
                   sk, head_dim, aligned);
  };
  if (n_live > 0) {
    hp::stage_tile(qs, hp::slice(q, b, h, sq, rs, head_dim), rs, q0, sq,
                   head_dim, aligned);
    hp::stage_tile(dos, hp::slice(dout, b, h, sq, rs, head_dim), rs, q0, sq,
                   head_dim, aligned);
    stage_keys(0);
    hp::cp_commit();
  }
  // this thread's two rows: lse in log2 units (+1e30 past sq: p = 0),
  // delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + hp::acc_row(2 * i);
    const bool ok = qi < sq;
    lse2[i] = (ok ? lse[(size_t)bh * sq + qi] : 1e30f) * hp::kLog2e;
    dl[i] = ok ? delta[(size_t)bh * sq + qi] : 0.f;
  }
  const float sl2 = scale * hp::kLog2e;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int t = 0; t < n_live; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();
    if (t + 1 < n_live) {
      stage_keys(t + 1);
      hp::cp_commit();
    }
    const int st = t & 1;
    const bool partial = list[t] & 1;
    const bf16* kt = ks + st * hp::kTileElems;
    const bf16* vt = vs + st * hp::kTileElems;
    const int* kp = kp_s + st * kTile;
    float s[32], dp[32];
    hp::wg_fence();
    hp::mma_ss_k64(s, qs, kt);
    hp::mma_ss_k64(dp, dos, vt);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(s);
    hp::pin(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float p = hp::exp2_approx(s[e] * sl2 - lse2[i]);
      if (partial &&
          !visible(kp[hp::acc_col(e)], qp_s[hp::acc_row(e)], causal))
        p = 0.f;
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
  hp::store_acc(hp::slice(dq, b, h, sq, rs, head_dim) + (size_t)q0 * rs, rs,
                acc, f, sq - q0, head_dim, aligned);
}

// dk, dv: 64 key rows against the listed query tiles.
__global__ void __launch_bounds__(hp::kWarpgroup) ring_dkdv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  bf16* vs = ks + hp::kTileElems;
  bf16* qs = vs + hp::kTileElems;       // 2 stages
  bf16* dos = qs + 2 * hp::kTileElems;  // 2 stages
  float* ls = reinterpret_cast<float*>(dos + 2 * hp::kTileElems);  // 2 x 64
  float* dls = ls + 2 * kTile;                                     // 2 x 64
  int* qp_s = reinterpret_cast<int*>(dls + 2 * kTile);             // 2 x 64
  int* kp_s = qp_s + 2 * kTile;  // the block's own keys
  int* count = kp_s + kTile;
  int* list = count + 4;
  hp::zero_smem(ks, 6 * hp::kTileElems);
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const size_t rs = (size_t)n_heads * head_dim;
  const bf16* qb = hp::slice(q, b, h, sq, rs, head_dim);
  const bf16* db = hp::slice(dout, b, h, sq, rs, head_dim);
  const float* lb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  if (tid < kTile) kp_s[tid] = k0 + tid < sk ? kpb[k0 + tid] : kPadPos;
  const int n_live = build_list(qpb, sq, warp_span(kpb, k0, sk, true, false),
                                false, causal, list, count);
  // the listed query tile t: q, dout, and per row lse (+1e30 past sq: p =
  // 0), delta and the position
  auto stage_queries = [&](int t) {
    const int st = t & 1, i0 = (list[t] >> 1) * kTile;
    hp::stage_tile(qs + st * hp::kTileElems, qb, rs, i0, sq, head_dim,
                   aligned);
    hp::stage_tile(dos + st * hp::kTileElems, db, rs, i0, sq, head_dim,
                   aligned);
    const int r = tid & (kTile - 1), i = i0 + r;
    const bool ok = i < sq;
    if (tid < kTile) {
      if (ok)
        hp::cp_async4(ls + st * kTile + r, lb + i, 4);
      else
        ls[st * kTile + r] = 1e30f;
      hp::cp_async4(qp_s + st * kTile + r, ok ? qpb + i : qpb, ok ? 4 : 0);
    } else {
      hp::cp_async4(dls + st * kTile + r, ok ? dlb + i : dlb, ok ? 4 : 0);
    }
  };
  if (n_live > 0) {
    hp::stage_tile(ks, hp::slice(k, b, h, sk, rs, head_dim), rs, k0, sk,
                   head_dim, aligned);
    hp::stage_tile(vs, hp::slice(v, b, h, sk, rs, head_dim), rs, k0, sk,
                   head_dim, aligned);
    stage_queries(0);
    hp::cp_commit();
  }
  const float sl2 = scale * hp::kLog2e;
  const int quad = 2 * (tid & 3);
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
  for (int t = 0; t < n_live; ++t) {
    hp::cp_wait_all();
    hp::fence_to_async();
    __syncthreads();
    if (t + 1 < n_live) {
      stage_queries(t + 1);
      hp::cp_commit();
    }
    const int st = t & 1;
    const bool partial = list[t] & 1;
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
        if (partial && !visible(kp_s[hp::acc_row(e)],
                                qp_s[st * kTile + hp::acc_col(e)], causal))
          p = 0.f;
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
  hp::store_acc(hp::slice(dk, b, h, sk, rs, head_dim) + at, rs, dka, fk,
                sk - k0, head_dim, aligned);
  hp::store_acc(hp::slice(dv, b, h, sk, rs, head_dim) + at, rs, dva, fv,
                sk - k0, head_dim, aligned);
}

// Dynamic shared memory for a list of n tiles: `tiles` bf16 tiles,
// `words` ints and floats of positions and row stats, the list, and 1 KB
// to align the tiles to the swizzle atom.
constexpr int smem_bytes(int tiles, int words, int n) {
  return tiles * kTileBytes + 4 * (words + 4 + n) + 1024;
}
// forward: q, 2 x (k, v); 2 x 64 key positions, 64 query positions
constexpr int kFwdTiles = 5, kFwdWords = 3 * kTile;
// dq: q, dout, 2 x (k, v); as the forward
constexpr int kDqTiles = 6, kDqWords = 3 * kTile;
// dk/dv: k, v, 2 x (q, dout); 2 x 64 each of lse, delta and query
// positions, 64 key positions
constexpr int kDkdvTiles = 6, kDkdvWords = 7 * kTile;

struct Shape {
  int batch, sq, sk, n_heads, head_dim;
  float scale;
  int causal;
};

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta, *q_pos, *k_pos;
  void *out0, *out1, *out2;
};

// bf16: the tensor-core kernels, one block per (batch * head, 64-row
// tile); false (nothing launched) past kMaxTiles

bool launch_wgmma(int which, const Ptrs& p, const Shape& s,
                  cudaStream_t st) {
  const int own = which == 2 ? s.sk : s.sq, other = which == 2 ? s.sq : s.sk;
  const int n = (other + kTile - 1) / kTile;
  if (n > kMaxTiles) return false;
  const dim3 grid(s.batch * s.n_heads, (own + kTile - 1) / kTile);
  const bf16 *q = (const bf16*)p.q, *k = (const bf16*)p.k,
             *v = (const bf16*)p.v, *dout = (const bf16*)p.dout;
  const int *qp = (const int*)p.q_pos, *kp = (const int*)p.k_pos;
  const float *lse = (const float*)p.lse, *delta = (const float*)p.delta;
  if (which == 0) {
    static bool raised = false;
    hp::allow_smem(ring_fwd_wgmma, smem_bytes(kFwdTiles, kFwdWords, kMaxTiles),
                   raised);
    ring_fwd_wgmma<<<grid, hp::kWarpgroup,
                     smem_bytes(kFwdTiles, kFwdWords, n), st>>>(
        q, k, v, qp, kp, (float*)p.out0, (float*)p.out1, (float*)p.out2,
        s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal,
        hp::rows_aligned(s.head_dim, {q, k, v, p.out0}));
  } else if (which == 1) {
    static bool raised = false;
    hp::allow_smem(ring_dq_wgmma, smem_bytes(kDqTiles, kDqWords, kMaxTiles),
                   raised);
    ring_dq_wgmma<<<grid, hp::kWarpgroup, smem_bytes(kDqTiles, kDqWords, n),
                    st>>>(q, k, v, dout, lse, delta, qp, kp, (float*)p.out0,
                          s.sq, s.sk, s.n_heads, s.head_dim, s.scale,
                          s.causal,
                          hp::rows_aligned(s.head_dim, {q, k, v, dout,
                                                        p.out0}));
  } else {
    static bool raised = false;
    hp::allow_smem(ring_dkdv_wgmma,
                   smem_bytes(kDkdvTiles, kDkdvWords, kMaxTiles), raised);
    ring_dkdv_wgmma<<<grid, hp::kWarpgroup,
                      smem_bytes(kDkdvTiles, kDkdvWords, n), st>>>(
        q, k, v, dout, lse, delta, qp, kp, (float*)p.out0, (float*)p.out1,
        s.sq, s.sk, s.n_heads, s.head_dim, s.scale, s.causal,
        hp::rows_aligned(s.head_dim, {q, k, v, dout, p.out0, p.out1}));
  }
  return true;
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
    return attn_tf32::launch<true>(
        which,
        {(const float*)p.q, (const float*)p.k, (const float*)p.v,
         (const float*)p.dout, (const float*)p.lse, (const float*)p.delta,
         (const int*)p.q_pos, (const int*)p.k_pos, (float*)p.out0,
         (float*)p.out1, (float*)p.out2, s.batch, s.sq, s.sk, s.n_heads,
         s.head_dim, s.scale, s.causal},
        st);
  if (dtype != kMmtBF16 || !launch_wgmma(which, p, s, st))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), all `dtype` (kMmtF32 or
// kMmtBF16); q_pos (B, Sq) and k_pos (B, Sk) int32 (INT32_MAX: a padded
// key); o (B, Sq, H, Dh), m and l (B, H, Sq), all f32. Contiguous, on the
// device; Dh <= 64. One launch on `stream`: bf16 on wgmma, f32 in 3xTF32
// on mma.sync. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape or dtype without an instance, or Sk past 64 * kMaxTiles).
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
// output, both (B, H, Sq) f32; dq (B, Sq, H, Dh) f32. One launch,
// dispatched as the forward's (Sk up to 64 * kMaxTiles).
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

// As mmt_ring_block_bwd_dq; dk, dv (B, Sk, H, Dh) f32 (Sq up to
// 64 * kMaxTiles). One launch.
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
