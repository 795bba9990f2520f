// f32 training attention on Hopper's tensor cores in 3xTF32: the forward
// with its softmax statistics, dq, and dk/dv. One family of kernels serves
// K7 (attention_train.cu; K5 runs through K7's kernels) and K8
// (ring_block_attention.cu), templated on the mask (kRing) and on the
// forward's epilogue; the bf16 routes of both files stay on wgmma.
//
// Replaces, in f32, the TPU kernels of mmlspark_tpu/parallel/
// pallas_attention.py: flash_attention_folded's _ffwd_call and _fbwd_call
// (K7) and _flash_bwd_call (K5), and _fring_call and _fring_bwd_call under
// flash_block_attn and folded_block_attn (K8).
//
// What bounds them on the H100: operations. 4 Dh FLOPs a visible pair for
// the forward, 6 Dh for dq, 8 Dh for dk/dv; in 3xTF32 each is three tf32
// products. K7 at the f32 parity step (B 2, S 1024, 8 heads x 64, causal)
// does 2.15 GFLOP forward: 0.0130 ms at 495 TFLOP/s, three times that, and
// about 0.020 ms at the rate mma.sync reaches on this card; the bytes
// (16.8 MB, 0.0050 ms) come far below. The CUDA cores' f32 rate would put
// the same work at 0.032 ms.
//
// The design (tf32_mma.cuh has the fragments):
//   - every product is mma.sync m16n8k8 tf32 in 3xTF32, the small products
//     first. Each f32 operand is split into a tf32 big and small part: by
//     truncation (tf32::split_trunc, the f32 CE's: two instructions a
//     value, what the products drop below about 2^-20 of each), but dp's
//     operands (dout and v) and the block's own tiles, split once, are
//     rounded to nearest (tf32::split, 2^-22). Where a row sees one key,
//     ds = p (dp - delta) cancels to rounding noise: with dp truncated, dq
//     read a scaled error of 3.4e-3 against chip_smoke.py's one-key-tile
//     limit of 1e-3 at S 1 (an H100 run), and rounding every operand cost
//     25-45% in time. dp's sums also leave the accumulator every k-step
//     (carry_product). tests/test_torch_tf32_numerics.py emulates the
//     arithmetic;
//   - a block owns kRows = 32 rows of one (batch, head): query rows for the
//     forward and dq, key rows for dk/dv. Its 4 warps are 2 row warps (16
//     rows each) x 2 halves: a stage of the stream holds 64 rows of the
//     other side, half 0 takes the first 32, half 1 the other 32, and the
//     halves' sums merge in a fixed order at the end (by their maxima for
//     the forward). At the parity shapes the grid is 512 blocks, and the
//     blocks with the most tiles launch first;
//   - the block's own operands (q; q and dout; k and v) are staged once
//     and split once, in place into their big parts with the small parts
//     in a tile beside them; their A fragments come by ldmatrix. The other
//     side streams through a 2-stage cp.async ring of 64-row f32 tiles,
//     rows padded by 4 floats (conflict-free B reads), 16-byte copies where
//     rows are 16-byte aligned (Dh % 4 == 0 and aligned pointers), 4-byte
//     ones elsewhere; rows past the end land as zeros, columns past Dh are
//     zeroed once. Stage u + 1 is in flight while stage u computes;
//   - forward: s = q k^T, online softmax in f32 on the accumulator
//     fragment in log2 units (exp2 on the special-function unit), then
//     o += p v with p's accumulator as the A operand (k permuted,
//     acc_to_a_trunc) and V's rows read in that order. dq: s = q k^T and
//     dp = dout v^T, ds = p (dp - delta) the A operand of ds k. dk/dv: the
//     transposed scores s^T = k q^T and dp^T = v dout^T directly, so p^T
//     and ds^T land in the accumulator as A operands of dv += p^T dout and
//     dk += ds^T q; lse and delta are read per accumulator column (query)
//     from the stage;
//   - the mask: K7's is the index mask (query i sees key j <= i, or every
//     key when not causal; Sq != Sk allowed), K8's comes from positions
//     (key j counts when k_pos[j] != INT32_MAX and, causal, k_pos[j] <=
//     q_pos[i], per batch row). K8's blocks first list the other side's
//     64-row tiles that hold a visible pair (build_list, the live-tile
//     list its bf16 kernels walk too: dead tiles are never staged, full
//     tiles never masked; at most kMaxTiles tiles). K7's list is arithmetic: the forward and dq stop at
//     the diagonal, dk/dv start at it. Only a half that crosses the
//     diagonal or an end, or a partial K8 tile, is masked; a masked pair
//     gives p = 0 exactly;
//   - the forward ends either normalized (K7: out, lse = m + log l, 1e30
//     for a row that sees no key) or as partials (K8: unnormalized o, m in
//     natural units, l; exactly m = -1e30, l = 0, o = 0 for such a row).
// Every sum is taken in a fixed order with no atomics: two launches give
// the same bits. Any Sq, Sk and Dh <= 64 (padded with zeros to 32 or 64
// in shared memory); grads are written in f32, scaled as the JAX kernels
// scale them.
#pragma once

#include <climits>
#include <initializer_list>

#include "common.cuh"
#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace attn_tf32 {

namespace hp = hopper;

constexpr int kRows = 32;      // a block's own rows
constexpr int kTile = 64;      // the other side's rows a stage
constexpr int kHalf = 32;      // ... a half of the warps takes
constexpr int kThreads = 128;  // 2 row warps x 2 halves
constexpr int kStages = 2;
// Blocks an SM: what the 87-106 KB of shared memory a block allows. Told
// to ptxas, it frees 255 registers a thread: left to itself, ptxas kept
// dq and dk/dv at 168 (three blocks an SM) and spilled.
constexpr int kBlocksPerSm = 2;

// the JAX package's _PAD_POS: a padded key, never visible
constexpr int kPadPos = INT_MAX;
// the longest tile list (ints in dynamic shared memory): Sk (Sq for
// dk/dv) up to 64 * kMaxTiles
constexpr int kMaxTiles = 4096;
// a tile's class in the list: dead tiles are left out
constexpr int kDead = 0, kFull = 1, kPartial = 2;

__device__ __forceinline__ bool visible(int kp, int qp, int causal) {
  return kp != kPadPos && (!causal || kp <= qp);
}

// ---------------------------------------------------------------------------
// The live-tile list (K8's blocks, bf16 and f32)

// The least and greatest position of a run of rows and, for keys,
// whether one of them is padding.
struct Span {
  int lo, hi;
  bool gap;
};

// The span of rows [j0, j0 + kN) of `pos`, by one warp (every lane gets
// it). Rows at or past `end` are left out, and count as a gap when
// end_gap; with `keys`, the pad sentinel is left out and counts as a gap.
// lo > hi: no row counted.
template <int kN = kTile>
__device__ __forceinline__ Span warp_span(const int* __restrict__ pos,
                                          int j0, int end, bool keys,
                                          bool end_gap) {
  int lo = INT_MAX, hi = INT_MIN;
  bool gap = false;
#pragma unroll
  for (int r = threadIdx.x & 31; r < kN; r += 32) {
    const bool in = j0 + r < end;
    const int p = in ? pos[j0 + r] : kPadPos;
    const bool pad = keys && p == kPadPos;
    if (in ? pad : end_gap) gap = true;
    if (in && !pad) {
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  return {__reduce_min_sync(MMT_FULL_MASK, lo),
          __reduce_max_sync(MMT_FULL_MASK, hi),
          __any_sync(MMT_FULL_MASK, gap) != 0};
}

// The class of the pairs between a span of queries and a span of keys.
__device__ __forceinline__ int classify(const Span& q, const Span& k,
                                        int causal) {
  if (q.lo > q.hi || k.lo > k.hi) return kDead;
  if (causal && k.lo > q.hi) return kDead;
  if (!k.gap && (!causal || k.hi <= q.lo)) return kFull;
  return kPartial;
}

// The other side's 64-row tiles that hold a visible pair, in order, into
// `list` (2 * tile, plus 1 for a partial tile); returns their count to
// every thread. `pos` is the other side's positions ([0, end) of this
// batch row), `own` the block's span, `own_queries` whether the block's
// rows are queries (forward, dq: the other side's keys, with rows past
// `end` a gap) or keys (dk/dv). Every warp of the 128-thread block
// classifies tiles; warp 0 compacts the list in place.
__device__ __forceinline__ int build_list(const int* __restrict__ pos,
                                          int end, const Span& own,
                                          bool own_queries, int causal,
                                          int* list, int* count) {
  const int n = (end + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n; t += hp::kWarpgroup / 32) {
    const Span other =
        warp_span(pos, t * kTile, end, own_queries, own_queries);
    const int c = own_queries ? classify(own, other, causal)
                              : classify(other, own, causal);
    if (lane == 0) list[t] = c;
  }
  __syncthreads();
  if (warp == 0) {
    int k = 0;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < n ? list[t] : kDead;
      // every lane has read its entry: the writes land at or below it
      const unsigned live = __ballot_sync(MMT_FULL_MASK, c != kDead);
      if (c != kDead)
        list[k + __popc(live & ((1u << lane) - 1))] = 2 * t + (c == kPartial);
      k += __popc(live);
    }
    if (lane == 0) *count = k;
  }
  __syncthreads();
  return *count;
}

// ---------------------------------------------------------------------------
// Shared-memory tiles

// Rows [r0, r0 + kN) of one (batch, head) slice of a [B, S, H, Dh] f32
// tensor (row j at x + j * rs; rows at or past `end` land as zeros) into
// a tile of kN rows of DP + 4 floats, columns [0, head_dim), by every
// thread as cp.async copies left in flight for the caller's commit: 16
// bytes where rows are 16-byte aligned, else 4.
template <int DP, int kN>
__device__ __forceinline__ void stage_rows(float* tile,
                                           const float* __restrict__ x,
                                           size_t rs, int r0, int end,
                                           int head_dim, bool aligned) {
  constexpr int LD = DP + 4;
  if (aligned) {
    constexpr int kC = DP / 4;  // 16-byte chunks a padded row
    const int chunks = head_dim >> 2;
#pragma unroll
    for (int i = 0; i < kN * kC / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kC, c = idx % kC, j = r0 + r;
      if (c < chunks) {
        const bool ok = j < end;
        hp::cp_async16(tile + r * LD + 4 * c,
                       ok ? x + (size_t)j * rs + 4 * c : x, ok ? 16 : 0);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kN * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, j = r0 + r;
      if (c < head_dim) {
        const bool ok = j < end;
        hp::cp_async4(tile + r * LD + c, ok ? x + (size_t)j * rs + c : x,
                      ok ? 4 : 0);
      }
    }
  }
}

// Columns [head_dim, DP) of `rows` consecutive padded rows set to zero
// (no copy writes them).
template <int DP>
__device__ __forceinline__ void zero_pad(float* tiles, int rows,
                                         int head_dim) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (c >= head_dim) tiles[r * (DP + 4) + c] = 0.f;
  }
}

// `rows` padded rows of f32 tiles split (tf32::split) in place: each
// value becomes its big part, and its small part lands at the same place
// in `small`, a tile of the same layout.
template <int DP>
__device__ __forceinline__ void split_rows(float* tiles, uint32_t* small,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int at = (i / DP) * (DP + 4) + i % DP;
    uint32_t b;
    tf32::split(tiles[at], b, small[at]);
    tiles[at] = __uint_as_float(b);
  }
}

// One (batch, head) slice's row 0 of a [B, S, H, Dh] tensor.
template <typename T>
__device__ __forceinline__ T* slice(T* x, int b, int h, int s, size_t rs,
                                    int head_dim) {
  return x + (size_t)b * s * rs + (size_t)h * head_dim;
}

// A pair of f32 outputs at p and p + 1 (p + 1 only below head_dim): one
// 8-byte store where rows are aligned.
__device__ __forceinline__ void store_pair(float* p, int col, float x,
                                           float y, int head_dim,
                                           bool aligned) {
  if (col >= head_dim) return;
  if (aligned) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (col + 1 < head_dim) p[1] = y;
  }
}

// d[n] += a b[n] for the 4 n-tiles of a 32-column half, one 8-deep k-step,
// in 3xTF32 on a fresh accumulator whose sums are then added to d in f32.
// The tensor core truncates each product's f32 sum to the accumulator's
// precision, so a long chain of products on one accumulator drifts toward
// zero by about an ulp a product; dp (and dp^T) is the product whose
// difference with delta cancels (to rounding noise where a row sees one
// key), so its sums leave the accumulator every k-step.
__device__ __forceinline__ void carry_product(float (&d)[4][4],
                                              const uint32_t (&ab)[4],
                                              const uint32_t (&as)[4],
                                              const uint32_t (&bb)[4][2],
                                              const uint32_t (&bs)[4][2]) {
  float x[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
  tf32::mma3_row(x, ab, as, bb, bs);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] += x[nt][e];
}

// ---------------------------------------------------------------------------
// The streamed side

// The other side's first row in stage u: K8's listed tile, K7's u-th tile
// from `first`.
template <bool kRing>
__device__ __forceinline__ int tile_row(const int* list, int first, int u) {
  if constexpr (kRing) return (list[u] >> 1) * kTile;
  return first + u * kTile;
}

// The key tiles a block of queries [q0, q0 + kRows) walks (forward, dq):
// K8's live ones, listed (the list's barriers also land the zero_pad
// writes), or K7's up to the diagonal; *kv_end is where its keys end.
template <bool kRing>
__device__ __forceinline__ int key_tiles(const int* qpb, const int* kpb,
                                         int q0, int sq, int sk, int causal,
                                         int* list, int* count,
                                         int* kv_end) {
  *kv_end = sk;
  if constexpr (kRing)
    return build_list(kpb, sk, warp_span<kRows>(qpb, q0, sq, false, false),
                      true, causal, list, count);
  if (causal) *kv_end = min(sk, q0 + kRows);
  return (*kv_end + kTile - 1) / kTile;
}

// Key rows [j0, j0 + kTile) into stage `st` of the forward's and dq's
// ring: k and v, and (K8) the keys' positions, the pad sentinel past sk.
template <bool kRing, int DP>
__device__ __forceinline__ void stage_keys(float* kv, int* kp_s, int st,
                                           int j0, const float* kb,
                                           const float* vb, const int* kpb,
                                           size_t rs, int sk, int head_dim,
                                           bool aligned) {
  constexpr int kT = kTile * (DP + 4);
  stage_rows<DP, kTile>(kv + 2 * st * kT, kb, rs, j0, sk, head_dim,
                        aligned);
  stage_rows<DP, kTile>(kv + (2 * st + 1) * kT, vb, rs, j0, sk, head_dim,
                        aligned);
  if constexpr (kRing) {
    const int r = threadIdx.x;
    if (r < kTile) {
      if (j0 + r < sk)
        hp::cp_async4(kp_s + st * kTile + r, kpb + j0 + r, 4);
      else
        kp_s[st * kTile + r] = kPadPos;
    }
  }
}

// The position of key j0 + c, the c-th of a half whose positions (K8)
// start at kp: K7's is its index, the pad sentinel past sk.
template <bool kRing>
__device__ __forceinline__ int key_pos(const int* kp, int j0, int c,
                                       int sk) {
  if constexpr (kRing) return kp[c];
  return j0 + c < sk ? j0 + c : kPadPos;
}

// The halves' sums, in a fixed order: half 1 puts its accumulator into
// xch ([4 N][64] floats), half 0 adds it after a barrier.
template <int N>
__device__ __forceinline__ void put_half(const float (&a)[N][4], float* xch,
                                         int pt) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) xch[(4 * n + e) * 64 + pt] = a[n][e];
}
template <int N>
__device__ __forceinline__ void add_half(float (&a)[N][4], const float* xch,
                                         int pt) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] += xch[(4 * n + e) * 64 + pt];
}

// A thread's two accumulator rows, r0 and r0 + 8 (those below `end`), of
// an [S, H, Dh] slice at `base`, scaled by f0 and f1.
template <int N>
__device__ __forceinline__ void store_rows(float* base, size_t rs,
                                           const float (&a)[N][4], float f0,
                                           float f1, int r0, int end,
                                           int head_dim, bool aligned) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < end)
      store_pair(base + (size_t)r0 * rs + col, col, a[n][0] * f0,
                 a[n][1] * f0, head_dim, aligned);
    if (r0 + 8 < end)
      store_pair(base + (size_t)(r0 + 8) * rs + col, col, a[n][2] * f1,
                 a[n][3] * f1, head_dim, aligned);
  }
}

// ---------------------------------------------------------------------------
// The kernels. kRing: K8's position mask and tile list; else K7's index
// mask. A thread's accumulator rows are 16 rw + g and 16 rw + g + 8 of the
// block's own rows (rw its row warp, g = lane / 4, t = lane % 4); column
// 8 n + 2 t + (e & 1) of n-tile n holds element e.

// Forward. K7: out normalized (f32), stat0 = lse (1e30 where no key is
// visible). K8: out = o unnormalized, stat0 = m (natural units), stat1 =
// l. Own rows are queries.
template <bool kRing, int DP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attn_fwd_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ stat0, float* __restrict__ stat1, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal, int aligned) {
  constexpr int LD = DP + 4, KS = DP / 8;
  constexpr int kT = kTile * LD;  // floats a streamed tile
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                         // [kRows][LD], the big parts
  float* kv = qf + kRows * LD;              // [stage][k | v][kTile][LD]
  uint32_t* qsm = reinterpret_cast<uint32_t*>(kv + kStages * 2 * kT);
  int* kp_s = reinterpret_cast<int*>(qsm + kRows * LD);  // [stage][kTile]
  int* count = kp_s + kStages * kTile;
  int* list = count + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp & 1, half = warp >> 1;
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const size_t rs = (size_t)n_heads * head_dim;
  const float* kb = slice(k, b, h, sk, rs, head_dim);
  const float* vb = slice(v, b, h, sk, rs, head_dim);
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  const int i0 = q0 + 16 * rw + g, i1 = i0 + 8;  // this thread's rows
  zero_pad<DP>(smem, kRows + kStages * 2 * kTile, head_dim);

  int qp0 = i0, qp1 = i1, kv_end;
  if constexpr (kRing) {
    qp0 = i0 < sq ? qpb[i0] : 0;
    qp1 = i1 < sq ? qpb[i1] : 0;
  }
  const int n =
      key_tiles<kRing>(qpb, kpb, q0, sq, sk, causal, list, count, &kv_end);
  auto stage = [&](int u) {
    stage_keys<kRing, DP>(kv, kp_s, u & 1, tile_row<kRing>(list, 0, u), kb,
                          vb, kpb, rs, sk, head_dim, aligned);
  };
  if (n > 0) {
    stage_rows<DP, kRows>(qf, slice(q, b, h, sq, rs, head_dim), rs, q0, sq,
                          head_dim, aligned);
    stage(0);
  }
  hp::cp_commit();

  const float sl2 = scale * hp::kLog2e;
  float o[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = MMT_NEG_INF, m1 = MMT_NEG_INF;  // log2 units
  float l0 = 0.f, l1 = 0.f;                  // this thread's columns only

  for (int u = 0; u < n; ++u) {
    const int st = u & 1;
    if (u + 1 < n) stage(u + 1);
    hp::cp_commit();
    hp::cp_wait<1>();
    __syncthreads();  // stage u (and q) landed
    if (u == 0) {
      split_rows<DP>(qf, qsm, kRows);
      __syncthreads();
    }
    const int j0 = tile_row<kRing>(list, 0, u) + kHalf * half;
    if (j0 < kv_end) {                          // warp-uniform
      bool partial;
      if constexpr (kRing)
        partial = list[u] & 1;
      else
        partial = j0 + kHalf > sk || (causal && j0 + kHalf - 1 > q0);
      const float* kt = kv + 2 * st * kT + kHalf * half * LD;
      const float* vt = kt + kT;
      const int* kp_st = kp_s + st * kTile + kHalf * half;  // K8's
      // s = q k^T over the half's 32 keys: 4 n-tiles of 8 keys
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4], bb[4][2], bs[4][2];
        tf32::ldsm_a(qf + 16 * rw * LD + 8 * kk, LD, ab);
        tf32::ldsm_a(qsm + 16 * rw * LD + 8 * kk, LD, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tf32::load_b_pair<false>(kt + (8 * nt + g) * LD + 8 * kk + t, 4,
                                   bb[nt], bs[nt]);
        tf32::mma3_row(s, ab, as, bb, bs);
      }
      // online softmax; masked pairs take the sentinel, then p = 0
      float mx0 = MMT_NEG_INF, mx1 = MMT_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool vis =
              !partial ||
              visible(key_pos<kRing>(kp_st, j0, 8 * nt + 2 * t + (e & 1), sk),
                      e < 2 ? qp0 : qp1, causal);
          const float x = vis ? s[nt][e] * sl2 : MMT_NEG_INF;
          s[nt][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, hp::quad_max(mx0));
      const float mn1 = fmaxf(m1, hp::quad_max(mx1));
      const float al0 = hp::exp2_approx(m0 - mn0);
      const float al1 = hp::exp2_approx(m1 - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p =
              (partial && x == MMT_NEG_INF)
                  ? 0.f
                  : hp::exp2_approx(x - (e < 2 ? mn0 : mn1));
          s[nt][e] = p;
          if (e < 2)
            ps0 += p;
          else
            ps1 += p;
        }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        o[dt][0] *= al0;
        o[dt][1] *= al0;
        o[dt][2] *= al1;
        o[dt][3] *= al1;
      }
      // o += p v: k-step nt is keys 8 nt .. 8 nt + 7 in acc_to_a's order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t pb[4], pq[4], bb[KS][2], bs[KS][2];
        tf32::acc_to_a_trunc(s[nt], pb, pq);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt)
          tf32::load_b_pair<false>(vt + (8 * nt + 2 * t) * LD + 8 * dt + g,
                                   LD, bb[dt], bs[dt]);
        tf32::mma3_row(o, pb, pq, bb, bs);
      }
    }
    __syncthreads();  // stage st is free for stage u + 2
  }
  hp::cp_wait_all();
  __syncthreads();  // also where no stage ran: the ring is free

  // merge half 1 into half 0, in that order
  l0 = hp::quad_sum(l0);
  l1 = hp::quad_sum(l1);
  constexpr int kX = 64;  // threads a half
  const int pt = tid % kX;
  float* xch = kv;        // [4 + 4 KS][kX]: m0, m1, l0, l1, o
  if (half == 1) {
    xch[0 * kX + pt] = m0;
    xch[1 * kX + pt] = m1;
    xch[2 * kX + pt] = l0;
    xch[3 * kX + pt] = l1;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 + 4 * dt + e) * kX + pt] = o[dt][e];
  }
  __syncthreads();
  if (half == 1) return;
  const float mb0 = xch[0 * kX + pt], mb1 = xch[1 * kX + pt];
  const float mm0 = fmaxf(m0, mb0), mm1 = fmaxf(m1, mb1);
  const float ca0 = hp::exp2_approx(m0 - mm0);
  const float cb0 = hp::exp2_approx(mb0 - mm0);
  const float ca1 = hp::exp2_approx(m1 - mm1);
  const float cb1 = hp::exp2_approx(mb1 - mm1);
  const float lt0 = l0 * ca0 + xch[2 * kX + pt] * cb0;
  const float lt1 = l1 * ca1 + xch[3 * kX + pt] * cb1;
  // K7 normalizes; K8 leaves o as the partial sum
  const float f0 = kRing ? 1.f : 1.f / fmaxf(lt0, MMT_L_FLOOR);
  const float f1 = kRing ? 1.f : 1.f / fmaxf(lt1, MMT_L_FLOOR);
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[dt][e] = o[dt][e] * (e < 2 ? ca0 : ca1) +
                 xch[(4 + 4 * dt + e) * kX + pt] * (e < 2 ? cb0 : cb1);
  store_rows(slice(out, b, h, sq, rs, head_dim), rs, o, f0, f1, i0, sq,
             head_dim, aligned);
  if (t == 0) {
    const float mr[2] = {mm0, mm1}, lr[2] = {lt0, lt1};
    const int ir[2] = {i0, i1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ir[i] >= sq) continue;
      const size_t at = (size_t)bh * sq + ir[i];
      if constexpr (kRing) {
        // the sentinel as it is, not scaled by ln 2
        stat0[at] = lr[i] > 0.f ? mr[i] * hp::kLn2 : MMT_NEG_INF;
        stat1[at] = lr[i];
      } else {
        stat0[at] = lr[i] > 0.f ? mr[i] * hp::kLn2 +
                                      logf(fmaxf(lr[i], MMT_L_FLOOR))
                                : 1e30f;
      }
    }
  }
}

// dq = scale * sum_j ds_ij k_j, ds = p (dp - delta), p = exp(s - lse) on
// visible pairs (lse = +1e30 on a K8 row with no visible key: p = 0). Own
// rows are queries.
template <bool kRing, int DP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attn_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int sq, int sk, int n_heads, int head_dim,
    float scale, int causal, int aligned) {
  constexpr int LD = DP + 4, KS = DP / 8;
  constexpr int kT = kTile * LD;
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                 // [q | dout][kRows][LD], the big parts
  float* kv = qf + 2 * kRows * LD;  // [stage][k | v][kTile][LD]
  uint32_t* qsm = reinterpret_cast<uint32_t*>(kv + kStages * 2 * kT);
  int* kp_s = reinterpret_cast<int*>(qsm + 2 * kRows * LD);
  int* count = kp_s + kStages * kTile;
  int* list = count + 4;
  const float* df = qf + kRows * LD;
  const uint32_t* dsm = qsm + kRows * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp & 1, half = warp >> 1;
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const size_t rs = (size_t)n_heads * head_dim;
  const float* kb = slice(k, b, h, sk, rs, head_dim);
  const float* vb = slice(v, b, h, sk, rs, head_dim);
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  const int i0 = q0 + 16 * rw + g, i1 = i0 + 8;
  zero_pad<DP>(smem, 2 * kRows + kStages * 2 * kTile, head_dim);

  int qp0 = i0, qp1 = i1, kv_end;
  if constexpr (kRing) {
    qp0 = i0 < sq ? qpb[i0] : 0;
    qp1 = i1 < sq ? qpb[i1] : 0;
  }
  const int n =
      key_tiles<kRing>(qpb, kpb, q0, sq, sk, causal, list, count, &kv_end);
  auto stage = [&](int u) {
    stage_keys<kRing, DP>(kv, kp_s, u & 1, tile_row<kRing>(list, 0, u), kb,
                          vb, kpb, rs, sk, head_dim, aligned);
  };
  if (n > 0) {
    stage_rows<DP, kRows>(qf, slice(q, b, h, sq, rs, head_dim), rs, q0, sq,
                          head_dim, aligned);
    stage_rows<DP, kRows>(qf + kRows * LD, slice(dout, b, h, sq, rs,
                                                 head_dim),
                          rs, q0, sq, head_dim, aligned);
    stage(0);
  }
  hp::cp_commit();
  // this thread's two rows: lse in log2 units (+1e30 past sq: p = 0), delta
  const float lse0 = (i0 < sq ? lse[(size_t)bh * sq + i0] : 1e30f) *
                     hp::kLog2e;
  const float lse1 = (i1 < sq ? lse[(size_t)bh * sq + i1] : 1e30f) *
                     hp::kLog2e;
  const float dl0 = i0 < sq ? delta[(size_t)bh * sq + i0] : 0.f;
  const float dl1 = i1 < sq ? delta[(size_t)bh * sq + i1] : 0.f;

  const float sl2 = scale * hp::kLog2e;
  float acc[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int st = u & 1;
    if (u + 1 < n) stage(u + 1);
    hp::cp_commit();
    hp::cp_wait<1>();
    __syncthreads();
    if (u == 0) {
      split_rows<DP>(qf, qsm, 2 * kRows);
      __syncthreads();
    }
    const int j0 = tile_row<kRing>(list, 0, u) + kHalf * half;
    if (j0 < kv_end) {
      bool partial;
      if constexpr (kRing)
        partial = list[u] & 1;
      else
        partial = j0 + kHalf > sk || (causal && j0 + kHalf - 1 > q0);
      const float* kt = kv + 2 * st * kT + kHalf * half * LD;
      const float* vt = kt + kT;
      const int* kp_st = kp_s + st * kTile + kHalf * half;  // K8's
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4], bb[4][2], bs[4][2];
        const int at = 16 * rw * LD + 8 * kk;
        tf32::ldsm_a(qf + at, LD, ab);
        tf32::ldsm_a(qsm + at, LD, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tf32::load_b_pair<false>(kt + (8 * nt + g) * LD + 8 * kk + t, 4,
                                   bb[nt], bs[nt]);
        tf32::mma3_row(s, ab, as, bb, bs);
        tf32::ldsm_a(df + at, LD, ab);
        tf32::ldsm_a(dsm + at, LD, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tf32::load_b_pair<true>(vt + (8 * nt + g) * LD + 8 * kk + t, 4,
                                  bb[nt], bs[nt]);
        carry_product(dp, ab, as, bb, bs);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = hp::exp2_approx(s[nt][e] * sl2 - (e < 2 ? lse0 : lse1));
          if (partial &&
              !visible(key_pos<kRing>(kp_st, j0, 8 * nt + 2 * t + (e & 1),
                                      sk),
                       e < 2 ? qp0 : qp1, causal))
            p = 0.f;
          s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));
        }
      // acc += ds k: k-step nt is keys 8 nt .. 8 nt + 7 in acc_to_a's order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t ab[4], as[4], bb[KS][2], bs[KS][2];
        tf32::acc_to_a_trunc(s[nt], ab, as);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt)
          tf32::load_b_pair<false>(kt + (8 * nt + 2 * t) * LD + 8 * dt + g,
                                   LD, bb[dt], bs[dt]);
        tf32::mma3_row(acc, ab, as, bb, bs);
      }
    }
    __syncthreads();
  }
  hp::cp_wait_all();
  __syncthreads();

  // half 1's sums into half 0's
  if (half == 1) put_half(acc, kv, tid % 64);
  __syncthreads();
  if (half == 1) return;
  add_half(acc, kv, tid % 64);
  store_rows(slice(dq, b, h, sq, rs, head_dim), rs, acc, scale, scale, i0,
             sq, head_dim, aligned);
}

// dv_j = sum_i p_ij do_i, dk_j = scale * sum_i ds_ij q_i. Own rows are
// keys; the stream is q, dout and, per query, lse (+1e30 past sq: p = 0),
// delta and (K8) the position.
template <bool kRing, int DP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attn_dkdv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int n_heads, int head_dim, float scale, int causal, int aligned) {
  constexpr int LD = DP + 4, KS = DP / 8;
  constexpr int kT = kTile * LD;
  extern __shared__ __align__(16) float smem[];
  float* kf = smem;                 // [k | v][kRows][LD], the big parts
  float* qd = kf + 2 * kRows * LD;  // [stage][q | dout][kTile][LD]
  uint32_t* ksm = reinterpret_cast<uint32_t*>(qd + kStages * 2 * kT);
  float* ls = reinterpret_cast<float*>(ksm + 2 * kRows * LD);  // [stage][64]
  float* dls = ls + kStages * kTile;                            // [stage][64]
  int* qp_s = reinterpret_cast<int*>(dls + kStages * kTile);    // [stage][64]
  int* count = qp_s + kStages * kTile;
  int* list = count + 4;
  const float* vf = kf + kRows * LD;
  const uint32_t* vsm = ksm + kRows * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp & 1, half = warp >> 1;
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int k0 = blockIdx.y * kRows;  // the first key rows see the most
  const size_t rs = (size_t)n_heads * head_dim;
  const float* qb = slice(q, b, h, sq, rs, head_dim);
  const float* db = slice(dout, b, h, sq, rs, head_dim);
  const float* lb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  const int* qpb = q_pos + (size_t)b * sq;
  const int* kpb = k_pos + (size_t)b * sk;
  const int j0r = k0 + 16 * rw + g, j1r = j0r + 8;  // this thread's keys
  zero_pad<DP>(smem, 2 * kRows + kStages * 2 * kTile, head_dim);

  int kp0, kp1, n, i_begin = 0;
  if constexpr (kRing) {
    kp0 = j0r < sk ? kpb[j0r] : kPadPos;
    kp1 = j1r < sk ? kpb[j1r] : kPadPos;
    n = build_list(qpb, sq, warp_span<kRows>(kpb, k0, sk, true, false),
                   false, causal, list, count);
  } else {
    kp0 = j0r < sk ? j0r : kPadPos;
    kp1 = j1r < sk ? j1r : kPadPos;
    // causal: queries before k0 see none of this block's keys
    if (causal) i_begin = k0;
    n = sq > i_begin ? (sq - i_begin + kTile - 1) / kTile : 0;
  }
  auto stage = [&](int u) {
    const int st = u & 1, i0 = tile_row<kRing>(list, i_begin, u);
    stage_rows<DP, kTile>(qd + 2 * st * kT, qb, rs, i0, sq, head_dim,
                          aligned);
    stage_rows<DP, kTile>(qd + (2 * st + 1) * kT, db, rs, i0, sq, head_dim,
                          aligned);
    const int r = tid & (kTile - 1), i = i0 + r;
    const bool ok = i < sq;
    if (tid < kTile) {
      if (ok)
        hp::cp_async4(ls + st * kTile + r, lb + i, 4);
      else
        ls[st * kTile + r] = 1e30f;
      if constexpr (kRing)
        hp::cp_async4(qp_s + st * kTile + r, ok ? qpb + i : qpb, ok ? 4 : 0);
    } else {
      hp::cp_async4(dls + st * kTile + r, ok ? dlb + i : dlb, ok ? 4 : 0);
    }
  };
  if (n > 0) {
    stage_rows<DP, kRows>(kf, slice(k, b, h, sk, rs, head_dim), rs, k0, sk,
                          head_dim, aligned);
    stage_rows<DP, kRows>(kf + kRows * LD, slice(v, b, h, sk, rs, head_dim),
                          rs, k0, sk, head_dim, aligned);
    stage(0);
  }
  hp::cp_commit();

  const float sl2 = scale * hp::kLog2e;
  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int st = u & 1;
    if (u + 1 < n) stage(u + 1);
    hp::cp_commit();
    hp::cp_wait<1>();
    __syncthreads();
    if (u == 0) {
      split_rows<DP>(kf, ksm, 2 * kRows);
      __syncthreads();
    }
    const int i0 = tile_row<kRing>(list, i_begin, u) + kHalf * half;
    if (i0 < sq) {
      bool partial;
      if constexpr (kRing)
        partial = list[u] & 1;
      else
        partial = i0 + kHalf > sq || k0 + kRows > sk ||
                  (causal && i0 < k0 + kRows - 1);
      const float* qt = qd + 2 * st * kT + kHalf * half * LD;
      const float* dot = qt + kT;
      const int c0 = st * kTile + kHalf * half;  // this half's stats
      // transposed: rows are keys, columns queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4], bb[4][2], bs[4][2];
        const int at = 16 * rw * LD + 8 * kk;
        tf32::ldsm_a(kf + at, LD, ab);
        tf32::ldsm_a(ksm + at, LD, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tf32::load_b_pair<false>(qt + (8 * nt + g) * LD + 8 * kk + t, 4,
                                   bb[nt], bs[nt]);
        tf32::mma3_row(s, ab, as, bb, bs);
        tf32::ldsm_a(vf + at, LD, ab);
        tf32::ldsm_a(vsm + at, LD, as);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          tf32::load_b_pair<true>(dot + (8 * nt + g) * LD + 8 * kk + t, 4,
                                  bb[nt], bs[nt]);
        carry_product(dp, ab, as, bb, bs);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // the two query columns of this thread in n-tile nt
        const int c = 8 * nt + 2 * t;
        const float2 lq = *reinterpret_cast<const float2*>(ls + c0 + c);
        const float2 dd = *reinterpret_cast<const float2*>(dls + c0 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? lq.y : lq.x;
          const float dl_c = (e & 1) ? dd.y : dd.x;
          float p = hp::exp2_approx(s[nt][e] * sl2 - lse_c * hp::kLog2e);
          if (partial) {
            int qp;
            if constexpr (kRing)
              qp = qp_s[c0 + c + (e & 1)];
            else
              qp = i0 + c + (e & 1) < sq ? i0 + c + (e & 1) : INT_MIN;
            if (!visible(e < 2 ? kp0 : kp1, qp, causal)) p = 0.f;
          }
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl_c);
        }
      }
      // dv += p^T dout, dk += ds^T q: k-step nt is queries 8 nt .. 8 nt + 7
      // in acc_to_a's order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t ab[4], as[4], bb[KS][2], bs[KS][2];
        const int row = (8 * nt + 2 * t) * LD + g;
        tf32::acc_to_a_trunc(s[nt], ab, as);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt)
          tf32::load_b_pair<false>(dot + row + 8 * dt, LD, bb[dt], bs[dt]);
        tf32::mma3_row(dva, ab, as, bb, bs);
        tf32::acc_to_a_trunc(dp[nt], ab, as);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt)
          tf32::load_b_pair<false>(qt + row + 8 * dt, LD, bb[dt], bs[dt]);
        tf32::mma3_row(dka, ab, as, bb, bs);
      }
    }
    __syncthreads();
  }
  hp::cp_wait_all();
  __syncthreads();

  // half 1's sums into half 0's: dk, then dv
  float* xv = qd + 4 * KS * 64;
  if (half == 1) {
    put_half(dka, qd, tid % 64);
    put_half(dva, xv, tid % 64);
  }
  __syncthreads();
  if (half == 1) return;
  add_half(dka, qd, tid % 64);
  add_half(dva, xv, tid % 64);
  store_rows(slice(dk, b, h, sk, rs, head_dim), rs, dka, scale, scale, j0r,
             sk, head_dim, aligned);
  store_rows(slice(dv, b, h, sk, rs, head_dim), rs, dva, 1.f, 1.f, j0r, sk,
             head_dim, aligned);
}

// ---------------------------------------------------------------------------
// Host: the launches

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int *q_pos, *k_pos;  // K8 only
  float *out0, *out1, *out2;
  int batch, sq, sk, n_heads, head_dim;
  float scale;
  int causal;
};

// The cp.async path's condition: every row starts 16-byte aligned.
inline bool rows_aligned(int head_dim,
                         std::initializer_list<const void*> ptrs) {
  if (head_dim % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Dynamic shared memory (bytes) of kernel `which` (0 forward, 1 dq, 2
// dk/dv) with a list of n tiles: its own tiles in both parts, the ring,
// the per-stage words and the list.
template <int DP>
constexpr int smem_bytes(int which, int n) {
  const int own = which == 0 ? 1 : 2;  // tensors of own rows
  const int words = (which == 2 ? 3 : 1) * kStages * kTile;
  return 4 * ((DP + 4) * (2 * own * kRows + kStages * 2 * kTile) + words +
              4 + n);
}

// which: 0 forward, 1 dq, 2 dk/dv. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a K8 list past kMaxTiles (nothing launched).
template <bool kRing, int DP>
inline int launch_at(int which, const Args& a, cudaStream_t st) {
  const int own = which == 2 ? a.sk : a.sq, other = which == 2 ? a.sq : a.sk;
  const int n = kRing ? (other + kTile - 1) / kTile : 0;
  if (n > kMaxTiles) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes<DP>(which, n);
  const int most = smem_bytes<DP>(which, kRing ? kMaxTiles : 0);
  const dim3 grid(a.batch * a.n_heads, (own + kRows - 1) / kRows);
  const int al = rows_aligned(a.head_dim, {a.q, a.k, a.v, a.dout, a.out0,
                                           a.out1});
  cudaError_t rc;
  if (which == 0) {
    static bool raised = false;
    rc = hp::allow_smem(attn_fwd_tf32<kRing, DP>, most, raised);
    if (rc == cudaSuccess)
      attn_fwd_tf32<kRing, DP><<<grid, kThreads, bytes, st>>>(
          a.q, a.k, a.v, a.q_pos, a.k_pos, a.out0, a.out1, a.out2, a.sq,
          a.sk, a.n_heads, a.head_dim, a.scale, a.causal, al);
  } else if (which == 1) {
    static bool raised = false;
    rc = hp::allow_smem(attn_dq_tf32<kRing, DP>, most, raised);
    if (rc == cudaSuccess)
      attn_dq_tf32<kRing, DP><<<grid, kThreads, bytes, st>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_pos, a.k_pos, a.out0,
          a.sq, a.sk, a.n_heads, a.head_dim, a.scale, a.causal, al);
  } else {
    static bool raised = false;
    rc = hp::allow_smem(attn_dkdv_tf32<kRing, DP>, most, raised);
    if (rc == cudaSuccess)
      attn_dkdv_tf32<kRing, DP><<<grid, kThreads, bytes, st>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_pos, a.k_pos, a.out0,
          a.out1, a.sq, a.sk, a.n_heads, a.head_dim, a.scale, a.causal, al);
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// The f32 route of an entry: Dh padded to 32 or 64.
template <bool kRing>
inline int launch(int which, const Args& a, cudaStream_t st) {
  return a.head_dim <= 32 ? launch_at<kRing, 32>(which, a, st)
                          : launch_at<kRing, 64>(which, a, st);
}

}  // namespace attn_tf32
