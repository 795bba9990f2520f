// Fused softmax cross-entropy, forward: per token t,
//   ce[t] = lse_v(h[t] @ W[:, v]) - sum_{v == label[t]} (h[t] @ W[:, v]).
//
// Replaces the TPU kernel mmlspark_tpu/ops/fused_ce.py fused_softmax_xent
// (forward: _fwd_call, kernel body _ce_fwd_kernel).
//
// What bounds it on the H100. At the speculative verify's shape (T = 24
// tokens, D = 512, V = 32768, f32) it must read W once, 4 * D * V = 67.1 MB:
// 0.020 ms at 3.35 TB/s; its 2 * T * D * V = 0.81 GFLOP take 0.012 ms at
// the f32 rate. So bytes, with operations close behind. At the train
// step's shape (T = 8192, bf16) the same 2 * T * D * V is 275 GFLOP: 0.278
// ms at the bf16 tensor-core rate, against 0.18 ms of bytes (h 8 MB, W 32
// MB, and the stored bf16 logits, 537 MB, the only large write):
// operations, with the logits' write second.
//
// The Hopper blocks run in no order, so where the TPU kernel walks a token
// tile's vocab tiles in order and carries (m, s, gold) in VMEM, the vocab
// is split over blocks: each block computes a (rows, 128) tile of logits
// over all of D and reduces it to per-token partials over its 128-column
// slice, (m, s, gold) with m the slice's max, s = sum exp(l - m) and gold
// the sum of the logits whose column equals the label (the JAX in-tile
// iota == label mask; a label that matches no column gives 0). Columns at
// or past V enter neither. A second small launch merges the slices per
// token: m = max m_j, s = sum s_j exp(m_j - m), ce = m + log(s) - gold.
// No logit reaches device memory but the training variant's stored tile.
// The training variant (the train step's loss, 1 launch pair per step)
// also stores the logit tile in the input dtype and, from the merge, lse
// = m + log(s); the backward (fused_ce_backward.cu) rebuilds softmax -
// onehot from them. lse and gold come from the unrounded f32 logits.
//
// Dispatch on the input dtype, inside the entry point:
//
// * bf16 runs on the tensor cores (ce_fwd_wgmma, building blocks in
//   hopper_mma.cuh), for both the training variant and the no-store
//   forward. A block of two warpgroups owns 128 tokens x 128 vocab
//   columns, 64 tokens a warpgroup, one m64n128k16 accumulator each. D
//   streams through a 3-stage ring in 64-deep chunks that thread 0 copies
//   with TMA onto the stage's mbarrier: h's (128, 64) box as the K-major A
//   operand, W's two (64, 64) boxes read MN-major (the transpose flag: W
//   is (D, V) with V contiguous; the two 64-column atoms 8 KB apart), both
//   bf16 in the 128-byte swizzle and never widened; out-of-bounds rows and
//   columns arrive as zeros. The epilogue works on the accumulator
//   fragment: the training variant first stages its bf16 logits in the
//   free ring, then per row the max over the thread's columns and its quad
//   (quad_max), s with exp2 on a log2e prescale, and gold; then a
//   half-warp stores each row's 256 bytes, 16 bytes a lane. Two blocks
//   share an SM (97 KB of shared memory, at most 128 registers a thread),
//   so one's epilogue overlaps the other's products. TMA needs rows that
//   start 16-byte aligned (D and V multiples of 8); other rows stage
//   through element loads in the same kernel (and logits rows that are
//   not 16-byte aligned are stored element by element). Block order: the
//   token tile varies fastest, so the blocks in flight share one W slice,
//   read from device memory once; h (8 MB at T 8192) stays in L2 and is
//   re-read from there once per vocab slice (256 times at V 32768).
// * f32 keeps the CUDA-core kernel (ce_partials_kernel): block
//   (j, i) takes vocab slice j and token tile i (32 tokens), a warp owns
//   4 tokens, each thread a 4 x 4 register tile; chunks of h and W staged
//   in shared memory, the next chunk's loads in flight in registers. f32
//   FMAs, no TF32: the result matches the plain version to the
//   reassociation of the sums (the speculative verify's scores, T 24, and
//   the f32 train-parity checks at 1e-4).
//
// Neither route falls back to PyTorch. Both use 128-column slices, so the
// partials buffer is sized the same for either dtype.

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kRows = 32;   // token tile
constexpr int kCols = 128;  // vocab slice per block
constexpr int kDepth = 32;  // D chunk staged in shared memory
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTokPerWarp = kRows / kWarps;             // 4
constexpr int kColPerLane = kCols / 32;                 // 4
constexpr int kHLoads = kRows * kDepth / kThreads;      // 4
constexpr int kWLoads = kDepth * kCols / kThreads;      // 16
constexpr int kHStride = kRows + 4;  // keeps float4 reads aligned

static_assert(kTokPerWarp == 4, "the h read is one float4");
static_assert(kHLoads == 4 && kDepth == 32, "the h load map below");

// Element e of the h chunk: bits [0, 3) the low 3 bits of k, [3, 8) the
// token, [8, 10) the high 2 bits of k. A warp then reads 8 consecutive
// channels of 4 tokens (4 full 32-byte sectors) and stores them to
// hs[k][t] with stride kHStride = 36 on 32 distinct banks.
__device__ __forceinline__ void h_coord(int e, int& t, int& k) {
  t = (e >> 3) & (kRows - 1);
  k = (e & 7) | ((e >> 8) << 3);
}

template <bool kStore>
__global__ void __launch_bounds__(kThreads) ce_partials_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_g,
    float* __restrict__ logits, int n_tok, int dim, int vocab) {
  __shared__ __align__(16) float hs[kDepth][kHStride];
  __shared__ float ws[kDepth][kCols];
  const int slice = blockIdx.x;
  const int c0 = slice * kCols, t0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float hreg[kHLoads], wreg[kWLoads];
  auto load = [&](int d0) {
#pragma unroll
    for (int i = 0; i < kHLoads; ++i) {
      int t, k;
      h_coord(tid + i * kThreads, t, k);
      const bool ok = t0 + t < n_tok && d0 + k < dim;
      hreg[i] = ok ? h[(size_t)(t0 + t) * dim + d0 + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kCols, c = e % kCols;
      const bool ok = d0 + k < dim && c0 + c < vocab;
      wreg[i] = ok ? w[(size_t)(d0 + k) * vocab + c0 + c] : 0.f;
    }
  };

  float acc[kTokPerWarp][kColPerLane] = {};
  load(0);
  for (int d0 = 0; d0 < dim; d0 += kDepth) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int i = 0; i < kHLoads; ++i) {
      int t, k;
      h_coord(tid + i * kThreads, t, k);
      hs[k][t] = hreg[i];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int e = tid + i * kThreads;
      ws[e / kCols][e % kCols] = wreg[i];
    }
    __syncthreads();
    if (d0 + kDepth < dim) load(d0 + kDepth);
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&hs[k][warp * kTokPerWarp]);
      const float hr[kTokPerWarp] = {hv.x, hv.y, hv.z, hv.w};
      float wc[kColPerLane];
#pragma unroll
      for (int c = 0; c < kColPerLane; ++c) wc[c] = ws[k][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kTokPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < kColPerLane; ++c)
          acc[r][c] = fmaf(hr[r], wc[c], acc[r][c]);
    }
  }

  if (kStore) {
#pragma unroll
    for (int r = 0; r < kTokPerWarp; ++r) {
      const int t = t0 + warp * kTokPerWarp + r;
      if (t >= n_tok) continue;
#pragma unroll
      for (int c = 0; c < kColPerLane; ++c) {
        const int col = c0 + lane + 32 * c;
        if (col < vocab) mmt_store(logits + (size_t)t * vocab + col,
                                   acc[r][c]);
      }
    }
  }

  // per-token partials over this slice; every lane of the warp holds
  // kColPerLane columns of the same 4 tokens
#pragma unroll
  for (int r = 0; r < kTokPerWarp; ++r) {
    const int t = t0 + warp * kTokPerWarp + r;
    const int label = t < n_tok ? labels[t] : -1;
    float m = MMT_NEG_INF;
#pragma unroll
    for (int c = 0; c < kColPerLane; ++c)
      if (c0 + lane + 32 * c < vocab) m = fmaxf(m, acc[r][c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(MMT_FULL_MASK, m, o));
    float s = 0.f, g = 0.f;
#pragma unroll
    for (int c = 0; c < kColPerLane; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < vocab) {
        s += expf(acc[r][c] - m);
        if (col == label) g += acc[r][c];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(MMT_FULL_MASK, s, o);
      g += __shfl_xor_sync(MMT_FULL_MASK, g, o);
    }
    if (lane == 0 && t < n_tok) {
      const size_t at = (size_t)slice * n_tok + t;
      part_m[at] = m;
      part_s[at] = s;
      part_g[at] = g;
    }
  }
}

// One warp per token: merge its n_slices partial states (and write lse
// when it is asked for).
__global__ void __launch_bounds__(kThreads) ce_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ part_g, float* __restrict__ out,
    float* __restrict__ lse, int n_tok, int n_slices) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tok) return;  // whole warps leave together
  float m = MMT_NEG_INF;
  for (int j = lane; j < n_slices; j += 32)
    m = fmaxf(m, part_m[(size_t)j * n_tok + t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(MMT_FULL_MASK, m, o));
  float s = 0.f, g = 0.f;
  for (int j = lane; j < n_slices; j += 32) {
    const size_t at = (size_t)j * n_tok + t;
    s += part_s[at] * expf(part_m[at] - m);
    g += part_g[at];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(MMT_FULL_MASK, s, o);
    g += __shfl_xor_sync(MMT_FULL_MASK, g, o);
  }
  if (lane == 0) {
    out[t] = m + logf(s) - g;
    if (lse != nullptr) lse[t] = m + logf(s);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace hp = hopper;
using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 2 * hp::kWarpgroup;  // two warpgroups
constexpr int kWgRows = 2 * hp::kTileRows;      // tokens a block
constexpr int kStages = 3;
// a stage: h's two 64-token tiles, then W's two 64-column tiles
constexpr int kStageElems = 4 * hp::kTileElems;
// the ring, a full barrier a stage, and 1 KB to align the tiles
constexpr int kWgSmem = kStages * kStageElems * 2 + kStages * 8 + 1024;
// the bf16 logits tile's row stride when staged for the stores (272
// bytes: 16-byte aligned rows, a quad's pair writes of 8 rows on 32 banks)
constexpr int kOutLd = kCols + 8;
static_assert(2 * hp::kTileCols == kCols, "a block's columns are one slice");
static_assert(kWgRows * kOutLd <= kStages * kStageElems, "fits the ring");

// Block b: token tile b % n_tiles (128 tokens), vocab slice b / n_tiles.
// `tma`: h's and W's rows are 16-byte aligned and the maps are set, so
// thread 0 copies each chunk's tiles with TMA (h's 128 x 64 box as two
// stacked tiles, W's two 64 x 64 boxes); else every thread stages them by
// element loads.
template <bool kStore>
__global__ void __launch_bounds__(kWgThreads, 2) ce_fwd_wgmma(
    const __grid_constant__ CUtensorMap h_map,
    const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ h,
    const bf16* __restrict__ w, const int* __restrict__ labels,
    float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ part_g, bf16* __restrict__ logits, int n_tok,
    int dim, int vocab, int tma, int row_store) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageElems);
  const int n_tiles = (n_tok + kWgRows - 1) / kWgRows;
  const int t0 = (blockIdx.x % n_tiles) * kWgRows;
  const int slice = blockIdx.x / n_tiles, c0 = slice * kCols;
  const int wg = threadIdx.x / hp::kWarpgroup;
  const int n_chunks = (dim + hp::kTileCols - 1) / hp::kTileCols;
  auto load_chunk = [&](int kc) {  // thread 0, TMA
    const int st = kc % kStages, d0 = kc * hp::kTileCols;
    bf16* s = ring + st * kStageElems;
    hp::mbar_expect(full + st, kStageElems * 2);
    hp::tma_load(s, &h_map, full + st, d0, t0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::tma_load(s + (2 + i) * hp::kTileElems, &w_map, full + st,
                   c0 + i * hp::kTileCols, d0);
  };
  // chunk kc in its stage, visible to wgmma
  auto arrive = [&](int kc) {
    const int st = kc % kStages;
    if (tma) {
      hp::mbar_wait(full + st, (kc / kStages) & 1);
      return;
    }
    bf16* s = ring + st * kStageElems;
    const int d0 = kc * hp::kTileCols;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hp::stage_block<kWgThreads>(s + i * hp::kTileElems, h, dim,
                                  t0 + i * hp::kTileRows, n_tok, d0, dim);
      hp::stage_block<kWgThreads>(s + (2 + i) * hp::kTileElems, w, vocab,
                                  d0, dim, c0 + i * hp::kTileCols, vocab);
    }
    hp::fence_to_async();
    __syncthreads();
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) hp::mbar_init(full + st);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (tma && threadIdx.x == 0)
    for (int kc = 0; kc < kStages && kc < n_chunks; ++kc) load_chunk(kc);
  float acc[2][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
  for (int kc = 0; kc < n_chunks; ++kc) {
    arrive(kc);
    const bf16* s = ring + (kc % kStages) * kStageElems;
    const uint64_t da = hp::desc(s + wg * hp::kTileElems);
    const uint64_t db = hp::desc_mn(s + 2 * hp::kTileElems);
    hp::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::mma_ss_n128<0, 1>(hp::flat(acc), da + kk * hp::kKStep,
                            db + kk * hp::kRowStep);
    hp::wg_commit();
    hp::wg_wait_all();
    hp::pin(acc[0]);
    hp::pin(acc[1]);
    __syncthreads();  // both warpgroups are done with the stage
    if (tma && threadIdx.x == 0 && kc + kStages < n_chunks)
      load_chunk(kc + kStages);
  }

  // The training variant stages the warpgroup's (64, 128) bf16 logits in
  // the free ring first, while every accumulator is live anyway, so the
  // reductions below free them as they go.
  bf16* out = ring + wg * hp::kTileRows * kOutLd;
  if (kStore) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(
            out + hp::acc_row(e) * kOutLd + j * hp::kTileCols +
            hp::acc_col(e)) = __floats2bfloat162_rn(acc[j][e], acc[j][e + 1]);
  }
  // Per row (i = 0, 1: the thread's rows, acc_row of element 2 i) over its
  // 32 columns (elements 4 q' + 2 i + {0, 1} of both 64-column tiles) and
  // its quad: the max, s with exp2 on a log2e prescale, and gold.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + wg * hp::kTileRows + hp::acc_row(2 * i);
    const int label = t < n_tok ? labels[t] : -1;
    float m = MMT_NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = 4 * (q >> 1) + 2 * i + (q & 1);
        const int col = c0 + j * hp::kTileCols + hp::acc_col(e);
        if (col < vocab) m = fmaxf(m, acc[j][e]);
      }
    m = hp::quad_max(m);
    const float m2 = m * hp::kLog2e;
    float sum = 0.f, gold = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = 4 * (q >> 1) + 2 * i + (q & 1);
        const int col = c0 + j * hp::kTileCols + hp::acc_col(e);
        if (col < vocab) {
          sum += hp::exp2_approx(acc[j][e] * hp::kLog2e - m2);
          if (col == label) gold += acc[j][e];
        }
      }
    sum = hp::quad_sum(sum);
    gold = hp::quad_sum(gold);
    if ((threadIdx.x & 3) == 0 && t < n_tok) {
      const size_t at = (size_t)slice * n_tok + t;
      part_m[at] = m;
      part_s[at] = sum;
      part_g[at] = gold;
    }
  }
  if (kStore) {
    // a half-warp stores one row's 128 columns: 16 bytes a lane where rows
    // are 16-byte aligned, else element by element
    __syncthreads();
    const int tl = threadIdx.x % hp::kWarpgroup;
    const int r0 = t0 + wg * hp::kTileRows;
#pragma unroll
    for (int i = 0; i < hp::kTileRows * kCols / 8 / hp::kWarpgroup; ++i) {
      const int idx = tl + i * hp::kWarpgroup, r = idx >> 4, c = idx & 15;
      const int col = c0 + 8 * c;
      if (r0 + r >= n_tok || col >= vocab) continue;
      bf16* dst = logits + (size_t)(r0 + r) * vocab + col;
      const bf16* src = out + r * kOutLd + 8 * c;
      if (row_store) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && col + k < vocab; ++k) dst[k] = src[k];
      }
    }
  }
}

using hp::allow_smem;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kStore>
void launch_wgmma(const void* h, const void* w, const void* labels,
                  float* pm, size_t plane, void* logits, int n_tok, int dim,
                  int vocab, int n_slices, cudaStream_t st) {
  static bool raised = false;
  allow_smem(ce_fwd_wgmma<kStore>, kWgSmem, raised);
  CUtensorMap h_map = {}, w_map = {};
  const int tma = hp::tma_map(&h_map, h, n_tok, dim, kWgRows) &&
                  hp::tma_map(&w_map, w, dim, vocab, hp::kTileRows);
  const int row_store = vocab % 8 == 0 && aligned16(logits);
  const int n_tiles = (n_tok + kWgRows - 1) / kWgRows;
  ce_fwd_wgmma<kStore><<<n_tiles * n_slices, kWgThreads, kWgSmem, st>>>(
      h_map, w_map, (const bf16*)h, (const bf16*)w, (const int*)labels, pm,
      pm + plane, pm + 2 * plane, (bf16*)logits, n_tok, dim, vocab, tma,
      row_store);
}

template <bool kStore>
void launch_partials(const void* h, const void* w, const void* labels,
                     float* pm, size_t plane, void* logits, int n_tok,
                     int dim, int vocab, int n_slices, cudaStream_t st) {
  const dim3 grid(n_slices, (n_tok + kRows - 1) / kRows);
  ce_partials_kernel<kStore><<<grid, kThreads, 0, st>>>(
      (const float*)h, (const float*)w, (const int*)labels, pm, pm + plane,
      pm + 2 * plane, (float*)logits, n_tok, dim, vocab);
}

}  // namespace

// h (T, D) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; partials 3 * n_slices * T f32 of scratch with n_slices =
// ceil(V / 128) (checked); out (T,) f32. logits (T, V) in `dtype` and lse
// (T,) f32 are written when both are non-null (training), else neither. All
// contiguous and on the device; T, D, V >= 1. Two launches on `stream`:
// the partials (bf16 on the tensor cores, f32 on the CUDA cores) and the
// merge. Returns cudaGetLastError().
extern "C" int mmt_fused_softmax_xent_fwd(const void* h, const void* w,
                                          const void* labels, void* partials,
                                          void* out, void* logits, void* lse,
                                          int n_tok, int dim, int vocab,
                                          int n_slices, int dtype,
                                          void* stream) {
  if (n_tok < 1 || dim < 1 || vocab < 1 ||
      n_slices != (vocab + kCols - 1) / kCols ||
      (logits == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)n_slices * n_tok;
  float* pm = (float*)partials;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool store = logits != nullptr;
  if (dtype == kMmtF32 && store)
    launch_partials<true>(h, w, labels, pm, plane, logits, n_tok, dim,
                                 vocab, n_slices, st);
  else if (dtype == kMmtF32)
    launch_partials<false>(h, w, labels, pm, plane, logits, n_tok,
                                  dim, vocab, n_slices, st);
  else if (dtype == kMmtBF16 && store)
    launch_wgmma<true>(h, w, labels, pm, plane, logits, n_tok, dim, vocab,
                       n_slices, st);
  else if (dtype == kMmtBF16)
    launch_wgmma<false>(h, w, labels, pm, plane, logits, n_tok, dim, vocab,
                        n_slices, st);
  else
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  ce_merge_kernel<<<(n_tok + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pm, pm + plane, pm + 2 * plane, (float*)out, (float*)lse, n_tok,
      n_slices);
  return (int)cudaGetLastError();
}
