// Fused softmax cross-entropy, backward: from the forward's stored logits
// and lse, with g the per-token cotangent of ce,
//   d_l[t, v] = (exp(logits[t, v] - lse[t]) - [v == label[t]]) * g[t],
//   dh = d_l @ W^T    (T, D)      and      dW = h^T @ d_l    (D, V).
//
// Replaces the TPU kernels of mmlspark_tpu/ops/fused_ce.py _bwd_call (K6):
// _ce_dh_kernel (dh, vocab-innermost grid) and _ce_dw_kernel (dW,
// token-innermost grid). As there, d_l is rebuilt tile by tile from the
// stored logits (in the compute dtype, so bf16 logits give a bf16-rounded
// p by design) and never written to device memory; it is rounded to the
// compute dtype before each product, both products accumulate in f32, and
// dh and dW are written in the compute dtype. A label outside [0, V) adds
// no one-hot. Each output tile's whole sum (over V for dh, over T for dW)
// stays in one block: no atomics, no split-K, and two launches on the same
// inputs give bitwise-equal output.
//
// What bounds it on the H100: operations. At the train step's shape
// (T 8192, D 512, V 32768, bf16) each product is 2 * T * D * V = 275 GFLOP:
// 0.278 ms at the bf16 tensor-core rate (4.1 ms at the f32 rate of the
// CUDA cores). Bytes come second: each kernel reads the logits once (537
// MB) plus W or h, 0.17 ms at 3.35 TB/s.
//
// Dispatch on the input dtype, inside each entry point:
//
// * bf16 runs on the tensor cores (ce_dh_wgmma, ce_dw_wgmma; building
//   blocks in hopper_mma.cuh). A block is two warpgroups, one block an SM
//   (about 196 KB of shared memory). The reduction streams through a
//   4-stage ring in 64-deep chunks of bf16 tiles in the 128-byte swizzle:
//   the stored logits' tile and W's (dh) or h's (dW). Thread 0 copies each
//   chunk with TMA (a few boxes; out-of-bounds rows and columns arrive as
//   zeros) onto the stage's mbarrier, and refills a stage as soon as the
//   block is done with it, so chunks arrive three steps ahead. d_l is
//   built in place in shared memory: each thread rewrites 16-byte chunks
//   of the staged logits (exp2 on a log2e prescale, times g, rounded to
//   bf16; the label's column, at most one a row, and the columns past V
//   set apart by one branch a chunk), then fence.proxy.async hands the
//   tile to wgmma. One barrier a chunk: chunk k's products (f32 sums) run
//   while chunk k + 1's d_l is built, and the barrier both publishes that
//   d_l and frees chunk k's stage. With per-thread cp.async copies instead
//   of TMA the copies, waits and builds took longer than the products.
//   - dh: a block owns 128 tokens x 256 channels of D (64 tokens a
//     warpgroup, one m64n256k16 accumulator of 128 f32 registers a thread)
//     and loops over all of V. A = d_l (rows t, V contiguous: K-major), B =
//     W's (256, 64) box (rows d, V contiguous: K-major, four stacked
//     tiles). Each d_l element is rebuilt once per 256-channel slice of D,
//     twice at D 512: 537 M exps over the card, hidden under the products.
//     The wider the slice, the fewer rebuilds, but 128 tokens x 512
//     channels would need 256 accumulator registers a thread in two
//     warpgroups, past the 255 limit. The grid at T 8192 is 64 token tiles
//     x 2 slices = 128 blocks, one wave on 132 SMs; the two slices of a
//     token tile run side by side, so the second read of each logits tile
//     hits L2, and all blocks sweep W (32 MB) in step, so it is read from
//     device memory about once (from L2 once per token tile).
//   - dW: a block owns 256 channels x 128 vocab columns (128 channels a
//     warpgroup, two m64n128k16 accumulators) and loops over all of T. It
//     computes dW = h^T d_l with both operands read MN-major from shared
//     memory (the transpose flags; the transposed A costs no time): A = h's
//     four (64, 64) boxes (rows t, D contiguous), B = the d_l tile (rows t,
//     V contiguous, two 64-column atoms 8 KB apart). A thread's lse, g and
//     labels are read from memory two chunks ahead of their use. d_l is
//     rebuilt once per 256 channels (twice at D 512); the grid at V 32768
//     is 2 x 256 = 512 blocks (3.9 waves); the two channel slices of a
//     vocab slice run side by side (the logits' second read hits L2) and h
//     (8 MB) stays in L2, re-read from there once per vocab slice.
//   TMA needs rows that start 16-byte aligned (V, and D for dW's h,
//   multiples of 8); other rows stage through element loads by every
//   thread in the same kernels. Outputs past T, D and V are not written.
// * f32 keeps the CUDA-core kernels (ce_dh_kernel, ce_dw_kernel): each
//   block owns a 128 x 128 output tile and
//   loops over the whole reduction in 16-deep steps staged in shared
//   memory, widened to f32 (d_l computed on the way in), the next step's
//   loads in flight in registers; each of 256 threads holds an 8 x 8
//   register tile. f32 FMAs, no TF32 (the f32 train-parity checks at
//   1e-4).
//
// Neither route falls back to PyTorch.

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // output tile rows
constexpr int kBN = 128;          // output tile columns
constexpr int kBK = 16;           // reduction step staged in shared memory
constexpr int kThreads = 256;
constexpr int kLd = kBM + 4;      // padded shared row
constexpr int kLoads = kBM * kBK / kThreads;   // 8 per operand per step

static_assert(kBM == kBN && kBM == 128, "the thread tile map below");

__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4 ? 0 : 64 - 4) + ty * 4 + i;
}

// acc[i][j] += sum_k As[k][row i] * Bs[k][col j] over one staged step.
__device__ __forceinline__ void tile_fma(float (*As)[kLd], float (*Bs)[kLd],
                                         int ty, int tx,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One f32 d_l element.
__device__ __forceinline__ float d_logit(float logit, float lse, float g,
                                         int label, int col) {
  const float p = expf(logit - lse);
  return (p - (col == label ? 1.f : 0.f)) * g;
}

// dh tile (tokens t0.., channels d0..): As[v][t] = d_l[t, v],
// Bs[v][d] = W[d, v].
__global__ void __launch_bounds__(kThreads, 2) ce_dh_kernel(
    const float* __restrict__ logits, const float* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dh, int n_tok, int dim,
    int vocab) {
  __shared__ __align__(16) float As[kBK][kLd];
  __shared__ __align__(16) float Bs[kBK][kLd];
  __shared__ float row_lse[kBM], row_g[kBM];
  __shared__ int row_lbl[kBM];
  const int d0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (tid < kBM) {
    const int t = t0 + tid;
    const bool ok = t < n_tok;
    row_lse[tid] = ok ? lse[t] : 0.f;
    row_g[tid] = ok ? g[t] : 0.f;
    row_lbl[tid] = ok ? labels[t] : -1;
  }
  __syncthreads();

  float areg[kLoads], breg[kLoads];
  // element e of a step: k = e % 16 (a vocab column, contiguous in memory),
  // m = e / 16 (a token for A, a channel for B)
  auto load = [&](int v0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads, k = e % kBK, m = e / kBK;
      const int v = v0 + k, t = t0 + m, d = d0 + m;
      areg[i] = (t < n_tok && v < vocab)
                    ? d_logit(logits[(size_t)t * vocab + v], row_lse[m],
                              row_g[m], row_lbl[m], v)
                    : 0.f;
      breg[i] = (d < dim && v < vocab) ? w[(size_t)d * vocab + v] : 0.f;
    }
  };

  float acc[8][8] = {};
  load(0);
  for (int v0 = 0; v0 < vocab; v0 += kBK) {
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      As[e % kBK][e / kBK] = areg[i];
      Bs[e % kBK][e / kBK] = breg[i];
    }
    __syncthreads();
    if (v0 + kBK < vocab) load(v0 + kBK);
    tile_fma(As, Bs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + tile_row(ty, i);
    if (t >= n_tok) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + tile_row(tx, j);
      if (d < dim) mmt_store(dh + (size_t)t * dim + d, acc[i][j]);
    }
  }
}

// dW tile (channels d0.., vocab columns v0..): As[t][d] = h[t, d],
// Bs[t][v] = d_l[t, v].
__global__ void __launch_bounds__(kThreads, 2) ce_dw_kernel(
    const float* __restrict__ logits, const float* __restrict__ h,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dw, int n_tok, int dim,
    int vocab) {
  __shared__ __align__(16) float As[kBK][kLd];
  __shared__ __align__(16) float Bs[kBK][kLd];
  const int d0 = blockIdx.x * kBM, v0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float areg[kLoads], breg[kLoads];
  // element e of a step: k = e / 128 (a token), n = e % 128 (a channel for
  // A, a vocab column for B; contiguous in memory)
  auto load = [&](int tk) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads, k = e / kBN, n = e % kBN;
      const int t = tk + k, d = d0 + n, v = v0 + n;
      const bool tok = t < n_tok;
      areg[i] = (tok && d < dim) ? h[(size_t)t * dim + d] : 0.f;
      breg[i] = (tok && v < vocab)
                    ? d_logit(logits[(size_t)t * vocab + v], lse[t], g[t],
                              labels[t], v)
                    : 0.f;
    }
  };

  float acc[8][8] = {};
  load(0);
  for (int tk = 0; tk < n_tok; tk += kBK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      As[e / kBN][e % kBN] = areg[i];
      Bs[e / kBN][e % kBN] = breg[i];
    }
    __syncthreads();
    if (tk + kBK < n_tok) load(tk + kBK);
    tile_fma(As, Bs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + tile_row(ty, i);
    if (d >= dim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = v0 + tile_row(tx, j);
      if (v < vocab) mmt_store(dw + (size_t)d * vocab + v, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace hp = hopper;

constexpr int kWgThreads = 2 * hp::kWarpgroup;  // two warpgroups
constexpr int kChunk = hp::kTileCols;           // reduction chunk
constexpr int kStages = 4;
// a stage: dh's two logits tiles (64 tokens each) and four W tiles (64
// channels each); dW's four h tiles (64 channels each) and two logits
// tiles (64 vocab columns each)
constexpr int kStageElems = 6 * hp::kTileElems;
constexpr int kRingBytes = kStages * kStageElems * 2;
constexpr int kDhRows = 2 * hp::kTileRows;  // dh: tokens a block
constexpr int kDhCols = 4 * hp::kTileCols;  // dh: channels a block
constexpr int kDwRows = 4 * hp::kTileCols;  // dW: channels a block
constexpr int kDwCols = 2 * hp::kTileCols;  // dW: vocab columns a block
// the ring, a full barrier a stage, dh's per-row lse, g and label, and
// 1 KB to align the tiles
constexpr int kDhSmem = kRingBytes + kStages * 8 + 3 * kDhRows * 4 + 1024;
constexpr int kDwSmem = kRingBytes + kStages * 8 + 1024;

// One 16-byte chunk of a staged logits row (columns v .. v + 7) rewritten
// in place as d_l = (exp(l - lse) - [col == label]) g, rounded to bf16
// (lse2 = lse * log2e). Each element costs a multiply-add, an exp2 and a
// multiply; the label's column (at most one a row) and the columns at or
// past V (0) are set apart, by a branch a chunk.
__device__ __forceinline__ void d_logits8(bf16* p, int v, int vocab,
                                          float lse2, float g, int label) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t q[4] = {x.x, x.y, x.z, x.w};
  float l[8], d[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a bf16's bits are the high half of the f32 it widens to
    l[2 * k] = __uint_as_float(q[k] << 16);
    l[2 * k + 1] = __uint_as_float(q[k] & 0xffff0000u);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    d[k] = hp::exp2_approx(l[k] * hp::kLog2e - lse2) * g;
  if ((unsigned)(label - v) < 8u) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (v + k == label)
        d[k] = (hp::exp2_approx(l[k] * hp::kLog2e - lse2) - 1.f) * g;
  }
  if (v + 8 > vocab) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (v + k >= vocab) d[k] = 0.f;
  }
  *reinterpret_cast<uint4*>(p) =
      make_uint4(hp::pack_bf16(d[0], d[1]), hp::pack_bf16(d[2], d[3]),
                 hp::pack_bf16(d[4], d[5]), hp::pack_bf16(d[6], d[7]));
}

// Store a 64 x 64 accumulator's (row, column) elements at out + row * ld +
// column, cut at (rows, cols), two columns at a time when `vec`.
__device__ __forceinline__ void store_tile(bf16* out, size_t ld,
                                           const float (&d)[32], int rows,
                                           int cols, bool vec) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = hp::acc_row(e), c = hp::acc_col(e);
    if (r >= rows || c >= cols) continue;
    bf16* p = out + (size_t)r * ld + c;
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(d[e], d[e + 1]);
    } else {
      p[0] = __float2bfloat16(d[e]);
      if (c + 1 < cols) p[1] = __float2bfloat16(d[e + 1]);
    }
  }
}

// dh: block b owns channel slice b % n_slices (256 channels) of token tile
// b / n_slices (128 tokens) and loops over all of V. `tma`: thread 0
// copies each chunk's logits (one 128 x 64 box: two stacked tiles) and W
// (one 256 x 64 box: four stacked tiles, the K-major B of n256) with TMA;
// else every thread stages them by element loads.
__global__ void __launch_bounds__(kWgThreads, 1) ce_dh_wgmma(
    const __grid_constant__ CUtensorMap logits_map,
    const __grid_constant__ CUtensorMap w_map,
    const bf16* __restrict__ logits, const bf16* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, bf16* __restrict__ dh, int n_tok,
    int dim, int vocab, int tma, int vec_store) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageElems);
  float* row_lse2 = reinterpret_cast<float*>(full + kStages);
  float* row_g = row_lse2 + kDhRows;
  int* row_lbl = reinterpret_cast<int*>(row_g + kDhRows);
  const int n_slices = (dim + kDhCols - 1) / kDhCols;
  const int d0 = (blockIdx.x % n_slices) * kDhCols;
  const int t0 = (blockIdx.x / n_slices) * kDhRows;
  const int tid = threadIdx.x, wg = tid / hp::kWarpgroup;
  const int n_chunks = (vocab + kChunk - 1) / kChunk;
  if (tid < kDhRows) {
    const int t = t0 + tid;
    const bool ok = t < n_tok;
    row_lse2[tid] = ok ? lse[t] * hp::kLog2e : 0.f;
    row_g[tid] = ok ? g[t] : 0.f;
    row_lbl[tid] = ok ? labels[t] : -1;
  }
  auto load_chunk = [&](int kc) {  // thread 0, TMA
    const int st = kc % kStages, v0 = kc * kChunk;
    bf16* s = ring + st * kStageElems;
    hp::mbar_expect(full + st, kStageElems * 2);
    hp::tma_load(s, &logits_map, full + st, v0, t0);
    hp::tma_load(s + 2 * hp::kTileElems, &w_map, full + st, v0, d0);
  };
  // chunk kc in its stage, visible to every thread
  auto arrive = [&](int kc) {
    const int st = kc % kStages;
    if (tma) {
      hp::mbar_wait(full + st, (kc / kStages) & 1);
      return;
    }
    bf16* s = ring + st * kStageElems;
    const int v0 = kc * kChunk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::stage_block<kWgThreads>(s + i * hp::kTileElems, logits, vocab,
                                  t0 + i * hp::kTileRows, n_tok, v0, vocab);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hp::stage_block<kWgThreads>(s + (2 + j) * hp::kTileElems, w, vocab,
                                  d0 + j * hp::kTileRows, dim, v0, vocab);
    __syncthreads();
  };
  // d_l in place over the stage's two logits tiles: 1024 16-byte chunks
  auto build = [&](int kc) {
    bf16* s = ring + (kc % kStages) * kStageElems;
    const int v0 = kc * kChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kWgThreads, tile = idx >> 9;
      const int r = (idx >> 3) & 63, c = idx & 7, row = tile * 64 + r;
      d_logits8(s + tile * hp::kTileElems + hp::swz(r, c * 8), v0 + c * 8,
                vocab, row_lse2[row], row_g[row], row_lbl[row]);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hp::mbar_init(full + st);
    hp::mbar_init_fence();
  }
  __syncthreads();  // the barriers and the row values
  if (tma && tid == 0)
    for (int kc = 0; kc < kStages && kc < n_chunks; ++kc) load_chunk(kc);
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  arrive(0);
  build(0);
  hp::fence_to_async();
  __syncthreads();
  // One barrier a chunk: chunk kc's products run while chunk kc + 1's d_l
  // is built; the barrier publishes that d_l and frees kc's stage, which
  // thread 0 refills with chunk kc + kStages.
  for (int kc = 0; kc < n_chunks; ++kc) {
    const bf16* s = ring + (kc % kStages) * kStageElems;
    const uint64_t da = hp::desc(s + wg * hp::kTileElems);
    const uint64_t db = hp::desc(s + 2 * hp::kTileElems);
    hp::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::mma_ss_n256<0, 0>(hp::flat(acc), da + kk * hp::kKStep,
                            db + kk * hp::kKStep);
    hp::wg_commit();
    if (kc + 1 < n_chunks) {
      arrive(kc + 1);
      build(kc + 1);
      hp::fence_to_async();
    }
    hp::wg_wait_all();
#pragma unroll
    for (int j = 0; j < 4; ++j) hp::pin(acc[j]);
    __syncthreads();
    if (tma && tid == 0 && kc + kStages < n_chunks) load_chunk(kc + kStages);
  }
  const int r0 = t0 + wg * hp::kTileRows;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store_tile(dh + (size_t)r0 * dim + d0 + j * hp::kTileCols, dim, acc[j],
               n_tok - r0, dim - d0 - j * hp::kTileCols, vec_store);
}

// dW: block b owns channel slice b % n_slices (256 channels) of vocab slice
// b / n_slices (128 columns) and loops over all of T. `tma`: thread 0
// copies each chunk's four h boxes and two logits boxes (64 x 64 each)
// with TMA; else every thread stages them by element loads. The chunk's
// lse, g and labels are read from memory by the threads that use them.
__global__ void __launch_bounds__(kWgThreads, 1) ce_dw_wgmma(
    const __grid_constant__ CUtensorMap logits_map,
    const __grid_constant__ CUtensorMap h_map,
    const bf16* __restrict__ logits, const bf16* __restrict__ h,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, bf16* __restrict__ dw, int n_tok,
    int dim, int vocab, int tma, int vec_store) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(hp::align_1k(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageElems);
  const int n_slices = (dim + kDwRows - 1) / kDwRows;
  const int d0 = (blockIdx.x % n_slices) * kDwRows;
  const int v0 = (blockIdx.x / n_slices) * kDwCols;
  const int tid = threadIdx.x, wg = tid / hp::kWarpgroup;
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  auto load_chunk = [&](int kc) {  // thread 0, TMA
    const int st = kc % kStages, t0 = kc * kChunk;
    bf16* s = ring + st * kStageElems;
    hp::mbar_expect(full + st, kStageElems * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hp::tma_load(s + j * hp::kTileElems, &h_map, full + st,
                   d0 + j * hp::kTileCols, t0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::tma_load(s + (4 + i) * hp::kTileElems, &logits_map, full + st,
                   v0 + i * hp::kTileCols, t0);
  };
  auto arrive = [&](int kc) {
    const int st = kc % kStages;
    if (tma) {
      hp::mbar_wait(full + st, (kc / kStages) & 1);
      return;
    }
    bf16* s = ring + st * kStageElems;
    const int t0 = kc * kChunk;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hp::stage_block<kWgThreads>(s + j * hp::kTileElems, h, dim, t0, n_tok,
                                  d0 + j * hp::kTileCols, dim);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::stage_block<kWgThreads>(s + (4 + i) * hp::kTileElems, logits,
                                  vocab, t0, n_tok, v0 + i * hp::kTileCols,
                                  vocab);
    __syncthreads();
  };
  // The thread's rows of a chunk (r and r + 32, in both logits tiles):
  // their lse (times log2e), g and label, 0 / 0 / -1 past T. Read two
  // chunks ahead, so the loads are in flight for a whole chunk.
  const int rr = tid >> 3;
  auto rows_of = [&](int kc, float (&l2)[2], float (&gg)[2], int (&lb)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = kc * kChunk + rr + 32 * k;
      const bool ok = t < n_tok;
      l2[k] = ok ? lse[t] * hp::kLog2e : 0.f;
      gg[k] = ok ? g[t] : 0.f;
      lb[k] = ok ? labels[t] : -1;
    }
  };
  // d_l in place over the stage's two logits tiles: 1024 16-byte chunks
  auto build = [&](int kc, const float (&l2)[2], const float (&gg)[2],
                   const int (&lb)[2]) {
    bf16* s = ring + (kc % kStages) * kStageElems + 4 * hp::kTileElems;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // thread tid's chunk tid + 256 i
      const int tile = i >> 1, k = i & 1, r = rr + 32 * k, c = tid & 7;
      d_logits8(s + tile * hp::kTileElems + hp::swz(r, c * 8),
                v0 + tile * hp::kTileCols + c * 8, vocab, l2[k], gg[k],
                lb[k]);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hp::mbar_init(full + st);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (tma && tid == 0)
    for (int kc = 0; kc < kStages && kc < n_chunks; ++kc) load_chunk(kc);
  float acc[2][2][32];  // [m][n]: channels 64 m, columns 64 n
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][n][e] = 0.f;
  // rows of chunk kc + 1 (n*) and kc + 2 (f*) at the top of step kc
  float nl[2], ng[2], fl[2], fg[2];
  int nb[2], fb[2];
  rows_of(0, nl, ng, nb);
  arrive(0);
  build(0, nl, ng, nb);
  hp::fence_to_async();
  rows_of(1, nl, ng, nb);
  rows_of(2, fl, fg, fb);
  __syncthreads();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const bf16* s = ring + (kc % kStages) * kStageElems;
    const uint64_t db = hp::desc_mn(s + 4 * hp::kTileElems);
    hp::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        hp::mma_ss_n128<1, 1>(
            hp::flat(acc[m]),
            hp::desc(s + (2 * wg + m) * hp::kTileElems) + kk * hp::kRowStep,
            db + kk * hp::kRowStep);
    hp::wg_commit();
    if (kc + 1 < n_chunks) {
      arrive(kc + 1);
      build(kc + 1, nl, ng, nb);
      hp::fence_to_async();
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      nl[k] = fl[k];
      ng[k] = fg[k];
      nb[k] = fb[k];
    }
    rows_of(kc + 3, fl, fg, fb);
    hp::wg_wait_all();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      hp::pin(acc[m][0]);
      hp::pin(acc[m][1]);
    }
    __syncthreads();
    if (tma && tid == 0 && kc + kStages < n_chunks) load_chunk(kc + kStages);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r0 = d0 + (2 * wg + m) * hp::kTileRows;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c0 = v0 + n * hp::kTileCols;
      store_tile(dw + (size_t)r0 * vocab + c0, vocab, acc[m][n],
                 dim - r0, vocab - c0, vec_store);
    }
  }
}

using hp::allow_smem;

void launch_dh_wgmma(const void* logits, const void* w, const void* labels,
                     const void* g, const void* lse, void* dh, int n_tok,
                     int dim, int vocab, cudaStream_t st) {
  static bool raised = false;
  allow_smem(ce_dh_wgmma, kDhSmem, raised);
  CUtensorMap logits_map = {}, w_map = {};
  const int tma = hp::tma_map(&logits_map, logits, n_tok, vocab, kDhRows) &&
                  hp::tma_map(&w_map, w, dim, vocab, kDhCols);
  const int vec = dim % 2 == 0 && reinterpret_cast<uintptr_t>(dh) % 4 == 0;
  const int blocks = ((dim + kDhCols - 1) / kDhCols) *
                     ((n_tok + kDhRows - 1) / kDhRows);
  ce_dh_wgmma<<<blocks, kWgThreads, kDhSmem, st>>>(
      logits_map, w_map, (const bf16*)logits, (const bf16*)w,
      (const int*)labels, (const float*)g, (const float*)lse, (bf16*)dh,
      n_tok, dim, vocab, tma, vec);
}

void launch_dw_wgmma(const void* logits, const void* h, const void* labels,
                     const void* g, const void* lse, void* dw, int n_tok,
                     int dim, int vocab, cudaStream_t st) {
  static bool raised = false;
  allow_smem(ce_dw_wgmma, kDwSmem, raised);
  CUtensorMap logits_map = {}, h_map = {};
  const int tma =
      hp::tma_map(&logits_map, logits, n_tok, vocab, hp::kTileRows) &&
      hp::tma_map(&h_map, h, n_tok, dim, hp::kTileRows);
  const int vec = vocab % 2 == 0 && reinterpret_cast<uintptr_t>(dw) % 4 == 0;
  const int blocks = ((dim + kDwRows - 1) / kDwRows) *
                     ((vocab + kDwCols - 1) / kDwCols);
  ce_dw_wgmma<<<blocks, kWgThreads, kDwSmem, st>>>(
      logits_map, h_map, (const bf16*)logits, (const bf16*)h,
      (const int*)labels, (const float*)g, (const float*)lse, (bf16*)dw,
      n_tok, dim, vocab, tma, vec);
}

void launch_dh(const void* logits, const void* w, const void* labels,
               const void* g, const void* lse, void* dh, int n_tok, int dim,
               int vocab, cudaStream_t st) {
  const dim3 grid((dim + kBN - 1) / kBN, (n_tok + kBM - 1) / kBM);
  ce_dh_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)logits, (const float*)w, (const int*)labels,
      (const float*)g, (const float*)lse, (float*)dh, n_tok, dim, vocab);
}

void launch_dw(const void* logits, const void* h, const void* labels,
               const void* g, const void* lse, void* dw, int n_tok, int dim,
               int vocab, cudaStream_t st) {
  const dim3 grid((dim + kBM - 1) / kBM, (vocab + kBN - 1) / kBN);
  ce_dw_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)logits, (const float*)h, (const int*)labels,
      (const float*)g, (const float*)lse, (float*)dw, n_tok, dim, vocab);
}

}  // namespace

// logits (T, V) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; g and lse (T,) f32; dh (T, D) in `dtype`. Contiguous, on the
// device; T, D, V >= 1. One launch on `stream`: bf16 on the tensor cores,
// f32 on the CUDA cores. Returns cudaGetLastError().
extern "C" int mmt_fused_ce_dh(const void* logits, const void* w,
                               const void* labels, const void* g,
                               const void* lse, void* dh, int n_tok, int dim,
                               int vocab, int dtype, void* stream) {
  if (n_tok < 1 || dim < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dh(logits, w, labels, g, lse, dh, n_tok, dim, vocab, st);
  else if (dtype == kMmtBF16)
    launch_dh_wgmma(logits, w, labels, g, lse, dh, n_tok, dim, vocab, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// As mmt_fused_ce_dh with h (T, D) in `dtype`; dw (D, V) in `dtype`.
extern "C" int mmt_fused_ce_dw(const void* logits, const void* h,
                               const void* labels, const void* g,
                               const void* lse, void* dw, int n_tok, int dim,
                               int vocab, int dtype, void* stream) {
  if (n_tok < 1 || dim < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dw(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  else if (dtype == kMmtBF16)
    launch_dw_wgmma(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
