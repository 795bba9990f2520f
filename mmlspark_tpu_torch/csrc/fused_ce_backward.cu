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
// * f32 runs on the tensor cores in 3xTF32 (ce_dh_tf32, ce_dw_tf32;
//   mma.sync m16n8k8 through tf32_mma.cuh: each f32 operand split by
//   truncation into a tf32 big and small part, split_trunc, three
//   products summed, the small ones first). At the f32 parity step's
//   shape (T 2048, D 512, V 32768) each product is 68.7 GFLOP: 1.03 ms at
//   the CUDA cores' f32 rate, 0.42 ms for its three tf32 products at the
//   TF32 tensor-core rate (wgmma's; mma.sync runs slower, chip_smoke.py's
//   mma_tf32_peak). The reduction streams through a cp.async ring in
//   32-deep chunks (16-byte copies where rows are 16-byte aligned, 4-byte
//   ones elsewhere; zeros outside the matrices). d_l is rebuilt tile by
//   tile in shared memory: each thread copies 8 or 16 elements of one row
//   of a chunk's logits tile and, once its own copies have landed,
//   rewrites them in place as d_l's big parts (16-byte accesses, exp2 on
//   the special-function unit) and writes the small parts beside them
//   (two buffers, a chunk each), so each element is split once a block
//   and read by every warp that needs it; the other operand's fragments
//   are split as they are read. One barrier a chunk: a warp builds chunk
//   k + 1's d_l right after its products of chunk k, while other warps
//   still run theirs, and the barrier publishes that d_l with the other
//   operand's tile and frees chunk k's stage.
//   - dh: a block owns 64 tokens x 128 channels and loops over all of V
//     in two warp groups of 8 warps (32 x 32 each) that take alternate
//     chunks, each through its own 3-stage ring of the logits' (64, 32)
//     and W's (128, 32) tiles (both with V contiguous, rows padded to 36
//     floats: conflict-free fragment reads; d_l's A fragments by
//     ldmatrix), with named barriers; at the end the second group's sums
//     add into the first's in that order. The grid at T 2048 is 32 token
//     tiles x 4 channel slices = 128 blocks, one an SM (204 KB of shared
//     memory), so the groups give each SM 16 warps with no second pass
//     and no atomics; the 4 slices of a token tile run side by side, so
//     the logits' re-reads hit L2.
//   - dW: a block owns 128 channels x 128 columns (8 warps of 64 x 32) and
//     loops over all of T through a 2-stage ring of h's and the logits'
//     (32, 128) tiles (rows padded to 136 floats); each thread reads its
//     row's lse, g and label for the next chunk while the products run.
//     1024 blocks at V 32768, two an SM (104 KB of shared memory each).
//   Each output element's sum stays in one block, in a fixed order: two
//   launches give the same bits. The tensor core rounds its f32 sums
//   within each product, so the error grows with the reduction's length
//   (V for dh, T for dW), far inside the f32 limits at the path's shapes.
//
// Neither route falls back to PyTorch.

#include "common.cuh"
#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// f32 on the tensor cores in 3xTF32

constexpr int kBDepth = 32;  // reduction a stage: V for dh, T for dW
// dh: (64 tokens, 128 channels) a block, in two warp groups that take
// alternate 32-column chunks of V, each through its own ring; a stage
// holds the logits' (64, 32) tile and W's (128, 32), both with V
// contiguous
constexpr int kDhTok = 64;
constexpr int kDhCh = 128;
constexpr int kDhStages = 3;
constexpr int kDhGroups = 2;
constexpr int kDhGroupThreads = 2 * kDhCh;  // 2 warps along T x 4 along D
constexpr int kDhThreads = kDhGroups * kDhGroupThreads;
constexpr int kDhLd = kBDepth + 4;  // 36: A (ldmatrix) and B conflict-free
constexpr int kDhStage = (kDhTok + kDhCh) * kDhLd;  // floats
// a group's ring and d_l's small parts of two chunks
constexpr int kDhGroupFloats = kDhStages * kDhStage + 2 * kDhTok * kDhLd;
// the groups' floats, and the rows' lse (times log2 e), g and label
constexpr int kDhF32Smem =
    (kDhGroups * kDhGroupFloats + 3 * kDhTok) * (int)sizeof(float);
static_assert(32 * kDhGroupThreads <= kDhGroupFloats, "the accumulators "
              "of a group fit its ring");
// dW: (128 channels, 128 columns) a block; a stage holds h's (32, 128)
// tile and the logits' (32, 128)
constexpr int kDwCh = 128;
constexpr int kDwVoc = 128;
constexpr int kDwStages = 2;
constexpr int kDwLd = 128 + 8;  // 136: A and B reads hit banks 8 t + g
constexpr int kDwStage = 2 * kBDepth * kDwLd;  // floats
// the ring and d_l's small parts of two chunks
constexpr int kDwF32Smem =
    (kDwStages * kDwStage + 2 * kBDepth * kDwLd) * (int)sizeof(float);
constexpr int kDwWN = 4;  // n8 tiles a warp: 32 columns
constexpr int kDwWarpsN = kDwVoc / (8 * kDwWN);
constexpr int kDwThreads = 2 * kDwWarpsN * 32;  // 2 warps along D
static_assert(kDwThreads == 8 * kBDepth, "8 threads build a chunk row");
static_assert(kDhStage % 4 == 0 && kDwStage % 4 == 0, "16-byte stages");

// One f32 d_l element of the 3xTF32 kernels, from lse2 = lse log2 e:
// exp2 on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float d_logit2(float logit, float lse2, float g,
                                          int label, int col) {
  const float p = hp::exp2_approx(fmaf(logit, hp::kLog2e, -lse2));
  return (p - (col == label ? 1.f : 0.f)) * g;
}

// Four consecutive staged logits of one row (columns v .. v + 3, at p,
// 16-byte aligned) rewritten in place as d_l's big parts, the small parts
// at q; columns at or past V give 0.
__device__ __forceinline__ void d_logits4(float* p, uint32_t* q, int v,
                                          int vocab, float lse2, float g,
                                          int label) {
  const float4 x4 = *reinterpret_cast<const float4*>(p);
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  uint32_t b[4], s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tf32::split_trunc(
        v + k < vocab ? d_logit2(x[k], lse2, g, label, v + k) : 0.f, b[k],
        s[k]);
  *reinterpret_cast<uint4*>(p) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(q) = make_uint4(s[0], s[1], s[2], s[3]);
}

// Rows r0 .. r0 + rows - 1 (cut at r_end) and columns c0 .. c0 + cols - 1
// (cut at c_end) of a row-major f32 matrix (row j at x + j * ld) into a
// shared tile of row stride sld, zeros outside the matrix: 16-byte copies
// where rows are 16-byte aligned (`vec`; cols a multiple of 4), else
// 4-byte ones, by kThreadsT threads (this one `tid`). Left in flight for
// the caller's commit.
template <int kThreadsT, int kRowsT, int kColsT>
__device__ __forceinline__ void stage_f32(float* s, int sld,
                                          const float* __restrict__ x,
                                          size_t ld, int r0, int r_end,
                                          int c0, int c_end, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int kQ = kColsT / 4;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < kRowsT * kQ / kThreadsT; ++i) {
      const int idx = tid + i * kThreadsT, r = idx / kQ,
                q = 4 * (idx % kQ);
      const bool ok = r0 + r < r_end && c0 + q < c_end;
      hp::cp_async16(s + r * sld + q,
                     ok ? x + (size_t)(r0 + r) * ld + c0 + q : x,
                     ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kRowsT * kColsT; idx += kThreadsT) {
      const int r = idx / kColsT, q = idx % kColsT;
      const bool ok = r0 + r < r_end && c0 + q < c_end;
      hp::cp_async4(s + r * sld + q,
                    ok ? x + (size_t)(r0 + r) * ld + c0 + q : x,
                    ok ? 4 : 0);
    }
  }
}

// A named barrier over one of dh's warp groups (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(kDhGroupThreads)
               : "memory");
}

// dh: block b owns channel slice b % n_slices (128 channels) of token tile
// b / n_slices (64 tokens). Its two warp groups take alternate 32-column
// chunks of V (group k chunks k, k + 2, ...), each through its own 3-stage
// cp.async ring, and their sums add in group order at the end: 16 warps
// an SM where the grid has one block an SM (128 blocks at T 2048), with
// no second pass. Each chunk's logits tile is rewritten in place as d_l's
// big parts, its small parts beside it (every d_l element split once a
// block, then read by the 4 warps of the group that share its rows), by
// the threads that copied it, while the group's products of the chunk
// before run; W's B fragments are split as they are read. Warp (wm, wn)
// = (w % 2, w / 2) of a group owns tokens 32 wm .. 32 wm + 31 and
// channels 32 wn .. 32 wn + 31: 2 x 4 m16n8 tiles. `vec`: V % 4 == 0 and
// logits, W 16-byte aligned; `vec_store`: D even and dh 8-byte aligned.
__global__ void __launch_bounds__(kDhThreads, 1) ce_dh_tf32(
    const float* __restrict__ logits, const float* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dh, int n_tok,
    int dim, int vocab, int vec, int vec_store) {
  extern __shared__ __align__(16) float dsmem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / kDhGroupThreads, gtid = tid % kDhGroupThreads;
  const int gw = warp % (kDhGroupThreads / 32), wm = gw & 1, wn = gw >> 1;
  float* ring = dsmem + grp * kDhGroupFloats;
  uint32_t* small = reinterpret_cast<uint32_t*>(ring + kDhStages * kDhStage);
  float* row_lse = dsmem + kDhGroups * kDhGroupFloats;
  float* row_g = row_lse + kDhTok;
  int* row_lbl = reinterpret_cast<int*>(row_g + kDhTok);
  const int n_slices = (dim + kDhCh - 1) / kDhCh;
  const int d0 = (blockIdx.x % n_slices) * kDhCh;
  const int t0 = (blockIdx.x / n_slices) * kDhTok;
  const int n_chunks = (vocab + kBDepth - 1) / kBDepth;
  const int n_mine = (n_chunks - grp + kDhGroups - 1) / kDhGroups;
  if (tid < kDhTok) {
    const bool ok = t0 + tid < n_tok;
    row_lse[tid] = ok ? lse[t0 + tid] * hp::kLog2e : 0.f;
    row_g[tid] = ok ? g[t0 + tid] : 0.f;
    row_lbl[tid] = ok ? labels[t0 + tid] : -1;
  }
  __syncthreads();
  // the d_l a thread builds: row gtid / 4, columns 8 (gtid % 4) .. + 7 of
  // each chunk (a quarter-warp's 16-byte accesses hit 32 banks)
  static_assert(kDhTok * kBDepth == 8 * kDhGroupThreads, "8 columns each");
  const int my_row = gtid >> 2, my_col = 8 * (gtid & 3);
  const float my_lse2 = row_lse[my_row], my_g = row_g[my_row];
  const int my_lbl = row_lbl[my_row];
  // the group's j-th chunk: V columns (j kDhGroups + grp) 32 .. Each
  // thread copies the part of the logits tile it later rewrites as d_l,
  // so its own cp.async wait makes that part visible to it; W's tile is
  // published by the group's barrier.
  auto stage = [&](int j) {
    float* s = ring + (j % kDhStages) * kDhStage;
    const int v0 = (j * kDhGroups + grp) * kBDepth;
    const int t = t0 + my_row;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = v0 + my_col + 4 * k;
      float* dst = s + my_row * kDhLd + my_col + 4 * k;
      const float* src = logits + (size_t)t * vocab + v;
      if (vec) {
        const bool ok = t < n_tok && v < vocab;
        hp::cp_async16(dst, ok ? src : logits, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = t < n_tok && v + e < vocab;
          hp::cp_async4(dst + e, ok ? src + e : logits, ok ? 4 : 0);
        }
      }
    }
    stage_f32<kDhGroupThreads, kDhCh, kBDepth>(s + kDhTok * kDhLd, kDhLd, w,
                                               vocab, d0, dim, v0, vocab,
                                               vec, gtid);
  };
  // chunk j's d_l: the thread's row, 8 columns (two 16-byte pieces), big
  // parts in place, small parts in buffer j % 2
  auto build = [&](int j) {
    float* ls = ring + (j % kDhStages) * kDhStage;
    uint32_t* sm = small + (j & 1) * kDhTok * kDhLd;
    const int v0 = (j * kDhGroups + grp) * kBDepth;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int at = my_row * kDhLd + my_col + 4 * k;
      d_logits4(ls + at, sm + at, v0 + my_col + 4 * k, vocab, my_lse2, my_g,
                my_lbl);
    }
  };
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int j = 0; j < kDhStages - 1; ++j) {
    if (j < n_mine) stage(j);
    hp::cp_commit();
  }
  hp::cp_wait<kDhStages - 2>();
  if (n_mine > 0) build(0);
  group_sync(grp);
  // One barrier a chunk: chunk j's products run while other warps of the
  // group build chunk j + 1's d_l; the barrier publishes that d_l and W's
  // tile and frees chunk j's stage and small parts.
  for (int j = 0; j < n_mine; ++j) {
    if (j + kDhStages - 1 < n_mine) stage(j + kDhStages - 1);
    hp::cp_commit();
    const float* ls = ring + (j % kDhStages) * kDhStage;
    const uint32_t* big = reinterpret_cast<const uint32_t*>(ls);
    const uint32_t* sm = small + (j & 1) * kDhTok * kDhLd;
    const float* ws = ls + kDhTok * kDhLd;
#pragma unroll
    for (int kr = 0; kr < kBDepth; kr += 8) {
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int at = (32 * wm + 16 * mt) * kDhLd + kr;
        tf32::ldsm_a(big + at, kDhLd, ab[mt]);
        tf32::ldsm_a(sm + at, kDhLd, as[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b[2];
        tf32::load_b(ws + (32 * wn + 8 * nt) * kDhLd + kr, 1, kDhLd, b);
        tf32::split_trunc(b, bb[nt], bs[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tf32::mma3_row(acc[mt], ab[mt], as[mt], bb, bs);
    }
    if (j + 1 < n_mine) {
      hp::cp_wait<kDhStages - 2>();  // chunk j + 1's copies have landed
      build(j + 1);
    }
    group_sync(grp);
  }
  hp::cp_wait_all();
  // group 1's sums into group 0's, through group 0's ring
  __syncthreads();
  float* xch = dsmem;
  if (grp == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[((mt * 4 + nt) * 4 + e) * kDhGroupThreads + gtid] =
              acc[mt][nt][e];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][nt][e] += xch[((mt * 4 + nt) * 4 + e) * kDhGroupThreads + gtid];
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int t = t0 + 32 * wm + 16 * mt + gq + 8 * h8;
      if (t >= n_tok) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = d0 + 32 * wn + 8 * nt + 2 * tq;
        float* p = dh + (size_t)t * dim + d;
        const float x0 = acc[mt][nt][2 * h8], x1 = acc[mt][nt][2 * h8 + 1];
        if (vec_store && d < dim) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (d < dim) p[0] = x0;
          if (d + 1 < dim) p[1] = x1;
        }
      }
    }
}

// dW: block b owns channel slice b % n_slices (128 channels) of vocab
// slice b / n_slices (128 columns) and loops over all of T in 32-token
// chunks through a 2-stage cp.async ring of h's and the logits' tiles.
// The logits tile becomes d_l's big parts in place, its small parts
// beside it (split once a block; the 2 warps that share its columns read
// them), built by the threads that copied it while the products of the
// chunk before run; h's A fragments (the tile read transposed) are split
// as they are read. Warp
// (wm, wn) = (warp % 2, warp / 2) owns channels 64 wm .. 64 wm + 63 and
// columns 32 wn .. 32 wn + 31: 4 x 4 m16n8 tiles. `h_vec`: D % 4 == 0 and
// h 16-byte aligned; `l_vec` the same of V and logits; `vec_store`: V
// even and dW 8-byte aligned.
__global__ void __launch_bounds__(kDwThreads, 2) ce_dw_tf32(
    const float* __restrict__ logits, const float* __restrict__ h,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dw, int n_tok,
    int dim, int vocab, int h_vec, int l_vec, int vec_store) {
  extern __shared__ __align__(16) float wsmem[];
  float* ring = wsmem;
  uint32_t* small = reinterpret_cast<uint32_t*>(ring + kDwStages * kDwStage);
  const int n_slices = (dim + kDwCh - 1) / kDwCh;
  const int d0 = (blockIdx.x % n_slices) * kDwCh;
  const int c0 = (blockIdx.x / n_slices) * kDwVoc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int n_chunks = (n_tok + kBDepth - 1) / kBDepth;
  // the part of a chunk's logits tile a thread copies and rewrites as
  // d_l: row tid / 8, columns 4 (tid % 8) + 32 k (8 threads cover 128
  // contiguous bytes of a row: 32 banks); its own cp.async wait makes it
  // visible to it, and h's tile is published by the block's barrier
  const int my_row = tid >> 3, my_col = 4 * (tid & 7);
  auto stage = [&](int kc) {
    float* s = ring + (kc % kDwStages) * kDwStage;
    const int tk = kc * kBDepth, t = tk + my_row;
    stage_f32<kDwThreads, kBDepth, kDwCh>(s, kDwLd, h, dim, tk, n_tok, d0,
                                           dim, h_vec, tid);
#pragma unroll
    for (int k = 0; k < kDwVoc / 32; ++k) {
      const int v = c0 + my_col + 32 * k;
      float* dst = s + (kBDepth + my_row) * kDwLd + my_col + 32 * k;
      const float* src = logits + (size_t)t * vocab + v;
      if (l_vec) {
        const bool ok = t < n_tok && v < vocab;
        hp::cp_async16(dst, ok ? src : logits, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = t < n_tok && v + e < vocab;
          hp::cp_async4(dst + e, ok ? src + e : logits, ok ? 4 : 0);
        }
      }
    }
  };
  // the thread's row's lse (times log2 e), g and label in chunk kc (0, 0
  // and -1 past T: g 0 gives d_l 0)
  float lse2 = 0.f, gr = 0.f;
  int lbl = -1;
  auto row_of = [&](int kc) {
    const int t = kc * kBDepth + my_row;
    const bool ok = t < n_tok;
    lse2 = ok ? lse[t] * hp::kLog2e : 0.f;
    gr = ok ? g[t] : 0.f;
    lbl = ok ? labels[t] : -1;
  };
  // chunk kc's d_l: big parts in place, small parts in buffer kc % 2
  auto build = [&](int kc) {
    float* ls = ring + (kc % kDwStages) * kDwStage + kBDepth * kDwLd;
    uint32_t* sm = small + (kc & 1) * kBDepth * kDwLd;
#pragma unroll
    for (int k = 0; k < kDwVoc / 32; ++k) {
      const int c = my_col + 32 * k, at = my_row * kDwLd + c;
      d_logits4(ls + at, sm + at, c0 + c, vocab, lse2, gr, lbl);
    }
  };
  float acc[4][kDwWN][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDwWN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  row_of(0);
  stage(0);
  hp::cp_commit();
  hp::cp_wait<0>();
  build(0);
  __syncthreads();
  // One barrier a chunk: chunk kc's products run while other warps build
  // chunk kc + 1's d_l; the barrier publishes that d_l and h's tile and
  // frees chunk kc's stage and small parts.
  for (int kc = 0; kc < n_chunks; ++kc) {
    const bool next = kc + 1 < n_chunks;
    if (next) {
      stage(kc + 1);
      row_of(kc + 1);
    }
    hp::cp_commit();
    const float* hs = ring + (kc % kDwStages) * kDwStage;
    const uint32_t* big = reinterpret_cast<const uint32_t*>(hs) +
                          kBDepth * kDwLd;
    const uint32_t* sm = small + (kc & 1) * kBDepth * kDwLd;
#pragma unroll 1  // one k-step live at a time: 128 registers
    for (int kr = 0; kr < kBDepth; kr += 8) {
      uint32_t bb[kDwWN][2], bs[kDwWN][2];
#pragma unroll
      for (int nt = 0; nt < kDwWN; ++nt) {
        const int at = kr * kDwLd + 8 * (kDwWN * wn + nt);
        tf32::load_b(big + at, kDwLd, 1, bb[nt]);
        tf32::load_b(sm + at, kDwLd, 1, bs[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float a[4];
        tf32::load_a(hs + kr * kDwLd + 64 * wm + 16 * mt, 1, kDwLd, a);
        uint32_t ab[4], as[4];
        tf32::split_trunc(a, ab, as);
        tf32::mma3_row(acc[mt], ab, as, bb, bs);
      }
    }
    if (next) {
      hp::cp_wait<0>();  // chunk kc + 1's copies have landed
      build(kc + 1);
    }
    __syncthreads();
  }
  hp::cp_wait_all();
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int d = d0 + 64 * wm + 16 * mt + gq + 8 * h8;
      if (d >= dim) continue;
#pragma unroll
      for (int nt = 0; nt < kDwWN; ++nt) {
        const int v = c0 + 8 * (kDwWN * wn + nt) + 2 * tq;
        float* p = dw + (size_t)d * vocab + v;
        const float x0 = acc[mt][nt][2 * h8], x1 = acc[mt][nt][2 * h8 + 1];
        if (vec_store && v < vocab) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (v < vocab) p[0] = x0;
          if (v + 1 < vocab) p[1] = x1;
        }
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_dh(const void* logits, const void* w, const void* labels,
              const void* g, const void* lse, void* dh, int n_tok, int dim,
              int vocab, cudaStream_t st) {
  static bool raised = false;
  const cudaError_t rc = allow_smem(ce_dh_tf32, kDhF32Smem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const int vec = vocab % 4 == 0 && aligned16(logits) && aligned16(w);
  const int vec_store =
      dim % 2 == 0 && reinterpret_cast<uintptr_t>(dh) % 8 == 0;
  const int blocks = ((dim + kDhCh - 1) / kDhCh) *
                     ((n_tok + kDhTok - 1) / kDhTok);
  ce_dh_tf32<<<blocks, kDhThreads, kDhF32Smem, st>>>(
      (const float*)logits, (const float*)w, (const int*)labels,
      (const float*)g, (const float*)lse, (float*)dh, n_tok, dim, vocab, vec,
      vec_store);
  return (int)cudaGetLastError();
}

int launch_dw(const void* logits, const void* h, const void* labels,
              const void* g, const void* lse, void* dw, int n_tok, int dim,
              int vocab, cudaStream_t st) {
  static bool raised = false;
  const cudaError_t rc = allow_smem(ce_dw_tf32, kDwF32Smem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const int h_vec = dim % 4 == 0 && aligned16(h);
  const int l_vec = vocab % 4 == 0 && aligned16(logits);
  const int vec_store =
      vocab % 2 == 0 && reinterpret_cast<uintptr_t>(dw) % 8 == 0;
  const int blocks = ((dim + kDwCh - 1) / kDwCh) *
                     ((vocab + kDwVoc - 1) / kDwVoc);
  ce_dw_tf32<<<blocks, kDwThreads, kDwF32Smem, st>>>(
      (const float*)logits, (const float*)h, (const int*)labels,
      (const float*)g, (const float*)lse, (float*)dw, n_tok, dim, vocab,
      h_vec, l_vec, vec_store);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (T, V) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; g and lse (T,) f32; dh (T, D) in `dtype`. Contiguous, on the
// device; T, D, V >= 1. One launch on `stream`: bf16 on wgmma, f32 in
// 3xTF32 on mma.sync. Returns cudaGetLastError().
extern "C" int mmt_fused_ce_dh(const void* logits, const void* w,
                               const void* labels, const void* g,
                               const void* lse, void* dh, int n_tok, int dim,
                               int vocab, int dtype, void* stream) {
  if (n_tok < 1 || dim < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    return launch_dh(logits, w, labels, g, lse, dh, n_tok, dim, vocab, st);
  if (dtype == kMmtBF16)
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
    return launch_dw(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  if (dtype == kMmtBF16)
    launch_dw_wgmma(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
