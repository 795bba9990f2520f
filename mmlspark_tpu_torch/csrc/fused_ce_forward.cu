// Fused softmax cross-entropy, forward: per token t,
//   ce[t] = lse_v(h[t] @ W[:, v]) - sum_{v == label[t]} (h[t] @ W[:, v]).
//
// Replaces the TPU kernel mmlspark_tpu/ops/fused_ce.py fused_softmax_xent
// (forward: _fwd_call, kernel body _ce_fwd_kernel).
//
// What bounds it on the H100. At the speculative verify's shape (T = 24
// tokens, D = 512, V = 32768, f32) it must read W once, 4 * D * V = 67.1 MB:
// 0.020 ms at 3.35 TB/s; its 2 * T * D * V = 0.81 GFLOP take 0.012 ms at
// the CUDA cores' f32 rate, 0.005 ms in 3xTF32 (three tf32 products) at
// the TF32 tensor-core rate. So bytes. At the train
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
// * f32 runs on the tensor cores in 3xTF32 (mma.sync m16n8k8 through
//   tf32_mma.cuh: each f32 operand split by truncation into a tf32 big
//   and small part, split_trunc, three products summed, the small ones
//   first), in one of two kernels chosen by T:
//   - few tokens (T <= 64 while all of h fits in shared memory: the
//     speculative verify, T 24): bound by W's bytes, which must stream
//     from device memory once (ce_fwd_stream_tf32<NT>, NT = ceil(T / 8)
//     token tiles). The grid is sized to the card: the vocab slices go in
//     contiguous runs to every block the SMs hold at once (2 an SM at
//     T 24, D 512: 256 blocks of one slice at V 32768). All of h (f32,
//     rows padded to 8 tokens; 48 KB at T 24, D 512), copied in by
//     cp.async, sits in shared memory for the block's whole run, and W's
//     (32, 128) chunks of the run stream through a 3-stage ring, one bulk
//     async copy a row (cp.async.bulk onto the stage's mbarrier, issued by
//     warp 0 as soon as a stage is free; rows padded to 136 floats, so the
//     fragment reads are free of bank conflicts). Little's law: 3.35 TB/s
//     x about 1 us of latency is 3.4 MB in flight over 132 SMs, 25 KB an
//     SM; two blocks an SM keep up to 2 x 3 x 16 KB = 96 KB of W
//     requested. Vocab columns are the product's M (warp w owns the
//     slice's columns 16 w .. 16 w + 15) and tokens its N, so T 24 fills
//     three n8 tiles exactly; W's A fragment is split once a k-step and
//     reused over the token tiles, h's B fragments are split as they are
//     read. Per slice, a warp reduces its 16 columns to (m, s, gold) per
//     token by shuffles, and the 8 warps' states merge in warp order
//     through shared memory. Rows of W that are not 16-byte aligned
//     (V % 4 != 0) stage through element loads into the same ring. Under
//     the cold-L2 timing protocol the kernel streams W as fast as a plain
//     read of it goes (chip_smoke.py's k4_probe).
//   - many tokens (the f32 training variant, and any T past the few-token
//     rule): bound by operations (ce_fwd_tf32). Block (token tile, slice)
//     owns 128 tokens x 128 columns, 4 warps of 64 x 64 (128 accumulator
//     registers a thread, 230 in all); h's (128, 32) and W's (32, 128)
//     chunks come through a 3-stage cp.async ring, one barrier a chunk
//     (16-byte copies where rows are 16-byte aligned, 4-byte ones
//     elsewhere; zeros outside the matrices), h's A fragments by
//     ldmatrix. Two blocks share an SM (105 KB of shared memory each).
//     The epilogue stages the f32 tile in the free ring; a warp then takes
//     32 rows, stores each row's 512 bytes (training) and reduces it to
//     (m, s, gold). Block order: the token tile varies fastest, so the
//     blocks in flight share one W slice, as in bf16.
//   Both write the same per-slice partials. The merge is a programmatic
//   dependent launch behind them (its launch overlaps their tail), as K1's
//   is. Every sum runs in a fixed order: two launches give the same bits.
//
// Neither route falls back to PyTorch. Both use 128-column slices, so the
// partials buffer is sized the same for either dtype.

#include "common.cuh"
#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kCols = 128;  // vocab slice: one set of partials a token
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// One warp per token: merge its n_slices partial states (and write lse
// when it is asked for).
__global__ void __launch_bounds__(kThreads) ce_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ part_g, float* __restrict__ out,
    float* __restrict__ lse, int n_tok, int n_slices) {
  hopper::grid_dependency_wait();  // the partials kernel has completed
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

// ---------------------------------------------------------------------------
// f32 on the tensor cores in 3xTF32

// the few-token kernel (the verify): h whole in shared memory, W streamed
constexpr int kSTok = 64;               // T at most
constexpr int kSDepth = 32;             // W rows a stage: one lane copies one
constexpr int kSStages = 3;
constexpr int kSLd = kCols + 8;         // 136: A reads hit banks 8 t + g
constexpr int kSStage = kSDepth * kSLd;  // floats a stage
constexpr int kSBars = 64;              // bytes before the ring: mbarriers
constexpr int kMaxSmem = 232448;        // an H100 block's shared memory
static_assert(kSDepth == 32, "warp 0 issues one row's copy a lane");
static_assert(kCols == 16 * kWarps, "warp w owns 16 columns of a slice");

// h's row stride: D padded to whole k8 steps, plus 4 (B reads hit banks
// 4 g + t for any such stride: 8 k + 4 times g is 4 g (2 k + 1) mod 32)
__host__ __device__ inline int stream_h_ld(int dim) {
  return (dim + 7) / 8 * 8 + 4;
}
// the ring, h, and each warp's (m, s, gold) per token
inline int stream_smem(int n_tok, int dim) {
  return kSBars + (int)sizeof(float) *
                      (kSStages * kSStage +
                       (n_tok + 7) / 8 * 8 * stream_h_ld(dim) +
                       3 * kWarps * kSTok);
}

// Block b: vocab slices [b per_block, (b + 1) per_block) cut at n_slices,
// all of D each, streamed as (32, 128) chunks of W; NT = ceil(T / 8) token
// tiles. `bulk`: V % 4 == 0 and W 16-byte aligned, so each chunk row is
// one bulk copy; else every thread stages the chunk by element loads.
// `h_vec`: D % 4 == 0 and h 16-byte aligned (h's 16-byte copies).
template <int NT>
__global__ void __launch_bounds__(kThreads, 2) ce_fwd_stream_tf32(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_g, int n_tok,
    int dim, int vocab, int n_slices, int per_block, int bulk, int h_vec) {
  hp::launch_dependents();  // the merge may launch; it waits for this grid
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + kSBars);
  const int h_ld = stream_h_ld(dim);
  float* hs = ring + kSStages * kSStage;   // [8 NT][h_ld]
  float* red = hs + NT * 8 * h_ld;         // [3][kWarps][kSTok]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * per_block;
  const int n_dc = (dim + kSDepth - 1) / kSDepth;
  const int n_chunks = (min(n_slices, s0 + per_block) - s0) * n_dc;
  if (tid == 0) {
    for (int st = 0; st < kSStages; ++st) hp::mbar_init(bars + st);
    hp::mbar_init_fence();
  }
  __syncthreads();
  // chunk c: W rows d0 .. d0 + rows - 1 of the run's slice c / n_dc, its
  // cols columns; warp 0, a row a lane
  auto issue = [&](int c) {
    const int c0 = (s0 + c / n_dc) * kCols, d0 = (c % n_dc) * kSDepth;
    const int rows = min(kSDepth, dim - d0), cols = min(kCols, vocab - c0);
    const int st = c % kSStages;
    if (lane == 0) hp::mbar_expect(bars + st, (uint32_t)(rows * cols * 4));
    __syncwarp();
    if (lane < rows)
      hp::bulk_load(ring + st * kSStage + lane * kSLd,
                    w + (size_t)(d0 + lane) * vocab + c0,
                    (uint32_t)(cols * 4), bars + st);
  };
  if (bulk && warp == 0)
    for (int c = 0; c < kSStages && c < n_chunks; ++c) issue(c);
  // h by cp.async while the first chunks are in flight: rows past T and
  // columns past D (to the row's last k8 step) are zeros
  const int q_row = h_vec ? dim / 4 : dim;  // copies a row
  for (int i = tid; i < NT * 8 * q_row; i += kThreads) {
    const int r = i / q_row, q = (i - r * q_row) * (h_vec ? 4 : 1);
    const bool ok = r < n_tok;
    const float* src = ok ? h + (size_t)r * dim + q : h;
    if (h_vec)
      hp::cp_async16(hs + r * h_ld + q, src, ok ? 16 : 0);
    else
      hp::cp_async4(hs + r * h_ld + q, src, ok ? 4 : 0);
  }
  hp::cp_commit();
  const int pad = h_ld - 4 - dim;
  for (int i = tid; i < NT * 8 * pad; i += kThreads)
    hs[(i / pad) * h_ld + dim + i % pad] = 0.f;
  hp::cp_wait_all();
  __syncthreads();

  const int m0 = 16 * warp;  // the warp's columns of the slice
  float acc[NT][4];
  for (int c = 0, sl = s0; c < n_chunks; ++sl) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc, ++c) {
      const int st = c % kSStages, d0 = dc * kSDepth;
      const int rows = min(kSDepth, dim - d0);
      float* ws = ring + st * kSStage;
      if (bulk) {
        hp::mbar_wait(bars + st, (c / kSStages) & 1);
      } else {
        const int c0 = sl * kCols, cols = min(kCols, vocab - c0);
        for (int i = tid; i < rows * kCols; i += kThreads) {
          const int r = i / kCols, j = i % kCols;
          ws[r * kSLd + j] =
              j < cols ? w[(size_t)(d0 + r) * vocab + c0 + j] : 0.f;
        }
        __syncthreads();
      }
      for (int kr = 0; kr < rows; kr += 8) {
        // A: (column, channel) of W's chunk read transposed; the chunk's
        // rows past D (stale in the ring) read as zeros
        float a[4];
        tf32::load_a(ws + kr * kSLd + m0, 1, kSLd, a);
        if (kr + t >= rows) a[0] = a[1] = 0.f;
        if (kr + t + 4 >= rows) a[2] = a[3] = 0.f;
        uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
        tf32::split_trunc(a, ab, as);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float b[2];
          tf32::load_b(hs + nt * 8 * h_ld + d0 + kr, 1, h_ld, b);
          tf32::split_trunc(b, bb[nt], bs[nt]);
        }
        tf32::mma3_row(acc, ab, as, bb, bs);
      }
      __syncthreads();  // every warp is done with stage st
      if (bulk && warp == 0 && c + kSStages < n_chunks) issue(c + kSStages);
    }

    // slice sl's partials. Thread (g, t) holds columns m0 + g and m0 + g + 8
    // of tokens 8 nt + 2 t + j (elements j and 2 + j of tile nt); the 8
    // lanes of a t share a token.
    const int v0 = sl * kCols + m0 + g, v1 = v0 + 8;
    const bool ok0 = v0 < vocab, ok1 = v1 < vocab;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tok = 8 * nt + 2 * t + j;
        const int label = tok < n_tok ? labels[tok] : -1;
        const float x0 = acc[nt][j], x1 = acc[nt][2 + j];
        float m = fmaxf(ok0 ? x0 : MMT_NEG_INF, ok1 ? x1 : MMT_NEG_INF);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          m = fmaxf(m, __shfl_xor_sync(MMT_FULL_MASK, m, o));
        float s = (ok0 ? expf(x0 - m) : 0.f) + (ok1 ? expf(x1 - m) : 0.f);
        float gd = (ok0 && v0 == label ? x0 : 0.f) +
                   (ok1 && v1 == label ? x1 : 0.f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s += __shfl_xor_sync(MMT_FULL_MASK, s, o);
          gd += __shfl_xor_sync(MMT_FULL_MASK, gd, o);
        }
        if (g == 0 && tok < n_tok) {
          red[warp * kSTok + tok] = m;
          red[(kWarps + warp) * kSTok + tok] = s;
          red[(2 * kWarps + warp) * kSTok + tok] = gd;
        }
      }
    }
    __syncthreads();
    if (tid < n_tok) {  // the 8 warps' states, in warp order
      float m = MMT_NEG_INF;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) m = fmaxf(m, red[k * kSTok + tid]);
      float s = 0.f, gd = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        s += red[(kWarps + k) * kSTok + tid] *
             expf(red[k * kSTok + tid] - m);
        gd += red[(2 * kWarps + k) * kSTok + tid];
      }
      const size_t at = (size_t)sl * n_tok + tid;
      part_m[at] = m;
      part_s[at] = s;
      part_g[at] = gd;
    }
    // red is written again only after the next slice's chunk barriers
  }
}

// the many-token kernel: (128 tokens, 128 columns) a block
constexpr int kFTok = 128;                 // tokens a block
constexpr int kFDepth = 32;                // channels a stage
constexpr int kFStages = 3;
constexpr int kFWN = 8;                    // n8 tiles a warp: 64 columns
constexpr int kFWarpsN = kCols / (8 * kFWN);
constexpr int kFThreads = 2 * kFWarpsN * 32;  // 2 warps along the tokens
constexpr int kFHLd = kFDepth + 4;         // 36: ldmatrix rows, 32 banks
constexpr int kFWLd = kCols + 8;           // 136: B reads hit 8 t + g
constexpr int kFStage = kFTok * kFHLd + kFDepth * kFWLd;  // floats
constexpr int kFSmem = kFStages * kFStage * (int)sizeof(float);
// the epilogue's f32 tile in the free ring (136: the quads' float2 stores
// of a half-warp hit 32 distinct banks)
constexpr int kFOutLd = kCols + 8;
static_assert(kFTok * kFOutLd <= kFStages * kFStage, "fits the ring");

// Chunk d0 of h's rows t0 .. t0 + 127 and W's columns c0 .. c0 + 127 into
// stage s (h's tile, then W's), zeros outside the matrices: 16-byte copies
// where a matrix's rows are 16-byte aligned (h_vec, w_vec), else 4-byte
// ones. Left in flight for the caller's commit.
__device__ __forceinline__ void fwd_stage(float* s, const float* h,
                                          const float* w, int t0, int c0,
                                          int d0, int n_tok, int dim,
                                          int vocab, bool h_vec,
                                          bool w_vec) {
  float* hs = s;
  float* ws = s + kFTok * kFHLd;
  const int tid = threadIdx.x;
  if (h_vec) {
#pragma unroll
    for (int i = 0; i < kFTok * kFDepth / 4 / kFThreads; ++i) {
      const int idx = tid + i * kFThreads, r = idx >> 3, q = 4 * (idx & 7);
      const bool ok = t0 + r < n_tok && d0 + q < dim;
      hp::cp_async16(hs + r * kFHLd + q,
                     ok ? h + (size_t)(t0 + r) * dim + d0 + q : h,
                     ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kFTok * kFDepth; idx += kFThreads) {
      const int r = idx / kFDepth, q = idx % kFDepth;
      const bool ok = t0 + r < n_tok && d0 + q < dim;
      hp::cp_async4(hs + r * kFHLd + q,
                    ok ? h + (size_t)(t0 + r) * dim + d0 + q : h,
                    ok ? 4 : 0);
    }
  }
  if (w_vec) {
#pragma unroll
    for (int i = 0; i < kFDepth * kCols / 4 / kFThreads; ++i) {
      const int idx = tid + i * kFThreads, r = idx >> 5, q = 4 * (idx & 31);
      const bool ok = d0 + r < dim && c0 + q < vocab;
      hp::cp_async16(ws + r * kFWLd + q,
                     ok ? w + (size_t)(d0 + r) * vocab + c0 + q : w,
                     ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kFDepth * kCols; idx += kFThreads) {
      const int r = idx / kCols, q = idx % kCols;
      const bool ok = d0 + r < dim && c0 + q < vocab;
      hp::cp_async4(ws + r * kFWLd + q,
                    ok ? w + (size_t)(d0 + r) * vocab + c0 + q : w,
                    ok ? 4 : 0);
    }
  }
}

// Block b: token tile b % n_tiles (128 tokens), vocab slice b / n_tiles.
// Warp (wm, wn) = (warp % 2, warp / 2) owns tokens 64 wm .. 64 wm + 63 and
// columns 8 kFWN wn .. 8 kFWN (wn + 1) - 1: 4 x kFWN m16n8 tiles.
// `row_store`: V % 4 == 0 and logits 16-byte aligned, so each lane stores
// its 4 columns at once.
template <bool kStore>
__global__ void __launch_bounds__(kFThreads, 2) ce_fwd_tf32(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_g,
    float* __restrict__ logits, int n_tok, int dim, int vocab, int h_vec,
    int w_vec, int row_store) {
  extern __shared__ __align__(16) float fsmem[];
  const int n_tiles = (n_tok + kFTok - 1) / kFTok;
  const int t0 = (blockIdx.x % n_tiles) * kFTok;
  const int slice = blockIdx.x / n_tiles, c0 = slice * kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int n_chunks = (dim + kFDepth - 1) / kFDepth;
  auto stage = [&](int kc) {
    fwd_stage(fsmem + (kc % kFStages) * kFStage, h, w, t0, c0, kc * kFDepth,
              n_tok, dim, vocab, h_vec, w_vec);
  };
  float acc[4][kFWN][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kFWN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int kc = 0; kc < kFStages - 1; ++kc) {
    if (kc < n_chunks) stage(kc);
    hp::cp_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    // chunk kc has landed; every warp is done with chunk kc - 1, whose
    // stage takes chunk kc + kFStages - 1
    hp::cp_wait<kFStages - 2>();
    __syncthreads();
    if (kc + kFStages - 1 < n_chunks) stage(kc + kFStages - 1);
    hp::cp_commit();
    const float* hs = fsmem + (kc % kFStages) * kFStage;
    const float* ws = hs + kFTok * kFHLd;
#pragma unroll
    for (int kr = 0; kr < kFDepth; kr += 8) {
      uint32_t bb[kFWN][2], bs[kFWN][2];
#pragma unroll
      for (int nt = 0; nt < kFWN; ++nt) {
        float b[2];
        tf32::load_b(ws + kr * kFWLd + 8 * (kFWN * wn + nt), kFWLd, 1, b);
        tf32::split_trunc(b, bb[nt], bs[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t ab[4], as[4];
        tf32::ldsm_a(hs + (64 * wm + 16 * mt) * kFHLd + kr, kFHLd, ab);
        const float a[4] = {__uint_as_float(ab[0]), __uint_as_float(ab[1]),
                            __uint_as_float(ab[2]), __uint_as_float(ab[3])};
        tf32::split_trunc(a, ab, as);
        tf32::mma3_row(acc[mt], ab, as, bb, bs);
      }
    }
  }
  hp::cp_wait_all();
  __syncthreads();  // the ring is free

  // the tile in shared memory, then 16 rows a warp, 4 columns a lane
  float* tile = fsmem;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kFWN; ++nt) {
      float* p = tile + (64 * wm + 16 * mt + g) * kFOutLd +
                 8 * (kFWN * wn + nt) + 2 * t;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * kFOutLd) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const int col = c0 + 4 * lane;
  constexpr int kRowsWarp = kFTok / (kFThreads / 32);
  for (int i = 0; i < kRowsWarp; ++i) {
    const int r = kRowsWarp * warp + i, tok = t0 + r;
    if (tok >= n_tok) break;  // whole warps leave together
    const float4 x4 =
        *reinterpret_cast<const float4*>(tile + r * kFOutLd + 4 * lane);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    if (kStore) {
      float* dst = logits + (size_t)tok * vocab + col;
      if (row_store) {
        if (col < vocab) *reinterpret_cast<float4*>(dst) = x4;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < vocab) dst[k] = x[k];
      }
    }
    const int label = labels[tok];
    float m = MMT_NEG_INF;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < vocab) m = fmaxf(m, x[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(MMT_FULL_MASK, m, o));
    float s = 0.f, gd = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < vocab) {
        s += expf(x[k] - m);
        if (col + k == label) gd += x[k];
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(MMT_FULL_MASK, s, o);
      gd += __shfl_xor_sync(MMT_FULL_MASK, gd, o);
    }
    if (lane == 0) {
      const size_t at = (size_t)slice * n_tok + tok;
      part_m[at] = m;
      part_s[at] = s;
      part_g[at] = gd;
    }
  }
}

// The few-token kernel over NT token tiles: the slices in contiguous runs
// over every block the SMs hold at once.
template <int NT>
int launch_stream(const void* h, const void* w, const void* labels,
                  float* pm, size_t plane, int n_tok, int dim, int vocab,
                  int n_slices, cudaStream_t st) {
  static bool raised = false;
  const cudaError_t rc =
      allow_smem(ce_fwd_stream_tf32<NT>, kMaxSmem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const int smem = stream_smem(n_tok, dim);
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ce_fwd_stream_tf32<NT>, kThreads, smem);
  const int slots = n_sm * (per_sm > 0 ? per_sm : 1);
  const int per = (n_slices + slots - 1) / slots;
  const int bulk = vocab % 4 == 0 && aligned16(w);
  const int h_vec = dim % 4 == 0 && aligned16(h);
  ce_fwd_stream_tf32<NT><<<(n_slices + per - 1) / per, kThreads, smem,
                           st>>>(
      (const float*)h, (const float*)w, (const int*)labels, pm, pm + plane,
      pm + 2 * plane, n_tok, dim, vocab, n_slices, per, bulk, h_vec);
  return (int)cudaGetLastError();
}

// f32: the few-token kernel for the forward that stores nothing (the
// verify) where T <= kSTok and h fits beside the ring, else the many-token
// one. Returns the launch's error.
template <bool kStore>
int launch_f32(const void* h, const void* w, const void* labels, float* pm,
               size_t plane, void* logits, int n_tok, int dim, int vocab,
               int n_slices, cudaStream_t st) {
  if (!kStore && n_tok <= kSTok && stream_smem(n_tok, dim) <= kMaxSmem) {
    switch ((n_tok + 7) / 8) {
      case 1: return launch_stream<1>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 2: return launch_stream<2>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 3: return launch_stream<3>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 4: return launch_stream<4>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 5: return launch_stream<5>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 6: return launch_stream<6>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      case 7: return launch_stream<7>(h, w, labels, pm, plane, n_tok, dim,
                                      vocab, n_slices, st);
      default: return launch_stream<8>(h, w, labels, pm, plane, n_tok, dim,
                                       vocab, n_slices, st);
    }
  }
  static bool raised = false;
  const cudaError_t rc = allow_smem(ce_fwd_tf32<kStore>, kFSmem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const int h_vec = dim % 4 == 0 && aligned16(h);
  const int w_vec = vocab % 4 == 0 && aligned16(w);
  const int row_store = vocab % 4 == 0 && aligned16(logits);
  const int n_tiles = (n_tok + kFTok - 1) / kFTok;
  ce_fwd_tf32<kStore><<<n_tiles * n_slices, kFThreads, kFSmem, st>>>(
      (const float*)h, (const float*)w, (const int*)labels, pm, pm + plane,
      pm + 2 * plane, (float*)logits, n_tok, dim, vocab, h_vec, w_vec,
      row_store);
  return (int)cudaGetLastError();
}

// The merge behind the partials kernel as a programmatic dependent launch:
// its grid may start while the partials kernel runs and waits in
// grid_dependency_wait for its partials.
int launch_merge(float* pm, size_t plane, float* out, float* lse, int n_tok,
                 int n_slices, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tok + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, ce_merge_kernel, (const float*)pm, (const float*)(pm + plane),
      (const float*)(pm + 2 * plane), out, lse, n_tok, n_slices);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// h (T, D) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; partials 3 * n_slices * T f32 of scratch with n_slices =
// ceil(V / 128) (checked); out (T,) f32. logits (T, V) in `dtype` and lse
// (T,) f32 are written when both are non-null (training), else neither. All
// contiguous and on the device; T, D, V >= 1. Two launches on `stream`:
// the partials (bf16 on wgmma, f32 in 3xTF32 on mma.sync) and the merge.
// Returns cudaGetLastError().
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
  int rc;
  if (dtype == kMmtF32 && store) {
    rc = launch_f32<true>(h, w, labels, pm, plane, logits, n_tok, dim,
                          vocab, n_slices, st);
  } else if (dtype == kMmtF32) {
    rc = launch_f32<false>(h, w, labels, pm, plane, logits, n_tok, dim,
                           vocab, n_slices, st);
  } else if (dtype == kMmtBF16) {
    if (store)
      launch_wgmma<true>(h, w, labels, pm, plane, logits, n_tok, dim, vocab,
                         n_slices, st);
    else
      launch_wgmma<false>(h, w, labels, pm, plane, logits, n_tok, dim,
                          vocab, n_slices, st);
    rc = (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return launch_merge(pm, plane, (float*)out, (float*)lse, n_tok, n_slices,
                      st);
}
