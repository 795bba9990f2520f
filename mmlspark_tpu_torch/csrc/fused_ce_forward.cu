// Fused softmax cross-entropy, forward: per token t,
//   ce[t] = lse_v(h[t] @ W[:, v]) - sum_{v == label[t]} (h[t] @ W[:, v]).
//
// Replaces the TPU kernel mmlspark_tpu/ops/fused_ce.py fused_softmax_xent
// (forward: _fwd_call, kernel body _ce_fwd_kernel).
//
// What bounds it on the H100: at the speculative verify's shape (T = 24
// tokens, D = 512, V = 32768, f32) it must read W once, 4 * D * V = 67.1 MB:
// 0.020 ms at 3.35 TB/s. Its 2 * T * D * V = 0.81 GFLOP take 0.012 ms at the
// f32 rate. So bytes, with operations close behind.
// At the train step's shape (T = 8192) the same 2 * T * D * V is 275 GFLOP,
// 4.1 ms at the f32 rate against 0.26 ms of bytes (W, h, and the stored
// bf16 logits): operations.
//
// What the design does about it: the TPU kernel walks the vocab tiles of a
// token tile in order and carries (m, s, gold) in VMEM from one grid step to
// the next. Hopper blocks run in no order, so the vocab is split over blocks
// instead, and one token tile still fills the card: block (j, i) takes vocab
// slice j (kCols columns) and token tile i (kRows tokens) and computes that
// (kRows, kCols) tile of logits as a small SIMT matrix product over D in
// chunks of kDepth. Each chunk of h and W is staged in shared memory (the
// next chunk's loads are in flight in registers while this one is used); a
// warp owns 4 tokens and all kCols columns, each thread a 4 x 4 register
// tile. No logit reaches device memory, and W is read from it once per token
// tile: exactly once at the verify's T <= kRows. The block reduces its tile
// to per-token partials over its slice, (m, s, gold) with m the slice's max,
// s = sum exp(l - m) and gold the sum of the logits whose column equals the
// label (the JAX in-tile iota == label mask; a label that matches no column
// gives 0). These reductions are warp shuffles. A second small launch merges
// the slices per token: m = max m_j, s = sum s_j exp(m_j - m),
// ce = m + log(s) - gold, the merge K1 makes of its warps' softmax states.
//
// The training variant (the train step's loss, 1 launch pair per step) is
// the same kernel with two more outputs, as the JAX kernel has them: the
// (kRows, kCols) logit tile, stored in the input dtype, and from the merge
// lse = m + log(s); the backward (fused_ce_backward.cu) rebuilds
// softmax - onehot from them. Inputs are f32 or bf16 (widened to f32 on
// load; the products accumulate in f32; lse and gold come from the
// unrounded logits). The verify's launches (f32, no stored logits) are the
// kernel as before.
//
// f32 FMAs on the CUDA cores, no TF32: the result matches the plain version
// to the reassociation of the sums. Known gaps, later work: the product runs
// on the CUDA cores (no wgmma), and rows past T in the last token tile are
// computed and dropped (8 of 32 at T = 24).

#include "common.cuh"

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

template <typename T, bool kStore>
__global__ void __launch_bounds__(kThreads) ce_partials_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_g,
    T* __restrict__ logits, int n_tok, int dim, int vocab) {
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
      hreg[i] =
          ok ? mmt_to_float(h[(size_t)(t0 + t) * dim + d0 + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kCols, c = e % kCols;
      const bool ok = d0 + k < dim && c0 + c < vocab;
      wreg[i] = ok ? mmt_to_float(w[(size_t)(d0 + k) * vocab + c0 + c])
                   : 0.f;
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

template <typename T, bool kStore>
void launch_partials(const void* h, const void* w, const void* labels,
                     float* pm, size_t plane, void* logits, int n_tok,
                     int dim, int vocab, int n_slices, cudaStream_t st) {
  const dim3 grid(n_slices, (n_tok + kRows - 1) / kRows);
  ce_partials_kernel<T, kStore><<<grid, kThreads, 0, st>>>(
      (const T*)h, (const T*)w, (const int*)labels, pm, pm + plane,
      pm + 2 * plane, (T*)logits, n_tok, dim, vocab);
}

}  // namespace

// h (T, D) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; partials 3 * n_slices * T f32 of scratch with n_slices =
// ceil(V / 128) (checked); out (T,) f32. logits (T, V) in `dtype` and lse
// (T,) f32 are written when both are non-null (training), else neither. All
// contiguous and on the device; T, D, V >= 1. Two launches on `stream`.
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
  if (dtype == kMmtF32 && store)
    launch_partials<float, true>(h, w, labels, pm, plane, logits, n_tok, dim,
                                 vocab, n_slices, st);
  else if (dtype == kMmtF32)
    launch_partials<float, false>(h, w, labels, pm, plane, logits, n_tok,
                                  dim, vocab, n_slices, st);
  else if (dtype == kMmtBF16 && store)
    launch_partials<__nv_bfloat16, true>(h, w, labels, pm, plane, logits,
                                         n_tok, dim, vocab, n_slices, st);
  else if (dtype == kMmtBF16)
    launch_partials<__nv_bfloat16, false>(h, w, labels, pm, plane, logits,
                                          n_tok, dim, vocab, n_slices, st);
  else
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  ce_merge_kernel<<<(n_tok + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pm, pm + plane, pm + 2 * plane, (float*)out, (float*)lse, n_tok,
      n_slices);
  return (int)cudaGetLastError();
}
