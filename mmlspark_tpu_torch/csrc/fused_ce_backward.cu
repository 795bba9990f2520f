// Fused softmax cross-entropy, backward: from the forward's stored logits
// and lse, with g the per-token cotangent of ce,
//   d_l[t, v] = (exp(logits[t, v] - lse[t]) - [v == label[t]]) * g[t],
//   dh = d_l @ W^T    (T, D)      and      dW = h^T @ d_l    (D, V).
//
// Replaces the TPU kernels of mmlspark_tpu/ops/fused_ce.py _bwd_call (K6):
// _ce_dh_kernel (dh, vocab-innermost grid) and _ce_dw_kernel (dW,
// token-innermost grid). As there, d_l is rebuilt tile by tile from the
// stored logits (in the compute dtype, so bf16 logits give a bf16-rounded
// p by design) and never written; it is rounded to the compute dtype before
// each product, both products accumulate in f32, and dh and dW are written
// in the compute dtype. A label outside [0, V) adds no one-hot.
//
// What bounds it on the H100: operations. At the train step's shape
// (T 8192, D 512, V 32768) each product is 2 * T * D * V = 275 GFLOP
// against one read of the logits (512 MiB in bf16) and W: 4.1 ms at the f32
// rate of the CUDA cores, 0.28 ms at the bf16 tensor-core rate.
//
// What the design does about it: a register-blocked, shared-memory-tiled
// SIMT product with no atomics. Each block owns a 128 x 128 output tile and
// loops over the whole reduction (dh: all V for 128 tokens x 128 channels;
// dW: all T for 128 channels x 128 vocab columns, so a vocab tile's sum over
// every token stays in one block). Per step of 16 along the reduction, the
// block stages a 16 x 128 slice of each operand in shared memory, widened to
// f32 (d_l computed on the way in from the stored logits and the row's lse,
// g and label); the next slice's loads are in flight in registers while
// this one is used. Each of the 256 threads holds an 8 x 8 register tile
// (two 4-wide groups 64 apart in each direction, so a quarter-warp's float4
// reads cover 128 contiguous bytes) and does 64 FMAs per 4 shared-memory
// reads. Rows are padded to 132 floats so the transposed stores of dh's
// operands cost at most 2-way bank conflicts. The four blocks that share an
// operand slab run next to each other, so it is read once from device
// memory. f32 FMAs on the CUDA cores: wgmma for the bf16 instance is later
// work.

#include "common.cuh"

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

// One d_l element, rounded to the compute dtype.
template <typename T>
__device__ __forceinline__ float d_logit(T logit, float lse, float g,
                                         int label, int col) {
  const float p = expf(mmt_to_float(logit) - lse);
  return mmt_round<T>((p - (col == label ? 1.f : 0.f)) * g);
}

// dh tile (tokens t0.., channels d0..): As[v][t] = d_l[t, v],
// Bs[v][d] = W[d, v].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ce_dh_kernel(
    const T* __restrict__ logits, const T* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, T* __restrict__ dh, int n_tok, int dim,
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
      breg[i] = (d < dim && v < vocab)
                    ? mmt_to_float(w[(size_t)d * vocab + v])
                    : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ce_dw_kernel(
    const T* __restrict__ logits, const T* __restrict__ h,
    const int* __restrict__ labels, const float* __restrict__ g,
    const float* __restrict__ lse, T* __restrict__ dw, int n_tok, int dim,
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
      areg[i] = (tok && d < dim) ? mmt_to_float(h[(size_t)t * dim + d])
                                 : 0.f;
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

template <typename T>
void launch_dh(const void* logits, const void* w, const void* labels,
               const void* g, const void* lse, void* dh, int n_tok, int dim,
               int vocab, cudaStream_t st) {
  const dim3 grid((dim + kBN - 1) / kBN, (n_tok + kBM - 1) / kBM);
  ce_dh_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)logits, (const T*)w, (const int*)labels, (const float*)g,
      (const float*)lse, (T*)dh, n_tok, dim, vocab);
}

template <typename T>
void launch_dw(const void* logits, const void* h, const void* labels,
               const void* g, const void* lse, void* dw, int n_tok, int dim,
               int vocab, cudaStream_t st) {
  const dim3 grid((dim + kBM - 1) / kBM, (vocab + kBN - 1) / kBN);
  ce_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)logits, (const T*)h, (const int*)labels, (const float*)g,
      (const float*)lse, (T*)dw, n_tok, dim, vocab);
}

}  // namespace

// logits (T, V) and w (D, V) in `dtype` (kMmtF32 or kMmtBF16); labels (T,)
// int32; g and lse (T,) f32; dh (T, D) in `dtype`. Contiguous, on the
// device; T, D, V >= 1. One launch on `stream`. Returns cudaGetLastError().
extern "C" int mmt_fused_ce_dh(const void* logits, const void* w,
                               const void* labels, const void* g,
                               const void* lse, void* dh, int n_tok, int dim,
                               int vocab, int dtype, void* stream) {
  if (n_tok < 1 || dim < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kMmtF32)
    launch_dh<float>(logits, w, labels, g, lse, dh, n_tok, dim, vocab, st);
  else if (dtype == kMmtBF16)
    launch_dh<bf16>(logits, w, labels, g, lse, dh, n_tok, dim, vocab, st);
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
    launch_dw<float>(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  else if (dtype == kMmtBF16)
    launch_dw<bf16>(logits, h, labels, g, lse, dw, n_tok, dim, vocab, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
