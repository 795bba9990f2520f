// GBDT histogram build: per (feature f, bin b),
//   out[f][b] = [sum grad[r], sum hess[r], count]  over rows r with
//   in_leaf[r] and bins_t[f][r] == b.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_hist.py
// build_histogram_pallas (kernel body _hist_kernel), the single-chip hot op
// of the GBDT engine: every histogram of every tree.
//
// What bounds it on the H100: bytes. It reads each bin once (4 B as int32,
// F x n of them), grad and hess (4 B each) and the mask (1 B) once per row,
// and writes F x B x 3 f32. At 2^20 rows x 28 features that is 130 MB:
// 39 us at 3.35 TB/s. Its adds are a few per element, far below the f32
// rate. At the bench configs (4096 x 100, 32768 x 14) the bound is under
// 2 us and the launch sets the time.
//
// What the design does about it. The TPU kernel turns the histogram into an
// MXU product, [g.m, h.m, m] @ onehot(bins), accumulated along a sequential
// row axis into one VMEM block. None of that carries over: here the work is
// a scatter of row values into per-bin sums. Two properties must survive:
// the sums are f32 and differ from the plain version (tree.py's flat
// scatter-add) only by summation order, and the same inputs give
// bit-identical output on every launch, since split decisions are
// tie-sensitive and a fit on the card must give the same trees every run.
// Float atomics to device memory would break the second, so there are none:
//   - block (c, g) takes row chunk c (chunk_rows rows) and features
//     8g .. 8g + 7, one warp each. A warp owns a private shared-memory
//     histogram of its feature (B bins x 3 f32, bank-conflict free at stride
//     3) that no other thread touches;
//   - the warp walks its rows in order, 32 at a time: lane l reads row
//     r0 + l of its feature (consecutive addresses in the transposed (F, n)
//     layout: one 128-byte read), and the row's grad, hess and mask (shared
//     by the block's warps, so mostly L1 hits). A group whose rows are all
//     outside the leaf is skipped. Lanes whose bins are equal
//     (__match_any_sync) sum their values in ascending lane order through
//     shuffles, and the lowest of them adds the sum to the bin. Leaders of
//     one group have distinct bins, so the adds need no atomics;
//   - each warp writes its feature's partial histogram for the chunk to
//     scratch, and a second small launch sums the chunks per (f, b, channel)
//     in chunk order (as the fused CE forward merges its vocab slices).
// The count channel adds 1.0f per row: exact below 2^24 rows. A bin outside
// [0, B) is skipped (the bin mapper never makes one). Known gaps, later
// work: bins could be read as uint8 while max_bin <= 255 (a quarter of the
// bytes); each warp re-tests and re-reads its rows' mask, grad and hess
// once per feature.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // features per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBins = 2048;  // 8 x 2048 x 12 B = 192 KB of shared memory

__global__ void __launch_bounds__(kThreads) hist_partials_kernel(
    const int* __restrict__ bins_t, const float* __restrict__ grad,
    const float* __restrict__ hess, const unsigned char* __restrict__ in_leaf,
    float* __restrict__ part, int n, int n_features, int n_bins,
    int chunk_rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.y * kWarps + warp;
  if (f >= n_features) return;  // warp-uniform; no block barrier below
  float* hist = smem + (size_t)warp * n_bins * 3;
  for (int i = lane; i < n_bins * 3; i += 32) hist[i] = 0.f;
  __syncwarp();

  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int* col = bins_t + (size_t)f * n;
  for (int r0 = r_begin; r0 < r_end; r0 += 32) {
    const int r = r0 + lane;
    bool live = r < r_end && in_leaf[r] != 0;
    const int b = live ? col[r] : -1;
    live = live && b >= 0 && b < n_bins;
    if (!__any_sync(MMT_FULL_MASK, live)) continue;
    const float g = live ? grad[r] : 0.f;
    const float h = live ? hess[r] : 0.f;
    const unsigned peers = __match_any_sync(MMT_FULL_MASK, live ? b : -1);
    // every lane sums its bin's peers in ascending lane order; lanes
    // outside the leaf take part in the shuffles only
    unsigned rest = live ? peers : 0u;
    float sg = 0.f, sh = 0.f, sc = 0.f;
    while (__any_sync(MMT_FULL_MASK, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float vg = __shfl_sync(MMT_FULL_MASK, g, src);
      const float vh = __shfl_sync(MMT_FULL_MASK, h, src);
      if (rest) {
        sg += vg;
        sh += vh;
        sc += 1.f;
        rest &= rest - 1u;
      }
    }
    if (live && lane == __ffs(peers) - 1) {
      float* cell = hist + b * 3;
      cell[0] += sg;
      cell[1] += sh;
      cell[2] += sc;
    }
  }
  __syncwarp();
  float* dst = part + ((size_t)blockIdx.x * n_features + f) * n_bins * 3;
  for (int i = lane; i < n_bins * 3; i += 32) dst[i] = hist[i];
}

// One thread per (feature, bin, channel): the chunks' partials summed in
// chunk order.
__global__ void __launch_bounds__(kThreads) hist_merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n_chunks,
    int size) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += part[(size_t)c * size + i];
  out[i] = acc;
}

}  // namespace

// bins_t (F, n) int32, grad/hess (n,) f32, in_leaf (n,) bool (1 byte),
// scratch (n_chunks, F, B, 3) f32 (unused when n_chunks == 1), out (F, B, 3)
// f32. n_chunks must be ceil(n / chunk_rows), chunk_rows a multiple of 32.
extern "C" int mmt_gbdt_histogram(const void* bins_t, const void* grad,
                                  const void* hess, const void* in_leaf,
                                  void* scratch, void* out, int n,
                                  int n_features, int n_bins, int chunk_rows,
                                  int n_chunks, void* stream) {
  if (n < 1 || n_features < 1 || n_bins < 1 || n_bins > kMaxBins ||
      chunk_rows < 32 || chunk_rows % 32 != 0 ||
      n_chunks != (n + chunk_rows - 1) / chunk_rows ||
      (n_chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // idempotent: a race only repeats it
  if (!smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hist_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWarps * kMaxBins * 3 * (int)sizeof(float));
    if (rc != cudaSuccess) return (int)rc;
    smem_set = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = n_chunks > 1 ? (float*)scratch : (float*)out;
  const dim3 grid(n_chunks, (n_features + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * n_bins * 3 * sizeof(float);
  hist_partials_kernel<<<grid, kThreads, smem, st>>>(
      (const int*)bins_t, (const float*)grad, (const float*)hess,
      (const unsigned char*)in_leaf, part, n, n_features, n_bins, chunk_rows);
  int rc = (int)cudaGetLastError();
  if (rc || n_chunks == 1) return rc;
  const int size = n_features * n_bins * 3;
  hist_merge_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, (float*)out, n_chunks, size);
  return (int)cudaGetLastError();
}
