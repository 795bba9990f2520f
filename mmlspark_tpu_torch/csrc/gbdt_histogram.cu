// GBDT histogram build: per (feature f, bin b),
//   out[f][b] = [sum grad[r], sum hess[r], count]  over rows r with
//   in_leaf[r] and bins_t[f][r] == b.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_hist.py
// build_histogram_pallas (kernel body _hist_kernel), the single-chip hot op
// of the GBDT engine: every histogram of every tree.
//
// What bounds it on the H100: bytes. It reads the mask (1 B a row) and,
// for the rows in the leaf, their bins (1 B as uint8 while the bin count
// is <= 256, else 4 B as int32), grad and hess (4 B each), and writes
// F x B x 3 f32. A root histogram at 2^20 rows x 28 features in uint8 is
// about 39 MB: 12 us at 3.35 TB/s. A leaf's rows are a few per cent of n,
// scattered in row order, so most launches move a mask read and little
// else. Its adds are a few per element, far below the f32 rate, but each
// one is a read-modify-write of a shared-memory bin, and which rows of 32
// share a bin is known only from the data: finding them (below) is what
// the root spends most of its time on, not the bytes.
//
// Two properties must hold: the sums are f32 and differ from the plain
// version (tree.py's flat scatter-add) only by summation order, and the
// same inputs give bit-identical output on every launch (split decisions
// are tie-sensitive: a fit on the card must give the same trees every
// run). So there are no float atomics, global or shared: every sum is
// taken in a fixed order. Counts are exact integers.
//
// The design. Block (c, g) takes row chunk c and features G g .. G g + G -
// 1, one warp each (G <= 32, as many as the block's histograms, G x B x 12
// bytes, and tag arrays, G x B x 4, leave room for in shared memory). It
// walks its chunk 8192 rows at a time:
//   1. compaction: the threads read the chunk's mask, 16 rows a thread by
//      one 16-byte load, and write the offsets of the rows in the leaf, in
//      row order (popc of each thread's flags, a block-wide prefix sum),
//      into shared memory. The work below scales with these rows, not n;
//   2. a 3-stage cp.async ring over that list, 256 rows a stage: grad and
//      hess of each listed row (read once for all G features) and the 4-byte
//      word holding its bin for each feature (uint8 bins: the word's byte is
//      picked when it is used). A stage's ~(G + 2) x 256 copies are all in
//      flight at once, two stages ahead of the warps;
//   3. warp f walks a stage's rows 32 at a time: lanes whose bins are equal
//      (found through a per-warp tag array and five ballots) pass their
//      values through shuffles to the lowest of them, which adds them to
//      its bin one by one in lane order (float2 grad/hess, uint32 count):
//      within a block every bin sums its rows in row order, as the plain
//      version does. Leaders of one group have distinct bins and no other
//      warp touches feature f: no atomics.
// The chunks' histograms merge in a fixed order: the blocks of a thread
// block cluster (8 consecutive chunks) sum each other's shared-memory
// histograms through distributed shared memory, each block a slice of the
// cells, in rank order, and write one partial per cluster (F x B x 12
// bytes: 15 partials on an H100, which holds 15 such clusters at once, 1.3
// MB at the 2^20 x 28 x 255 root against 29 MB of uint8 bins); a second
// small launch sums the partials in cluster order. With
// one cluster the cluster writes the output itself; at most 8192 rows run
// in one block, whose sums are then the plain version's bit for bit.
// A bin outside [0, B) is skipped (the bin mapper never makes one). The
// count channel is exact below 2^24 rows.

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

namespace hp = hopper;

constexpr int kTile = 256;    // listed rows a ring stage
constexpr int kStages = 3;
constexpr int kSub = 8192;    // rows compacted at a time (uint16 offsets)
constexpr int kMaxWarps = 32; // features a block
constexpr int kMaxBins = 2048;
constexpr int kMaxCluster = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// Byte offsets of the block's shared-memory sections (each 16-byte
// aligned) for G features at B bins. The host asks for the most features
// that fit (mmt_gbdt_histogram_max_feats) rather than mirroring this.
struct Layout {
  int gh, cnt, tag, stage_gh, stage_bins, list, scan, total;
  __host__ __device__ static int up(int x) { return (x + 15) & ~15; }
  __host__ __device__ Layout(int g, int b) {
    gh = 0;                                  // float2 [G][B]
    cnt = up(gh + g * b * 8);                // uint32 [G][B]
    tag = up(cnt + g * b * 4);               // int [G][B]
    stage_gh = up(tag + g * b * 4);          // float2 [kStages][kTile]
    stage_bins = stage_gh + kStages * kTile * 8;   // uint32 [kStages][G][kTile]
    list = stage_bins + kStages * g * kTile * 4;   // uint16 [kSub]
    scan = list + kSub * 2;                  // int [kMaxWarps + 1]
    total = up(scan + (kMaxWarps + 1) * 4);
  }
};

// A row's flags from 16 mask bytes: bit j set where byte j is nonzero.
__device__ __forceinline__ unsigned flags16(uint4 w) {
  const unsigned wd[4] = {w.x, w.y, w.z, w.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits |= (((wd[i] >> (8 * j)) & 0xffu) != 0u) << (4 * i + j);
  return bits;
}

// The offsets from s0 of rows s0 .. s1 - 1 in the leaf, in row order, into
// `list`; returns their count. Every thread of the block calls it.
__device__ int compact(const unsigned char* __restrict__ in_leaf, int s0,
                       int s1, unsigned short* list, int* scan) {
  const int nthr = blockDim.x, nw = nthr >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_seg = (s1 - s0 + 15) >> 4;  // 16 rows a thread
  int total = 0;
  for (int seg0 = 0; seg0 < n_seg; seg0 += nthr) {
    const int seg = seg0 + threadIdx.x;
    unsigned bits = 0;
    if (seg < n_seg) {
      const int r = s0 + seg * 16;
      const unsigned char* p = in_leaf + r;
      if (r + 16 <= s1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        bits = flags16(*reinterpret_cast<const uint4*>(p));
      } else {
        for (int j = 0; j < 16 && r + j < s1; ++j)
          bits |= (p[j] != 0) << j;
      }
    }
    const int cnt = __popc(bits);
    int incl = cnt;  // inclusive prefix over the warp's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(MMT_FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < nw ? scan[lane] : 0;
      int wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(MMT_FULL_MASK, wi, d);
        if (lane >= d) wi += y;
      }
      if (lane < nw) scan[lane] = wi - w;  // warps before this one
      if (lane == 31) scan[kMaxWarps] = wi;
    }
    __syncthreads();
    int pos = total + scan[warp] + incl - cnt;
    while (bits) {
      list[pos++] = (unsigned short)(seg * 16 + __ffs(bits) - 1);
      bits &= bits - 1;
    }
    total += scan[kMaxWarps];
    __syncthreads();  // scan[] is reused by the next round
  }
  return total;
}

template <typename BinT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) hist_kernel(
    const BinT* __restrict__ bins_t, const float* __restrict__ grad,
    const float* __restrict__ hess, const unsigned char* __restrict__ in_leaf,
    float* __restrict__ part, float* __restrict__ out, int n, int n_features,
    int n_bins, int chunk_rows, int n_clusters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x >> 5;
  const Layout L(G, n_bins);
  float2* hgh = reinterpret_cast<float2*>(smem + L.gh);
  unsigned* hcnt = reinterpret_cast<unsigned*>(smem + L.cnt);
  int* htag = reinterpret_cast<int*>(smem + L.tag);
  float2* sgh = reinterpret_cast<float2*>(smem + L.stage_gh);
  unsigned* sbins = reinterpret_cast<unsigned*>(smem + L.stage_bins);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  int* scan = reinterpret_cast<int*>(smem + L.scan);
  const int nthr = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * G, f = f0 + warp;  // f past F: no sums
  const size_t bin_bytes = (size_t)n_features * n * sizeof(BinT);

  for (int i = threadIdx.x; i < G * n_bins; i += nthr) {
    hgh[i] = make_float2(0.f, 0.f);
    hcnt[i] = 0u;
  }

  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  for (int s0 = r_begin; s0 < r_end; s0 += kSub) {
    const int n_live = compact(in_leaf, s0, min(r_end, s0 + kSub), list,
                               scan);
    const int n_tiles = (n_live + kTile - 1) / kTile;
    // stage `tt`: listed rows tt kTile .. (tt + 1) kTile - 1; one commit
    // group a stage, empty past the last tile
    auto fill = [&](int tt) {
      if (tt < n_tiles) {
        const int st = tt % kStages, k0 = tt * kTile;
        const int cnt = min(kTile, n_live - k0);
        float2* dgh = sgh + st * kTile;
        unsigned* db = sbins + (size_t)st * G * kTile;
        for (int idx = threadIdx.x; idx < (G + 2) * kTile; idx += nthr) {
          const int a = idx / kTile, k = idx % kTile;
          if (k >= cnt) continue;
          const int row = s0 + list[k0 + k];
          if (a == 0) {
            hp::cp_async4(&dgh[k].x, grad + row, 4);
          } else if (a == 1) {
            hp::cp_async4(&dgh[k].y, hess + row, 4);
          } else if (f0 + a - 2 < n_features) {
            const size_t at = (size_t)(f0 + a - 2) * n + row;  // element
            const size_t word = at * sizeof(BinT) / 4;
            const size_t left = bin_bytes - word * 4;  // past it: zeros
            hp::cp_async4(&db[(a - 2) * kTile + k],
                          reinterpret_cast<const unsigned*>(bins_t) + word,
                          left < 4 ? (int)left : 4);
          }
        }
      }
      hp::cp_commit();
    };
    fill(0);
    fill(1);
    for (int tt = 0; tt < n_tiles; ++tt) {
      hp::cp_wait<kStages - 2>();
      __syncthreads();  // stage tt landed; stage tt - 1 is free
      fill(tt + kStages - 1);
      if (f >= n_features) continue;  // warp-uniform
      const int st = tt % kStages, k0 = tt * kTile;
      const int cnt = min(kTile, n_live - k0);
      const float2* cgh = sgh + st * kTile;
      const unsigned* cb = sbins + ((size_t)st * G + warp) * kTile;
      float2* fgh = hgh + warp * n_bins;
      unsigned* fcnt = hcnt + warp * n_bins;
      int* ftag = htag + warp * n_bins;
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int k = j0 + lane;
        int b = -1;
        float g = 0.f, h = 0.f;
        if (k < cnt) {
          unsigned wv = cb[k];
          if (sizeof(BinT) == 1) {
            const size_t at = (size_t)f * n + s0 + list[k0 + k];
            wv = (wv >> (8 * (at & 3))) & 0xffu;
          }
          if (wv < (unsigned)n_bins) b = (int)wv;
          const float2 v = cgh[k];
          g = v.x;
          h = v.y;
        }
        // the lanes holding this lane's bin (lanes outside the leaf take
        // part in the ballots and shuffles only): each lane writes its lane
        // id at its bin and reads back the one that stayed, some lane of
        // that bin; five ballots over that id's bits gather the lanes that
        // read the same one. Which write stays is up to the hardware, the
        // set of peers is not. (__match_any_sync gives the same set at
        // several times the cost.)
        if (b >= 0) ftag[b] = lane;
        __syncwarp();
        const int rep = b >= 0 ? ftag[b] : 0;
        unsigned peers = __ballot_sync(MMT_FULL_MASK, b >= 0);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const bool bit = (rep >> j) & 1;
          const unsigned m = __ballot_sync(MMT_FULL_MASK, bit);
          peers &= bit ? m : ~m;
        }
        // the lowest lane adds its row's values to the bin, then each
        // peer's in lane order: every bin sums its rows one by one in row
        // order, as the plain version does
        const bool lead = b >= 0 && lane == __ffs(peers) - 1;
        unsigned rest = lead ? peers & (peers - 1u) : 0u;
        float2 c = make_float2(0.f, 0.f);
        if (lead) {
          c = fgh[b];
          c.x += g;
          c.y += h;
        }
        while (__any_sync(MMT_FULL_MASK, rest != 0u)) {
          const int src = rest ? __ffs(rest) - 1 : lane;
          const float vg = __shfl_sync(MMT_FULL_MASK, g, src);
          const float vh = __shfl_sync(MMT_FULL_MASK, h, src);
          if (rest) {
            c.x += vg;
            c.y += vh;
            rest &= rest - 1u;
          }
        }
        if (lead) {
          fgh[b] = c;
          fcnt[b] += __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the list and the ring are reused
  }

  // the cluster's histograms summed in rank order, each block a slice
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cells = G * n_bins, per = (cells + cl - 1) / cl;
  const int c_hi = min(cells, (rank + 1) * per);
  float* dst = n_clusters == 1
                   ? out
                   : part + (size_t)(blockIdx.x / cl) * n_features * n_bins * 3;
  for (int c = rank * per + threadIdx.x; c < c_hi; c += nthr) {
    if (f0 + c / n_bins >= n_features) continue;
    float sg = 0.f, sh = 0.f;
    unsigned sc = 0u;
    for (int q = 0; q < cl; ++q) {
      const float2 v = cluster.map_shared_rank(hgh, q)[c];
      sg += v.x;
      sh += v.y;
      sc += cluster.map_shared_rank(hcnt, q)[c];
    }
    float* d = dst + ((size_t)f0 * n_bins + c) * 3;
    d[0] = sg;
    d[1] = sh;
    d[2] = (float)sc;
  }
  cluster.sync();  // no block leaves while another reads its histograms
}

// One thread per (feature, bin, channel): the clusters' partials summed in
// cluster order.
__global__ void __launch_bounds__(256) hist_merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n_parts,
    int size) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int c = 0; c < n_parts; ++c) acc += part[(size_t)c * size + i];
  out[i] = acc;
}

template <typename BinT>
cudaError_t allow_smem() {
  static bool raised = false;
  return hp::allow_smem(hist_kernel<BinT>, kSmemMax, raised);
}

cudaLaunchConfig_t config(int row_blocks, int groups, int feats, int n_bins,
                          int cluster, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, groups, 1);
  cfg.blockDim = dim3(32 * feats, 1, 1);
  cfg.dynamicSmemBytes = Layout(feats, n_bins).total;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename BinT>
int launch(const void* bins_t, const void* grad, const void* hess,
           const void* in_leaf, void* scratch, void* out, int n,
           int n_features, int n_bins, int feats, int row_blocks,
           int cluster, int chunk_rows, cudaStream_t st) {
  cudaError_t rc = allow_smem<BinT>();
  if (rc != cudaSuccess) return (int)rc;
  const int groups = (n_features + feats - 1) / feats;
  const int n_clusters = row_blocks / cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(row_blocks, groups, feats, n_bins, cluster, st, &attr);
  rc = cudaLaunchKernelEx(
      &cfg, hist_kernel<BinT>, (const BinT*)bins_t, (const float*)grad,
      (const float*)hess, (const unsigned char*)in_leaf, (float*)scratch,
      (float*)out, n, n_features, n_bins, chunk_rows, n_clusters);
  if (rc != cudaSuccess || n_clusters == 1) return (int)rc;
  const int size = n_features * n_bins * 3;
  hist_merge_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      (const float*)scratch, (float*)out, n_clusters, size);
  return (int)cudaGetLastError();
}

}  // namespace

// bins_t (F, n) uint8 (bins_u8 = 1, n_bins <= 256, 4-byte aligned) or
// int32; grad/hess (n,) f32, in_leaf (n,) bool (1 byte), out (F, B, 3)
// f32; scratch (row_blocks / cluster, F, B, 3) f32 when row_blocks >
// cluster. Blocks of 32 x feats threads take feats features each and
// chunk_rows rows each, in clusters of `cluster` along the rows
// (gbdt/cuda_hist.py hist_plan). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int mmt_gbdt_histogram(const void* bins_t, const void* grad,
                                  const void* hess, const void* in_leaf,
                                  void* scratch, void* out, int n,
                                  int n_features, int n_bins, int bins_u8,
                                  int feats, int row_blocks, int cluster,
                                  int chunk_rows, void* stream) {
  if (n < 1 || n_features < 1 || n_bins < 1 || n_bins > kMaxBins ||
      feats < 1 || feats > kMaxWarps || cluster < 1 ||
      cluster > kMaxCluster || row_blocks % cluster != 0 ||
      chunk_rows < 1 || (long long)row_blocks * chunk_rows < n ||
      Layout(feats, n_bins).total > kSmemMax ||
      (row_blocks > cluster && scratch == nullptr) ||
      (bins_u8 && (n_bins > 256 ||
                   reinterpret_cast<uintptr_t>(bins_t) % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bins_u8)
    return launch<unsigned char>(bins_t, grad, hess, in_leaf, scratch, out,
                                 n, n_features, n_bins, feats, row_blocks,
                                 cluster, chunk_rows, st);
  return launch<int>(bins_t, grad, hess, in_leaf, scratch, out, n,
                     n_features, n_bins, feats, row_blocks, cluster,
                     chunk_rows, st);
}

// The most features a block takes at n_bins bins (its histograms, tag
// arrays and ring in kSmemMax bytes of shared memory, at most kMaxWarps),
// into *max_feats.
extern "C" int mmt_gbdt_histogram_max_feats(int n_bins, int* max_feats) {
  if (n_bins < 1 || n_bins > kMaxBins) return (int)cudaErrorInvalidValue;
  int g = kMaxWarps;
  while (g > 1 && Layout(g, n_bins).total > kSmemMax) --g;
  *max_feats = g;
  return 0;
}

// How many clusters of `cluster` blocks of the kernel (feats features at
// n_bins bins) the card holds at once, into *max_clusters.
extern "C" int mmt_gbdt_histogram_max_clusters(int bins_u8, int feats,
                                               int n_bins, int cluster,
                                               int* max_clusters) {
  if (feats < 1 || feats > kMaxWarps || cluster < 1 ||
      cluster > kMaxCluster || Layout(feats, n_bins).total > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc =
      bins_u8 ? allow_smem<unsigned char>() : allow_smem<int>();
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(cluster, 1, feats, n_bins, cluster, nullptr, &attr);
  rc = bins_u8 ? cudaOccupancyMaxActiveClusters(
                     max_clusters, hist_kernel<unsigned char>, &cfg)
               : cudaOccupancyMaxActiveClusters(max_clusters,
                                                hist_kernel<int>, &cfg);
  return (int)rc;
}
