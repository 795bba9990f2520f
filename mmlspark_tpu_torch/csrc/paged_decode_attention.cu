// Paged decode attention: one query per slot against the slot's paged lane.
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// paged_decode_attention (kernel body _paged_attn_kernel).
//
// What bounds it on the H100: bytes. Every decode step reads each slot's
// live K and V rows (pos + 1 rows of H * Dh f32 each) once and does two
// FMAs per element read, far below the card's f32 rate per byte. At the
// decode path's width (8 slots, 8 heads x 64, pos about 300) that is 9.8 MB,
// under 3 us at 3.35 TB/s, so what sets the time is latency: how many
// blocks stream at once, and how many dependent round trips each waits on.
//
// What the design does about it:
//   - the lane is split across blocks: the grid is (split, slot), split j
//     a fixed run of pages_per_split table entries that the host picks from
//     the shapes alone (cuda_attention.paged_decode_plan), so a batch of 8
//     slots at pos 300 runs about 160 blocks, not 8 x 8 heads;
//   - a block handles all heads of its run. It reads pos and its run of
//     table entries at once, then one thread streams whole pages, K and V
//     for every head (page_size * H * Dh contiguous floats in the pool
//     layout), into a 2-stage ring in shared memory by 1-D bulk async
//     copies (cp.async.bulk onto an mbarrier). A page larger than a stage
//     (16 KB of K and 16 KB of V) streams in chunks of rows. No K/V load
//     waits on a table load: the table is read once, with pos;
//   - dead pages are never read: a split that starts past pos exits after
//     reading pos, and a chunk that starts past pos is never copied (every
//     unclaimed, scratch-aimed table entry lies past pos). Rows past pos in
//     the live last chunk are staged but masked by select: score -1e30,
//     p = 0, never 0 * v of a row that was not selected;
//   - scores and P.V on the CUDA cores: warp w owns heads w, w + 8, ...;
//     a lane owns channels lane and lane + 32, and each head's running
//     (m, l, acc) lives in shared memory across chunks. One query row a
//     slot would leave an m16 tensor-core tile 15/16 empty;
//   - each split writes its partial (m, l, acc) to a workspace, and a
//     second kernel (the merge of paged_split.cuh, launched by the same C
//     entry as a programmatic dependent launch, so its launch overlaps the
//     split kernel) merges a slot's live splits in split order by their
//     maxima. Both kernels sum in a fixed order: two launches give the
//     same bits.
// Scores live in the log2 domain (q is scaled by scale * log2 e once), as
// the merge expects. Rows whose H * Dh floats are not 16-byte aligned take
// an element-copy path into the same ring, never the plain version. Any
// Dh <= 64, any page size, any pages_per_slot.

#include "common.cuh"
#include "hopper_mma.cuh"
#include "paged_split.cuh"

namespace {

namespace hp = hopper;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowLanes = 8;                 // lanes that score one row
constexpr int kGroups = 32 / kRowLanes;      // rows a warp scores at once
constexpr int kQRegs = 4;  // query floats a thread loads beside pos
constexpr int kMaxStages = 2;
constexpr int kChunkBytes = 16384;  // K (and V) bytes a stage holds at most
constexpr int kMaxSmem = 232448;    // an H100 block's dynamic shared memory

// Rows of one page a stage holds: as many as fit kChunkBytes, at least 1.
int chunk_rows(int page_size, int row_floats) {
  const int rows = kChunkBytes / (row_floats * (int)sizeof(float));
  return rows < 1 ? 1 : (rows > page_size ? page_size : rows);
}

struct Shape {
  int n_slots, n_heads, head_dim, page_size, pages_per_slot;
  int pages_per_split, n_splits, chunk_rows, n_stages;
};

// Dynamic shared memory: the stages' mbarriers (16 bytes), the ring (K then
// V, n_stages x chunk_rows x H x Dh each), the scaled query, each (head,
// row group)'s accumulator, m and l, and the run of table entries.
__host__ __device__ inline int ring_floats(const Shape& s) {
  return s.n_stages * s.chunk_rows * s.n_heads * s.head_dim;
}
inline int smem_bytes(const Shape& s) {
  const int hd = s.n_heads * s.head_dim;
  return 16 + (int)sizeof(float) * (2 * ring_floats(s) + hd +
                                    kGroups * (hd + 2 * s.n_heads)) +
         (int)sizeof(int) * s.pages_per_split;
}

// Loads issued in program order (volatile), so that the block's first
// loads all go out before it waits on any of them.
__device__ __forceinline__ int ld_first(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_first(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// This lane's 8 of a row's head_dim floats: 4 at c0 and 4 at c0 + 32
// (zeros past head_dim). `vec` (head_dim % 4 == 0: 16-byte aligned rows):
// two 16-byte loads, so the 8 lanes of a row read 128 contiguous bytes.
__device__ __forceinline__ void load8(const float* row, int c0, int head_dim,
                                      bool vec, float (&x)[8]) {
  if (vec) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a =
        c0 < head_dim ? *reinterpret_cast<const float4*>(row + c0) : z;
    const float4 b = c0 + 32 < head_dim
                         ? *reinterpret_cast<const float4*>(row + c0 + 32)
                         : z;
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = c0 + i < head_dim ? row[c0 + i] : 0.f;
      x[4 + i] = c0 + 32 + i < head_dim ? row[c0 + 32 + i] : 0.f;
    }
  }
}
__device__ __forceinline__ void store8(float* row, int c0, int head_dim,
                                       const float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c0 + i < head_dim) row[c0 + i] = x[i];
    if (c0 + 32 + i < head_dim) row[c0 + 32 + i] = x[4 + i];
  }
}

// Fold the online state of the lane `mask` away into this lane's, by the
// two maxima (a state that saw no row, m = -1e30 and l = 0, weighs 0).
__device__ __forceinline__ void fold(float& m, float& l, float (&a)[8],
                                     int mask) {
  const float mo = __shfl_xor_sync(MMT_FULL_MASK, m, mask);
  const float lo = __shfl_xor_sync(MMT_FULL_MASK, l, mask);
  const float big = fmaxf(m, mo);
  const float wa = exp2f(m - big), wb = exp2f(mo - big);
  l = l * wa + lo * wb;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = a[i] * wa + __shfl_xor_sync(MMT_FULL_MASK, a[i], mask) * wb;
  m = big;
}

__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ ws, Shape sh,
    float scale_log2, bool aligned) {
  hp::launch_dependents();  // the merge may launch; it waits for this grid
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* ks = reinterpret_cast<float*>(smem_raw + 16);
  float* vs = ks + ring_floats(sh);
  const int hd = sh.n_heads * sh.head_dim;
  float* q_s = vs + ring_floats(sh);
  float* acc_s = q_s + hd;                   // [head][group][head_dim]
  float* m_s = acc_s + kGroups * hd;         // [head][group]
  float* l_s = m_s + kGroups * sh.n_heads;
  int* tbl_s = reinterpret_cast<int*>(l_s + kGroups * sh.n_heads);

  const int n = blockIdx.x % sh.n_slots, split = blockIdx.x / sh.n_slots;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0 && aligned) {
    for (int st = 0; st < sh.n_stages; ++st) hp::mbar_init(bars + st);
    hp::mbar_init_fence();
  }
  // the block's first loads, all at once: its run of table entries, the
  // query, and pos
  const int lane_len = sh.pages_per_slot * sh.page_size;
  const int p0 = split * sh.pages_per_split;
  const int* table = tables + (size_t)n * sh.pages_per_slot + p0;
  const int entry = tid < min(sh.pages_per_split, sh.pages_per_slot - p0)
                        ? ld_first(table + tid)
                        : 0;
  const float* qn = q + (size_t)n * hd;
  float qv[kQRegs];
#pragma unroll
  for (int i = 0; i < kQRegs; ++i)
    qv[i] = tid + i * kThreads < hd ? ld_first(qn + tid + i * kThreads) : 0.f;
  const int last = min(ld_first(pos + n), lane_len - 1);
  if (p0 * sh.page_size > last) return;  // a dead split: nothing to read

  // the run's live pages and their chunks
  const int n_pages = min(sh.pages_per_split, last / sh.page_size + 1 - p0);
  const int cpp = (sh.page_size + sh.chunk_rows - 1) / sh.chunk_rows;
  // chunks that start at or before pos (the run's last page may be full)
  const int last_row = last - (p0 + n_pages - 1) * sh.page_size;
  const int n_chunks =
      (n_pages - 1) * cpp + min(cpp, last_row / sh.chunk_rows + 1);
  if (tid < n_pages) tbl_s[tid] = entry;
  for (int i = kThreads + tid; i < n_pages; i += kThreads) tbl_s[i] = table[i];
  // the query in the log2 domain, and each (head, group)'s empty state
#pragma unroll
  for (int i = 0; i < kQRegs; ++i)
    if (tid + i * kThreads < hd) q_s[tid + i * kThreads] = qv[i] * scale_log2;
  for (int i = kQRegs * kThreads + tid; i < hd; i += kThreads)
    q_s[i] = qn[i] * scale_log2;
  for (int i = tid; i < kGroups * hd; i += kThreads) acc_s[i] = 0.f;
  for (int i = tid; i < kGroups * sh.n_heads; i += kThreads) {
    m_s[i] = MMT_NEG_INF;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const size_t page_floats = (size_t)sh.page_size * hd;
  // chunk c: page c / cpp of the run, rows [r0, r0 + rows) of it
  auto chunk_src = [&](int c, int& rows, int& row0) -> size_t {
    const int sub = c % cpp;
    row0 = sub * sh.chunk_rows;
    rows = min(sh.chunk_rows, sh.page_size - row0);
    return (size_t)tbl_s[c / cpp] * page_floats + (size_t)row0 * hd;
  };
  auto issue = [&](int c) {  // thread 0: the chunk's K and V, whole
    int rows, row0;
    const size_t src = chunk_src(c, rows, row0);
    const int st = c % sh.n_stages;
    const uint32_t bytes = (uint32_t)rows * hd * sizeof(float);
    hp::mbar_expect(bars + st, 2 * bytes);
    const size_t at = (size_t)st * sh.chunk_rows * hd;
    hp::bulk_load(ks + at, k_pages + src, bytes, bars + st);
    hp::bulk_load(vs + at, v_pages + src, bytes, bars + st);
  };
  if (aligned && tid == 0)
    for (int c = 0; c < sh.n_stages && c < n_chunks; ++c) issue(c);

  // a warp scores kGroups rows at once, 8 lanes a row, each lane 8
  // channels (c0 .. c0 + 3, c0 + 32 .. c0 + 35); row group grp keeps its
  // own online state over rows grp, grp + kGroups, ...
  const int grp = lane / kRowLanes, c0 = 4 * (lane % kRowLanes);
  const bool vec = sh.head_dim % 4 == 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % sh.n_stages;
    int rows, row0;
    const size_t src = chunk_src(c, rows, row0);
    const float* kc = ks + (size_t)st * sh.chunk_rows * hd;
    const float* vc = vs + (size_t)st * sh.chunk_rows * hd;
    if (aligned) {
      hp::mbar_wait(bars + st, (c / sh.n_stages) & 1);
    } else {  // element copies of the same contiguous run
      float* kd = ks + (size_t)st * sh.chunk_rows * hd;
      float* vd = vs + (size_t)st * sh.chunk_rows * hd;
      for (int i = tid; i < rows * hd; i += kThreads) {
        kd[i] = k_pages[src + i];
        vd[i] = v_pages[src + i];
      }
      __syncthreads();
    }
    // virtual row of the chunk's row 0; rows past pos are masked
    const int g0 = (p0 + c / cpp) * sh.page_size + row0;
    for (int h = warp; h < sh.n_heads; h += kWarps) {
      const int at_s = h * kGroups + grp;
      float qh[8], a[8];
      load8(q_s + h * sh.head_dim, c0, sh.head_dim, vec, qh);
      load8(acc_s + at_s * sh.head_dim, c0, sh.head_dim, vec, a);
      float m = m_s[at_s], l = l_s[at_s];
      for (int base = 0; base < rows; base += 2 * kGroups) {
        float s[2], v[2][8];
        bool vis[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int r = base + grp + kGroups * t;
          float k[8];
          if (r < rows) {
            const int at = (r * sh.n_heads + h) * sh.head_dim;
            load8(kc + at, c0, sh.head_dim, vec, k);
            load8(vc + at, c0, sh.head_dim, vec, v[t]);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) k[i] = v[t][i] = 0.f;
          }
          s[t] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[t] = fmaf(k[i], qh[i], s[t]);
          vis[t] = r < rows && g0 + r <= last;
        }
#pragma unroll
        for (int o = 1; o < kRowLanes; o <<= 1)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            s[t] += __shfl_xor_sync(MMT_FULL_MASK, s[t], o);
        const float m_new = fmaxf(m, fmaxf(vis[0] ? s[0] : MMT_NEG_INF,
                                           vis[1] ? s[1] : MMT_NEG_INF));
        const float alpha = exp2f(m - m_new);
        l *= alpha;
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] *= alpha;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (vis[t]) {  // select: a masked row's v is never multiplied
            const float p = exp2f(s[t] - m_new);
            l += p;
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = fmaf(p, v[t][i], a[i]);
          }
        m = m_new;
      }
      if (lane % kRowLanes == 0) {
        m_s[at_s] = m;
        l_s[at_s] = l;
      }
      store8(acc_s + at_s * sh.head_dim, c0, sh.head_dim, a);
    }
    __syncthreads();  // every warp is done with stage st
    if (aligned && tid == 0 && c + sh.n_stages < n_chunks)
      issue(c + sh.n_stages);
  }

  // the split's partial: each head's row groups folded in a fixed order
  // (groups 0 and 1, 2 and 3, then the pairs) by the warp that owns it
  const size_t item = (size_t)n * sh.n_splits + split;
  float* wa = ws + item * hd;
  float* wml = ws + (size_t)sh.n_slots * sh.n_splits * hd +
               item * sh.n_heads * 2;
  for (int h = warp; h < sh.n_heads; h += kWarps) {
    const int at_s = h * kGroups + grp;
    float a[8];
    load8(acc_s + at_s * sh.head_dim, c0, sh.head_dim, vec, a);
    float m = m_s[at_s], l = l_s[at_s];
#pragma unroll
    for (int mask = kRowLanes; mask < 32; mask <<= 1) fold(m, l, a, mask);
    if (grp == 0) store8(wa + h * sh.head_dim, c0, sh.head_dim, a);
    if (lane == 0) {
      wml[2 * h] = m;
      wml[2 * h + 1] = l;
    }
  }
}

// One warp per (item, head): the item's live splits merged in split
// order (paged_split.cuh has the layout and the numerics). Every load goes
// out at once, before pos says which splits are live: lane j reads split
// j's m and l, and every lane its channels (lane, lane + 32) of the first
// kMergeAhead splits' accumulators; values of splits that are not live
// are never used. The maxima reduce across the warp, the weights go round
// by shuffles, and the sums run over the splits in order, kMergeAhead
// splits a round trip.
constexpr int kMergeWarps = 4;
constexpr int kMergeAhead = 32;

__global__ void __launch_bounds__(kMergeWarps * 32) paged_merge_kernel(
    const float* __restrict__ ws, float* __restrict__ out,
    const int* __restrict__ pos, int offset, int max_key, int n_items,
    int n_splits, int keys_per_split, int n_heads, int head_dim) {
  hp::grid_dependency_wait();  // the split kernel's partials are visible
  const int item = blockIdx.y;
  const int h = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= n_heads) return;
  const int hd = n_heads * head_dim;
  const float* acc = ws + (size_t)item * n_splits * hd + h * head_dim;
  const float* ml = ws + (size_t)n_items * n_splits * hd +
                    ((size_t)item * n_splits * n_heads + h) * 2;
  const size_t ml_step = 2 * (size_t)n_heads;
  const bool has0 = lane < head_dim, has1 = lane + 32 < head_dim;
  const int at = pos ? __ldcg(pos + item) : offset + item;
  const float m_ahead = lane < n_splits ? __ldcg(ml + lane * ml_step) : 0.f;
  const float l_ahead =
      lane < n_splits ? __ldcg(ml + lane * ml_step + 1) : 0.f;
  float a0[kMergeAhead], a1[kMergeAhead];
#pragma unroll
  for (int i = 0; i < kMergeAhead; ++i) {
    a0[i] = i < n_splits && has0 ? __ldcg(acc + (size_t)i * hd + lane) : 0.f;
    a1[i] =
        i < n_splits && has1 ? __ldcg(acc + (size_t)i * hd + lane + 32) : 0.f;
  }
  const int last = max(0, min(at, max_key));
  const int n_live = min(n_splits, last / keys_per_split + 1);
  float big = lane < n_live ? m_ahead : MMT_NEG_INF;
  for (int j = kMergeAhead + lane; j < n_live; j += 32)
    big = fmaxf(big, __ldcg(ml + j * ml_step));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    big = fmaxf(big, __shfl_xor_sync(MMT_FULL_MASK, big, o));
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int j0 = 0; j0 < n_live; j0 += kMergeAhead) {
    float mb = m_ahead, lb = l_ahead;
    if (j0 > 0) {  // the next kMergeAhead splits, their loads at once
      const bool ok = j0 + lane < n_live;
      mb = ok ? __ldcg(ml + (j0 + lane) * ml_step) : 0.f;
      lb = ok ? __ldcg(ml + (j0 + lane) * ml_step + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < kMergeAhead; ++i) {
        const float* a = acc + (size_t)(j0 + i) * hd + lane;
        a0[i] = j0 + i < n_live && has0 ? __ldcg(a) : 0.f;
        a1[i] = j0 + i < n_live && has1 ? __ldcg(a + 32) : 0.f;
      }
    }
    const bool live = j0 + lane < n_live;
    const float w = live ? exp2f(mb - big) : 0.f;
    const float lw = live ? lb : 0.f;
#pragma unroll
    for (int i = 0; i < kMergeAhead; ++i)
      if (j0 + i < n_live) {
        const float wi = __shfl_sync(MMT_FULL_MASK, w, i);
        l = fmaf(__shfl_sync(MMT_FULL_MASK, lw, i), wi, l);
        o0 = fmaf(a0[i], wi, o0);
        o1 = fmaf(a1[i], wi, o1);
      }
  }
  const float l_safe = fmaxf(l, MMT_L_FLOOR);
  float* oh = out + (size_t)item * hd + h * head_dim;
  if (has0) oh[lane] = o0 / l_safe;
  if (has1) oh[lane + 32] = o1 / l_safe;
}

}  // namespace

int mmt_launch_paged_merge(const float* ws, float* out, const int* pos,
                           int offset, int max_key, int n_items,
                           int n_splits, int keys_per_split, int n_heads,
                           int head_dim, cudaStream_t stream) {
  // a programmatic dependent launch: the grid may start while the split
  // kernel runs (after every block of it ran launch_dependents) and waits
  // in grid_dependency_wait for its partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_heads + kMergeWarps - 1) / kMergeWarps, n_items);
  cfg.blockDim = dim3(kMergeWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, paged_merge_kernel, ws, out, pos, offset, max_key, n_items,
      n_splits, keys_per_split, n_heads, head_dim);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// q (N, H, Dh); k_pages, v_pages (n_pages, page_size, H, Dh); tables
// (N, pages_per_slot) int32; pos (N,) int32; out (N, H, Dh); ws the split
// partials, N * n_splits * H * (Dh + 2) f32 (paged_split.cuh). All
// contiguous, all on the device, Dh <= 64; the lane is split into n_splits
// runs of pages_per_split pages. Launches the split kernel and the merge on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a head
// dim past 64, a split plan that does not cover the lane, or a shape whose
// stages do not fit shared memory).
extern "C" int mmt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* pos, void* out, void* ws, int n_slots,
    int n_heads, int head_dim, int page_size, int pages_per_slot,
    int pages_per_split, int n_splits, float scale, void* stream) {
  if (n_slots == 0 || n_heads == 0) return 0;
  if (head_dim < 1 || head_dim > kMmtMaxHeadDim || page_size < 1 ||
      pages_per_slot < 1 || pages_per_split < 1 ||
      (long)pages_per_split * n_splits < pages_per_slot)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.n_slots = n_slots;
  sh.n_heads = n_heads;
  sh.head_dim = head_dim;
  sh.page_size = page_size;
  sh.pages_per_slot = pages_per_slot;
  sh.pages_per_split = pages_per_split;
  sh.n_splits = n_splits;
  sh.chunk_rows = chunk_rows(page_size, n_heads * head_dim);
  const int chunks = pages_per_split *
                     ((page_size + sh.chunk_rows - 1) / sh.chunk_rows);
  sh.n_stages = chunks < kMaxStages ? chunks : kMaxStages;
  const int smem = smem_bytes(sh);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool raised = false;
  const cudaError_t rc = hp::allow_smem(paged_decode_split, kMaxSmem, raised);
  if (rc != cudaSuccess) return (int)rc;
  // whole chunks by bulk copy: every row's H * Dh floats start 16-byte
  // aligned (then every chunk's bytes are a multiple of 16)
  const bool aligned = (n_heads * head_dim) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  paged_decode_split<<<n_splits * n_slots, kThreads, smem, s>>>(
      (const float*)q, (const float*)k_pages, (const float*)v_pages,
      (const int*)tables, (const int*)pos, (float*)ws, sh,
      scale * hp::kLog2e, aligned);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return mmt_launch_paged_merge(
      (const float*)ws, (float*)out, (const int*)pos, 0,
      pages_per_slot * page_size - 1, n_slots, n_splits,
      pages_per_split * page_size, n_heads, head_dim, s);
}
