// Prefix-prefill attention: the uncached suffix of a prompt against the
// slot's whole paged lane (shared prefix pages first, then its own), f32
// on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// paged_prefix_prefill_attention (kernel body _paged_prefix_kernel).
//
// What bounds it on the H100: for a short suffix (the decode path's prefix
// hits: 16 rows over 272 keys), latency: 1.2 MB of K and V is under half a
// microsecond of bytes, so what sets the time is how many blocks share the
// keys and how long each waits on its loads. For a long suffix (hit 256,
// S 768), operations, like K2 (flash_prefill_attention.cu) at S 1024.
//
// What the design does about it (K2's arithmetic, tf32_mma.cuh):
//   - QK^T and PV are mma.sync m16n8k8 tf32 products in 3xTF32 (split
//     operands, the small products first): f32 accuracy on the tensor
//     cores. The QK^T accumulator becomes PV's A operand in registers
//     (acc_to_a), V's rows read in that order;
//   - a block is 4 warps over one head and a query tile at virtual
//     positions hit_len + row: 16 rows whose warps take 8 keys each of every
//     32-key stage (KP = 4 key parts), or 32 rows in two 16-row groups whose
//     warps take one 32-key tile each of every 64-key stage (KP = 2, K2's
//     halves). A warp none of whose rows sees its first key skips the
//     stage. The parts merge by their maxima in a fixed order at the end;
//   - hit_len is a host int, so the host knows the live keys,
//     kv_end = min(lane, hit_len + S), and sizes the grid exactly
//     (cuda_attention.paged_prefix_plan): where heads x query tiles are too
//     few to fill the card, the live keys are split across blocks
//     (keys_per_split a multiple of a stage), each split writes its
//     partial (m, l, acc), and the merge of paged_split.cuh, launched by the
//     same C entry as a programmatic dependent launch, merges them in split
//     order. At S 16 over 272 keys that is 72 blocks of one 32-key stage
//     each, not 8 blocks walking all 9 tiles;
//   - stages of K and V come through a 2-stage cp.async ring by
//     16-byte copies (element copies where rows are not 16-byte aligned),
//     each row aimed through the block's run of table entries, which is
//     read once at the start. Rows are padded by 4 floats: both B-operand
//     reads are free of bank conflicts;
//   - stages past the query tile's last key or the split's end are never
//     loaded, so pages wholly past kv_end (every unclaimed, scratch-aimed
//     table entry among them) are never read; keys past the split's end
//     inside its last stage are staged as zeros without a read. Only keys
//     of a warp that holds one past some row's limit are masked, by select.
// Masking rule: the wrapper gets the bucketed S and no s_real, so a
// bucket's pad rows see keys up to hit_len + S - 1, as the plain version's
// do (their outputs are dropped; their K/V rows were written by the prefill
// itself). JAX clamps pad rows to the last real row instead
// (pallas_attention.py:1182-1188); both give the same real rows. Scores
// live in the log2 domain (scale * log2 e folded in). Every sum is taken
// in a fixed order: two launches give the same bits. Any Dh <= 64 (padded
// to 32 or 64 in shared memory), any page size.

#include "common.cuh"
#include "hopper_mma.cuh"
#include "paged_split.cuh"
#include "tf32_mma.cuh"

namespace {

namespace hp = hopper;

constexpr int kThreads = 128;   // 4 warps
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// keys a stage holds: 32 for 16-row tiles (KP 4), 64 for 32-row ones
// (KP 2: each warp one whole 32-key tile of the pair, as K2's halves)
template <int KP>
__host__ __device__ constexpr int stage_keys() {
  return KP == 4 ? 32 : 64;
}
// floats of the ring: K and V, kStages stages of rows of DP + 4
template <int DP, int KP>
__host__ __device__ constexpr int ring_floats() {
  return 2 * kStages * stage_keys<KP>() * (DP + 4);
}

template <int DP, int KP>
__global__ void __launch_bounds__(kThreads, 1) paged_prefix_tf32(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ table,
    float* __restrict__ out, float* __restrict__ ws, int seq, int n_heads,
    int head_dim, int page_size, int hit_len, int kv_end,
    int keys_per_split, int n_splits, float scale_log2, bool aligned) {
  constexpr int RG = 4 / KP;      // 16-row groups a block
  constexpr int QR = 16 * RG;     // query rows a block
  constexpr int kKeys = stage_keys<KP>();
  constexpr int NT = kKeys / (8 * KP);  // 8-key n-tiles a warp takes
  constexpr int LD = DP + 4;
  constexpr int kKS = DP / 8;     // k-steps of QK^T, n-tiles of PV
  constexpr int kTile = kKeys * LD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [stage][key][LD]
  float* vs = smem + kStages * kTile;
  int* tbl_s = reinterpret_cast<int*>(smem + ring_floats<DP, KP>());
  hp::launch_dependents();  // the merge may launch; it waits for this grid

  const int n_qt = (seq + QR - 1) / QR;
  const int h = blockIdx.x % n_heads;
  const int qt = n_qt - 1 - blockIdx.x / n_heads;  // the longest tiles first
  const int split = blockIdx.y;
  const int q0 = qt * QR;
  // the keys some row of the tile sees, and this split's share of them
  const int tile_end = min(kv_end, hit_len + min(seq, q0 + QR));
  const int k_lo = split * keys_per_split;
  const int k_hi = min(tile_end, k_lo + keys_per_split);
  if (k_lo >= k_hi) return;  // the merge reads no row of this block

  const size_t rs = (size_t)n_heads * head_dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / KP, part = warp % KP;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * grp + g, r1 = r0 + 8;
  // the last key each of the thread's rows sees in this split
  const int lim0 = min(hit_len + r0, k_hi - 1);
  const int lim1 = min(hit_len + r1, k_hi - 1);
  // and the least and the most of them over the warp's 16 rows
  const int lim_lo = min(hit_len + q0 + 16 * grp, k_hi - 1);
  const int lim_hi = min(hit_len + q0 + 16 * grp + 15, k_hi - 1);

  // the split's run of table entries, read once
  const int pg_lo = k_lo / page_size;
  const int n_pg = (k_hi - 1) / page_size - pg_lo + 1;
  for (int i = tid; i < n_pg; i += kThreads) tbl_s[i] = table[pg_lo + i];
  // columns [head_dim, DP) of every staged row stay zero
  if (head_dim < DP)
    for (int i = tid; i < 2 * kStages * kKeys * DP; i += kThreads) {
      const int row = i / DP, c = i % DP;
      if (c >= head_dim) smem[row * LD + c] = 0.f;
    }
  __syncthreads();

  const size_t head_off = (size_t)h * head_dim;
  // key j's row of this head in the pool (the element path's)
  auto row_at = [&](int j) -> size_t {
    return ((size_t)tbl_s[j / page_size - pg_lo] * page_size +
            j % page_size) * rs + head_off;
  };
  // stage u (keys k_lo + kKeys u ..); keys at or past k_hi land as zeros
  // and are not read
  auto stage = [&](int u) {
    float* kd = ks + (u % kStages) * kTile;
    float* vd = vs + (u % kStages) * kTile;
    const int j0 = k_lo + u * kKeys;
    if (aligned) {
      // this thread copies chunk c of rows r, r + kStep, ...: one division
      // finds the first row's page, the rest step through the table
      constexpr int kC = DP / 4;  // 16-byte chunks a padded row
      constexpr int kStep = kThreads / kC;
      const int c = tid % kC, r = tid / kC;
      int pg = (j0 + r) / page_size, at = j0 + r - pg * page_size;
      if (c < (head_dim >> 2)) {
#pragma unroll
        for (int i = 0; i < kKeys / kStep; ++i) {
          const int row = r + i * kStep;
          const bool ok = j0 + row < k_hi;
          const size_t off =
              ok ? ((size_t)tbl_s[pg - pg_lo] * page_size + at) * rs +
                       head_off + 4 * c
                 : 0;
          hp::cp_async16(kd + row * LD + 4 * c, k_pages + off, ok ? 16 : 0);
          hp::cp_async16(vd + row * LD + 4 * c, v_pages + off, ok ? 16 : 0);
          for (at += kStep; at >= page_size; at -= page_size) ++pg;
        }
      }
    } else {
      for (int idx = tid; idx < kKeys * DP; idx += kThreads) {
        const int r = idx / DP, c = idx % DP, j = j0 + r;
        if (c < head_dim) {
          const bool ok = j < k_hi;
          const size_t off = ok ? row_at(j) + c : 0;
          hp::cp_async4(kd + r * LD + c, k_pages + off, ok ? 4 : 0);
          hp::cp_async4(vd + r * LD + c, v_pages + off, ok ? 4 : 0);
        }
      }
    }
  };

  // the first stages stream in while the query loads
  const int n_tiles = (k_hi - k_lo + kKeys - 1) / kKeys;  // stages
  for (int u = 0; u < kStages - 1; ++u) {  // always kStages - 1 groups
    if (u < n_tiles) stage(u);
    hp::cp_commit();
  }

  // this warp's 16 query rows as split A fragments (rows past S: zeros),
  // their loads issued first
  uint32_t qb[kKS][4], qs[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * kk + t + 4 * (e >> 1), row = e & 1 ? r1 : r0;
      tf32::split(row < seq && col < head_dim
                      ? q[(size_t)row * rs + head_off + col]
                      : 0.f,
                  qb[kk][e], qs[kk][e]);
    }

  float o[kKS][4];
#pragma unroll
  for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = MMT_NEG_INF, m1 = MMT_NEG_INF;  // log2 domain
  float l0 = 0.f, l1 = 0.f;                  // this thread's columns only

  for (int u = 0; u < n_tiles; ++u) {
    if (u + kStages - 1 < n_tiles) stage(u + kStages - 1);
    hp::cp_commit();
    hp::cp_wait<kStages - 1>();
    __syncthreads();
    const float* kt = ks + (u % kStages) * kTile;
    const float* vt = vs + (u % kStages) * kTile;
    const int j0 = k_lo + u * kKeys;
    // this warp's keys: NT n-tiles of 8 from key jw (warp-uniform skip
    // where no row of the warp sees the first of them)
    const int jw = j0 + 8 * NT * part;
    if (jw <= lim_hi) {
      // S = Q K^T over this warp's NT n-tiles of 8 keys
      float sb[NT][4], sc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[i][e] = sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float* kr =
              kt + (8 * (part * NT + i) + g) * LD + 8 * kk + t;
          uint32_t bb[2], bs[2];
          tf32::split(kr[0], bb[0], bs[0]);
          tf32::split(kr[4], bb[1], bs[1]);
          tf32::mma(sc[i], qs[kk], bb);
          tf32::mma(sc[i], qb[kk], bs);
          tf32::mma(sb[i], qb[kk], bb);
        }
      // online softmax; only where a key lies past some row's limit is the
      // tile masked (warp-uniform)
      const bool masked = jw + 8 * NT - 1 > lim_lo;
      float mx0 = MMT_NEG_INF, mx1 = MMT_NEG_INF;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jw + 8 * i + 2 * t + (e & 1);
          const bool vis = !masked || j <= (e < 2 ? lim0 : lim1);
          const float x =
              vis ? (sc[i][e] + sb[i][e]) * scale_log2 : MMT_NEG_INF;
          sb[i][e] = x;
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
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jw + 8 * i + 2 * t + (e & 1);
          const bool vis = !masked || j <= (e < 2 ? lim0 : lim1);
          const float p =
              vis ? hp::exp2_approx(sb[i][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          sb[i][e] = p;
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
      for (int dt = 0; dt < kKS; ++dt) {
        o[dt][0] *= al0;
        o[dt][1] *= al0;
        o[dt][2] *= al1;
        o[dt][3] *= al1;
      }
      // O += P V: k-step i is keys 8 nt .. 8 nt + 7 in acc_to_a's order
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t pb[4], pq[4];
        tf32::acc_to_a(sb[i], pb, pq);
#pragma unroll
        for (int dt = 0; dt < kKS; ++dt) {
          const float* vr =
              vt + (8 * (part * NT + i) + 2 * t) * LD + 8 * dt + g;
          uint32_t bb[2], bs[2];
          tf32::split(vr[0], bb[0], bs[0]);
          tf32::split(vr[LD], bb[1], bs[1]);
          tf32::mma3(o[dt], pb, pq, bb, bs);
        }
      }
    }
    __syncthreads();  // the stage is free for stage u + kStages
  }
  hp::cp_wait_all();

  // merge key parts 1 .. KP - 1 into part 0, in that order
  l0 = hp::quad_sum(l0);
  l1 = hp::quad_sum(l1);
  constexpr int kV = 4 + 4 * kKS;  // floats a thread hands over
  float* xch = smem;               // [part - 1][grp][kV][32]
  if (part > 0) {
    float* x = xch + ((part - 1) * RG + grp) * kV * 32 + lane;
    x[0] = m0;
    x[32] = m1;
    x[64] = l0;
    x[96] = l1;
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 + 4 * dt + e) * 32] = o[dt][e];
  }
  __syncthreads();
  if (part > 0) return;
  float big0 = m0, big1 = m1;
#pragma unroll
  for (int p = 1; p < KP; ++p) {
    const float* x = xch + ((p - 1) * RG + grp) * kV * 32 + lane;
    big0 = fmaxf(big0, x[0]);
    big1 = fmaxf(big1, x[32]);
  }
  {
    const float w0 = hp::exp2_approx(m0 - big0);
    const float w1 = hp::exp2_approx(m1 - big1);
    l0 *= w0;
    l1 *= w1;
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt) {
      o[dt][0] *= w0;
      o[dt][1] *= w0;
      o[dt][2] *= w1;
      o[dt][3] *= w1;
    }
  }
#pragma unroll
  for (int p = 1; p < KP; ++p) {
    const float* x = xch + ((p - 1) * RG + grp) * kV * 32 + lane;
    const float w0 = hp::exp2_approx(x[0] - big0);
    const float w1 = hp::exp2_approx(x[32] - big1);
    l0 = fmaf(x[64], w0, l0);
    l1 = fmaf(x[96], w1, l1);
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = fmaf(x[(4 + 4 * dt + e) * 32], e < 2 ? w0 : w1, o[dt][e]);
  }

  if (n_splits == 1) {  // the whole lane: normalize and store
    const float ls0 = fmaxf(l0, MMT_L_FLOOR), ls1 = fmaxf(l1, MMT_L_FLOOR);
    float* o0 = out + (size_t)r0 * rs + head_off;
    float* o1 = out + (size_t)r1 * rs + head_off;
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * dt + 2 * t + (e & 1);
        if (col >= head_dim) continue;
        if (e < 2) {
          if (r0 < seq) o0[col] = o[dt][e] / ls0;
        } else if (r1 < seq) {
          o1[col] = o[dt][e] / ls1;
        }
      }
    return;
  }
  // the split's partial (paged_split.cuh's layout), items are rows
  float* ml = ws + (size_t)seq * n_splits * rs;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= seq) continue;
    const size_t at = ((size_t)r * n_splits + split) * n_heads + h;
    float* wa = ws + at * head_dim;
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * dt + 2 * t + e;
        if (col < head_dim) wa[col] = o[dt][2 * half + e];
      }
    if (t == 0) {
      ml[2 * at] = half ? big1 : big0;
      ml[2 * at + 1] = half ? l1 : l0;
    }
  }
}

template <int DP, int KP>
int launch(const float* q, const float* kp, const float* vp, const int* tbl,
           float* out, float* ws, int seq, int n_heads, int head_dim,
           int page_size, int pages_per_slot, int hit_len, int kv_end,
           int keys_per_split, int n_splits, float scale,
           cudaStream_t stream) {
  // the table entries a block's keys span (at most pages_per_slot)
  const int span = min(keys_per_split, kv_end);
  const int n_tbl = min(pages_per_slot, span / page_size + 2);
  const int smem = ring_floats<DP, KP>() * (int)sizeof(float) +
                   n_tbl * (int)sizeof(int);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool raised = false;
  const cudaError_t rc =
      hp::allow_smem(paged_prefix_tf32<DP, KP>, kMaxSmem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const bool aligned = head_dim % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  constexpr int kRows = 16 * (4 / KP);
  const dim3 grid(n_heads * ((seq + kRows - 1) / kRows), n_splits);
  paged_prefix_tf32<DP, KP><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, tbl, out, ws, seq, n_heads, head_dim, page_size, hit_len,
      kv_end, keys_per_split, n_splits, scale * hp::kLog2e, aligned);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return mmt_launch_paged_merge(ws, out, nullptr, hit_len, kv_end - 1, seq,
                                n_splits, keys_per_split, n_heads, head_dim,
                                stream);
}

}  // namespace

// q, out (S, H, Dh); k_pages, v_pages (n_pages, page_size, H, Dh); table
// (pages_per_slot,) int32; ws the split partials, S * n_splits * H *
// (Dh + 2) f32 (paged_split.cuh; unused, may be null, when n_splits is 1).
// Contiguous f32/int32 on the device, Dh <= 64. The plan: query tiles of
// rows_per_tile (16 or 32) rows, live keys [0, min(lane, hit_len + S)) in
// n_splits runs of keys_per_split (a multiple of a stage's keys,
// 2 * rows_per_tile). Launches the kernel,
// and the merge where n_splits > 1, on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a head dim past 64 or a plan that does not
// cover the live keys).
extern "C" int mmt_paged_prefix_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, void* out, void* ws, int seq, int n_heads,
    int head_dim, int page_size, int pages_per_slot, int hit_len,
    int rows_per_tile, int keys_per_split, int n_splits, float scale,
    void* stream) {
  if (seq == 0 || n_heads == 0) return 0;
  const int kv_end = min(pages_per_slot * page_size, hit_len + seq);
  if (head_dim < 1 || head_dim > kMmtMaxHeadDim || page_size < 1 ||
      kv_end < 1 || keys_per_split < 2 * rows_per_tile ||
      keys_per_split % (2 * rows_per_tile) ||
      n_splits < 1 || (long)keys_per_split * n_splits < kv_end ||
      (n_splits > 1 && ws == nullptr) ||
      (rows_per_tile != 16 && rows_per_tile != 32))
    return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k_pages,
              *vf = (const float*)v_pages;
  const int* tf = (const int*)table;
  float *of = (float*)out, *wf = (float*)ws;
  cudaStream_t s = (cudaStream_t)stream;
#define MMT_K3(DP, KP)                                                     \
  launch<DP, KP>(qf, kf, vf, tf, of, wf, seq, n_heads, head_dim, page_size, \
                 pages_per_slot, hit_len, kv_end, keys_per_split, n_splits, \
                 scale, s)
  if (head_dim <= 32) return rows_per_tile == 16 ? MMT_K3(32, 4) : MMT_K3(32, 2);
  return rows_per_tile == 16 ? MMT_K3(64, 4) : MMT_K3(64, 2);
#undef MMT_K3
}
