// Causal flash attention for the cold prefill (forward, normalized), f32
// on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel mmlspark_tpu/parallel/pallas_attention.py
// flash_prefill_attention -> flash_attention forward (_flash_fwd ->
// _flash_call -> _flash_kernel), as the prefill builders call it.
//
// What bounds it on the H100: operations. A causal prompt of S rows does
// 4 Dh S (S + 1) / 2 FLOPs a head against 16 bytes a row and channel of q,
// k, v and out; in 3xTF32 that is three tf32 products per f32 one (495
// TFLOP/s dense). At the decoder's prompt lengths (S 512, 8 heads x 64) the
// work is small, so what sets the time is the latency of the longest query
// tile's walk over its keys, and filling the card.
//
// What the design does about it (tf32_mma.cuh has the fragments):
//   - QK^T and PV are mma.sync m16n8k8 tf32 products in 3xTF32 (each f32
//     operand split into a tf32 big and small part, three products
//     summed, the small ones first): f32 accuracy on the tensor cores.
//     mma.sync rather than wgmma: tf32 wgmma takes both operands K-major
//     only, so V would have to be staged transposed, and a block of 64
//     query rows (wgmma's M) leaves half the card idle at S 512;
//   - a block is 32 query rows of one (batch, head), 4 warps: warps 0 and
//     1 hold 16 rows each over the even key tiles, warps 2 and 3 the same
//     rows over the odd ones, and the two halves merge by their maxima in
//     a fixed order at the end. So the longest tile walks half its keys,
//     4 warps fill an SM's 4 schedulers, and at S 512, 8 heads the grid
//     is 128 blocks. Blocks are numbered longest tile first;
//   - 32-key tiles of K and V come through a 2-stage cp.async ring (a
//     stage holds one tile for each half), 16-byte copies where rows are
//     16-byte aligned (head_dim % 4 == 0), element copies elsewhere. Rows
//     are padded by 4 floats, which makes both B-operand reads free of bank
//     conflicts. A tile past the query tile's diagonal is never loaded;
//     keys past S are staged as zeros;
//   - the QK^T accumulator becomes PV's A operand in registers (k
//     permuted, tf32_mma.cuh acc_to_a), with V's rows read in that order;
//   - online softmax in f32 with exp2 (scale * log2 e folded into the
//     scores); only the diagonal tile is masked (keys past S lie past
//     every live row's diagonal there). Output acc / max(l, 1e-30).
// Any S >= 1 and any Dh <= 64 run unpadded in device memory: Dh is padded
// with zeros to 32 or 64 in shared memory (an instance for 16 spilled 8
// bytes), and rows past S compute on zeros and are never stored. Every sum
// is taken in a fixed order: two launches give the same bits.

#include "common.cuh"
#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace {

namespace hp = hopper;

constexpr int kRows = 32;     // query rows a block
constexpr int kKeys = 32;     // keys a tile
constexpr int kThreads = 128; // 2 row warps x 2 key halves
constexpr int kStages = 2;

// floats of dynamic shared memory: K and V, kStages x 2 halves x kKeys
// rows of DP + 4
template <int DP>
constexpr int smem_floats() {
  return 2 * kStages * 2 * kKeys * (DP + 4);
}

// Stage u of the ring: key tiles 2u (half 0) and 2u + 1 (half 1) of one
// (batch, head) slice, each only where it is not past tile `qt` (the
// diagonal). Rows past `seq` land as zeros; columns past head_dim are never
// written.
template <int DP>
__device__ __forceinline__ void stage_pair(float* ks, float* vs,
                                           const float* __restrict__ kb,
                                           const float* __restrict__ vb,
                                           size_t rs, int u, int qt, int seq,
                                           int head_dim, bool aligned) {
  constexpr int LD = DP + 4;
  if (aligned) {
    constexpr int kC = DP / 4;  // 16-byte chunks a padded row
    const int chunks = head_dim >> 2;
#pragma unroll
    for (int i = 0; i < 2 * kKeys * kC / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int hf = idx / (kKeys * kC), r = (idx / kC) % kKeys,
                c = idx % kC;
      const int kt = 2 * u + hf, j = kt * kKeys + r;
      if (kt <= qt && c < chunks) {
        const bool ok = j < seq;
        const size_t off = ok ? (size_t)j * rs + 4 * c : 0;
        const int at = (hf * kKeys + r) * LD + 4 * c;
        hp::cp_async16(ks + at, kb + off, ok ? 16 : 0);
        hp::cp_async16(vs + at, vb + off, ok ? 16 : 0);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * kKeys * DP; idx += kThreads) {
      const int hf = idx / (kKeys * DP), r = (idx / DP) % kKeys,
                c = idx % DP;
      const int kt = 2 * u + hf, j = kt * kKeys + r;
      if (kt <= qt && c < head_dim) {
        const bool ok = j < seq;
        const size_t off = ok ? (size_t)j * rs + c : 0;
        const int at = (hf * kKeys + r) * LD + c;
        hp::cp_async4(ks + at, kb + off, ok ? 4 : 0);
        hp::cp_async4(vs + at, vb + off, ok ? 4 : 0);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_prefill_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int seq,
    int n_heads, int head_dim, float scale_log2, bool aligned) {
  constexpr int LD = DP + 4;
  constexpr int kKS = DP / 8;            // k-steps of QK^T, n-tiles of PV
  constexpr int kTile = kKeys * LD;      // floats a staged tile
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [stage][half][key][LD]
  float* vs = smem + kStages * 2 * kTile;

  const int n_qt = (seq + kRows - 1) / kRows;
  const int qt = n_qt - 1 - blockIdx.y;  // the longest tiles first
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const size_t rs = (size_t)n_heads * head_dim;
  const size_t base = (size_t)b * seq * rs + (size_t)h * head_dim;
  const float* kb = k + base;
  const float* vb = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 1;            // key tiles 2u + half
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * kRows + (warp & 1) * 16 + g, r1 = r0 + 8;

  // columns [head_dim, DP) of every staged row stay zero
  for (int i = threadIdx.x; i < 2 * kStages * 2 * kKeys * DP;
       i += kThreads) {
    const int row = i / DP, c = i % DP;
    if (c >= head_dim) smem[row * LD + c] = 0.f;
  }

  // this warp's 16 query rows as split A fragments (rows past S: zeros)
  uint32_t qb[kKS][4], qs[kKS][4];
  {
    const float* q0 = q + base + (size_t)r0 * rs;
    const float* q1 = q + base + (size_t)r1 * rs;
    const bool l0 = r0 < seq, l1 = r1 < seq;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const int c0 = 8 * kk + t, c1 = c0 + 4;
      tf32::split((l0 && c0 < head_dim) ? q0[c0] : 0.f, qb[kk][0],
                  qs[kk][0]);
      tf32::split((l1 && c0 < head_dim) ? q1[c0] : 0.f, qb[kk][1],
                  qs[kk][1]);
      tf32::split((l0 && c1 < head_dim) ? q0[c1] : 0.f, qb[kk][2],
                  qs[kk][2]);
      tf32::split((l1 && c1 < head_dim) ? q1[c1] : 0.f, qb[kk][3],
                  qs[kk][3]);
    }
  }

  float o[kKS][4];
#pragma unroll
  for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = MMT_NEG_INF, m1 = MMT_NEG_INF;  // log2 domain
  float l0 = 0.f, l1 = 0.f;                  // this thread's columns only

  const int n_u = (qt + 2) / 2;  // stages: key tiles 0 .. qt in pairs
  stage_pair<DP>(ks, vs, kb, vb, rs, 0, qt, seq, head_dim, aligned);
  hp::cp_commit();
  for (int u = 0; u < n_u; ++u) {
    const int st = u & 1;
    if (u + 1 < n_u)
      stage_pair<DP>(ks + (st ^ 1) * 2 * kTile, vs + (st ^ 1) * 2 * kTile,
                     kb, vb, rs, u + 1, qt, seq, head_dim, aligned);
    hp::cp_commit();
    hp::cp_wait<1>();
    __syncthreads();
    const int kt = 2 * u + half;
    if (kt <= qt) {  // warp-uniform
      const float* kt_s = ks + (st * 2 + half) * kTile;
      const float* vt_s = vs + (st * 2 + half) * kTile;
      // S = Q K^T over the tile's 32 keys: 4 n-tiles of 8 keys; the big
      // product and the two small ones in their own accumulators
      float sb[4][4], sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[nt][e] = sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* kr = kt_s + (8 * nt + g) * LD + 8 * kk + t;
          uint32_t bb[2], bs[2];
          tf32::split(kr[0], bb[0], bs[0]);
          tf32::split(kr[4], bb[1], bs[1]);
          tf32::mma(sc[nt], qs[kk], bb);
          tf32::mma(sc[nt], qb[kk], bs);
          tf32::mma(sb[nt], qb[kk], bb);
        }
      // online softmax; only the diagonal tile is masked
      const bool diag = kt == qt;
      float mx0 = MMT_NEG_INF, mx1 = MMT_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt * kKeys + 8 * nt + 2 * t + (e & 1);
          const bool vis = !diag || j <= (e < 2 ? r0 : r1);
          const float x =
              vis ? (sc[nt][e] + sb[nt][e]) * scale_log2 : MMT_NEG_INF;
          sb[nt][e] = x;
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
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt * kKeys + 8 * nt + 2 * t + (e & 1);
          const bool vis = !diag || j <= (e < 2 ? r0 : r1);
          const float p =
              vis ? hp::exp2_approx(sb[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          sb[nt][e] = p;
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
      // O += P V: k-step nt is keys 8 nt .. 8 nt + 7 in acc_to_a's order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t pb[4], pq[4];
        tf32::acc_to_a(sb[nt], pb, pq);
#pragma unroll
        for (int dt = 0; dt < kKS; ++dt) {
          const float* vr = vt_s + (8 * nt + 2 * t) * LD + 8 * dt + g;
          uint32_t bb[2], bs[2];
          tf32::split(vr[0], bb[0], bs[0]);
          tf32::split(vr[LD], bb[1], bs[1]);
          tf32::mma3(o[dt], pb, pq, bb, bs);
        }
      }
    }
    __syncthreads();  // stage st is free for tile pair u + 2
  }
  hp::cp_wait_all();

  // merge the odd-tile half into the even-tile half, in that order
  l0 = hp::quad_sum(l0);
  l1 = hp::quad_sum(l1);
  constexpr int kX = 64;  // threads a half
  const int pt = threadIdx.x % kX;
  float* xch = smem;      // [4 + 4 kKS][kX]: m0, m1, l0, l1, o
  if (half == 1) {
    xch[0 * kX + pt] = m0;
    xch[1 * kX + pt] = m1;
    xch[2 * kX + pt] = l0;
    xch[3 * kX + pt] = l1;
#pragma unroll
    for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 + 4 * dt + e) * kX + pt] = o[dt][e];
  }
  __syncthreads();
  if (half == 1) return;
  const float mb0 = xch[0 * kX + pt], mb1 = xch[1 * kX + pt];
  const float m_0 = fmaxf(m0, mb0), m_1 = fmaxf(m1, mb1);
  const float ca0 = hp::exp2_approx(m0 - m_0);
  const float cb0 = hp::exp2_approx(mb0 - m_0);
  const float ca1 = hp::exp2_approx(m1 - m_1);
  const float cb1 = hp::exp2_approx(mb1 - m_1);
  const float ls0 = fmaxf(l0 * ca0 + xch[2 * kX + pt] * cb0, MMT_L_FLOOR);
  const float ls1 = fmaxf(l1 * ca1 + xch[3 * kX + pt] * cb1, MMT_L_FLOOR);
  float* o0 = out + base + (size_t)r0 * rs;
  float* o1 = out + base + (size_t)r1 * rs;
#pragma unroll
  for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * dt + 2 * t + (e & 1);
      const float ob = xch[(4 + 4 * dt + e) * kX + pt];
      if (col >= head_dim) continue;
      if (e < 2) {
        if (r0 < seq) o0[col] = (o[dt][e] * ca0 + ob * cb0) / ls0;
      } else if (r1 < seq) {
        o1[col] = (o[dt][e] * ca1 + ob * cb1) / ls1;
      }
    }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out,
           int batch, int seq, int n_heads, int head_dim, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = smem_floats<DP>() * (int)sizeof(float);
  static bool raised = false;
  const cudaError_t rc = hp::allow_smem(flash_prefill_tf32<DP>, kSmem, raised);
  if (rc != cudaSuccess) return (int)rc;
  const bool aligned = head_dim % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(batch * n_heads, (seq + kRows - 1) / kRows);
  flash_prefill_tf32<DP><<<grid, kThreads, kSmem, stream>>>(
      q, k, v, out, seq, n_heads, head_dim, scale * hp::kLog2e, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, S, H, Dh), contiguous f32 on the device, Dh <= 64;
// launched on `stream`. Returns cudaGetLastError() (cudaErrorInvalidValue
// for a head_dim the kernel has no instance for).
extern "C" int mmt_flash_prefill_attention(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int seq, int n_heads,
                                           int head_dim, float scale,
                                           void* stream) {
  if (batch == 0 || seq == 0 || n_heads == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim < 1 || head_dim > kMmtMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  if (head_dim <= 32)
    return launch<32>(qf, kf, vf, of, batch, seq, n_heads, head_dim, scale, s);
  return launch<64>(qf, kf, vf, of, batch, seq, n_heads, head_dim, scale, s);
}
