// Hopper building blocks for the port's tensor-core kernels (sm_90a).
//
// A warpgroup (4 warps, 128 threads) issues wgmma.mma_async m64n64k16 in
// bf16 with f32 sums: A is a 64 x 16 slice from shared memory or from
// registers, B a 16 x 64 slice from shared memory, D a 64 x 64 f32
// accumulator held as 32 floats a thread. Shared tiles are 64 rows of 64
// bf16 (128 bytes a row) in the 128-byte swizzle, which is the layout the
// wgmma descriptor names and the one the cp.async ring writes: 16-byte
// chunk c of row r lives at chunk c ^ (r % 8), so the 8 rows of one
// 1024-byte atom hit 8 different banks for any chunk. Tiles start
// 1024-byte aligned.
//
// Fragments (PTX ISA, "wgmma register fragments"): accumulator element v
// (0..31) of thread t = 32 w + l lies at row 16 w + l / 4 + 8 ((v >> 1) & 1)
// and column 8 (v >> 2) + 2 (l % 4) + (v & 1). The register A operand of
// a k-slice kk (columns 16 kk .. 16 kk + 15 of the same 64-row matrix) is
// then the accumulator's elements 8 kk .. 8 kk + 7, packed in pairs: a
// 64 x 64 f32 result becomes the bf16 A operand of the next product
// without leaving the thread (acc_to_a).
//
// K7's kernels fill their tiles with cp.async (stage_tile) and take
// m64n64k16. The fused CE's kernels take a wider B (m64n128k16,
// m64n256k16 over consecutive tiles) and fill their rings with TMA: one
// thread copies (rows, 64) boxes, which land as stacked swizzled tiles,
// onto an mbarrier a stage (tma_map on the host, tma_load, mbar_*).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;                      // rows of a shared tile
constexpr int kTileCols = 64;                      // bf16 per row: 128 bytes
constexpr int kTileElems = kTileRows * kTileCols;  // 8 KB a tile
constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after `raw` (dynamic shared
// memory is only 16-byte aligned; ask for 1 KB more than the tiles).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// Element offset of (row r, column c) in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTileCols + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// ---------------------------------------------------------------------------
// wgmma descriptors and synchronisation

// A 128-byte-swizzled tile's descriptor: start address >> 4, the 8-row
// group stride (1024 bytes) as both the leading and the stride byte
// offset, layout 1 (128B swizzle). One descriptor serves both majors: a
// K-major operand (rows are M or N, 64 K values along each row) steps to
// its next k16 slice by 32 bytes (+2 in the start field, the swizzle is
// applied to the address bits), an MN-major one (rows are K, read with
// the transpose flag) by 16 rows (+128). The leading offset is the MN
// repeat of a transposed operand (unused: a row is one 64-wide atom) and
// is ignored for a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc(const bf16* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)64 << 16) | ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}
// An MN-major operand wider than one 64-column atom: consecutive tiles
// (8 KB apart) hold its 64-column atoms, so the leading byte offset, the
// MN repeat, is one tile; the 8-row K groups stay 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(kTileElems * 2 / 16) << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
constexpr uint64_t kKStep = 2;     // +32 bytes: the next k16 slice, K-major
constexpr uint64_t kRowStep = 128;  // +16 rows: the next k16 slice, MN-major

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers in place around wgmma: the compiler may not move their
// reads or writes across this point (the asynchronous product owns them
// between its issue and wg_wait_all).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B, A and B from shared memory, both K-major; accumulate when
// `acc`, else overwrite.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, A from registers (acc_to_a), B from shared memory MN-major
// (rows of the tile are K: the transpose flag).
__device__ __forceinline__ void mma_rs_t(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d = A B over a 64-wide K: four k16 slices of two K-major tiles.
__device__ __forceinline__ void mma_ss_k64(float (&d)[32], const bf16* a,
                                           const bf16* b) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss(d, da + kk * kKStep, db + kk * kKStep, kk > 0);
}

// d += A B over a wider B, both from shared memory: m64n128k16 and
// m64n256k16. kTransA = 1 reads A MN-major (the tile's rows are K, its 64
// columns M, a k16 slice 16 rows: kRowStep; bf16 allows the flag for A in
// shared memory), kTransB = 1 reads B MN-major as mma_rs_t does; 0 is
// K-major (kKStep). D = 64 x N f32 is held as N / 2 floats a thread in the
// fragment order above (element v at column 8 (v >> 2) + 2 (l % 4) +
// (v & 1)), so a float[N / 64][32] array of 64-column accumulators is the
// same registers in the same order (flat). B spans N / 64 consecutive
// tiles: K-major, they stack as rows (desc); MN-major, as 64-column atoms
// 8 KB apart (desc_mn).
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, 1, 1, 1, %130, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTransA), "n"(kTransB));
}

// A float[N][32] set of 64-column accumulators as the one array a wider
// product takes (the same registers, in order).
template <int N>
__device__ __forceinline__ auto& flat(float (&a)[N][32]) {
  return reinterpret_cast<float(&)[N * 32]>(a);
}

// d += A B over a 64-wide K: A the four k16 slices in registers, B a
// tile read MN-major.
__device__ __forceinline__ void mma_rs_k64(float (&d)[32],
                                           const uint32_t (&a)[16],
                                           const bf16* b) {
  const uint64_t db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    mma_rs_t(d, ak, db + kk * kRowStep);
  }
}

// ---------------------------------------------------------------------------
// fragments

// accumulator element v: its row (0..63) and column (0..63) in the tile
__device__ __forceinline__ int acc_row(int v) {
  const int t = threadIdx.x % kWarpgroup;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int v) {
  return 8 * (v >> 2) + 2 * (threadIdx.x & 3) + (v & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator rounded to bf16 as the register A operand of
// the next product (K = the accumulator's columns).
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// Max and sum over the 4 threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// very negative x).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the cp.async ring

// 16 bytes global -> shared; src_bytes 0 writes zeros (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's newest cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's finished shared-memory writes (cp.async, stores)
// visible to wgmma, which reads shared memory through the async proxy;
// a __syncthreads after it publishes them to the whole warpgroup.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of one (batch, head) slice of a [B, S, H, Dh] bf16
// tensor (row j at x + j * row_stride; rows at or past `end` as zeros)
// into a swizzled tile, columns [0, head_dim). Columns past head_dim are
// never written: zero the tile once. `aligned` (head_dim % 8 == 0 and x
// 16-byte aligned): one cp.async per 16 bytes, left in flight for the
// caller's cp_commit; else synchronous element loads.
__device__ __forceinline__ void stage_tile(bf16* tile,
                                           const bf16* __restrict__ x,
                                           size_t row_stride, int r0, int end,
                                           int head_dim, bool aligned) {
  const int tid = threadIdx.x % kWarpgroup;
  if (aligned) {
    const int chunks = head_dim >> 3;
#pragma unroll
    for (int i = 0; i < kTileRows * 8 / kWarpgroup; ++i) {
      const int idx = tid + i * kWarpgroup, r = idx >> 3, c = idx & 7;
      if (c < chunks) {
        const int j = r0 + r;
        const bool ok = j < end;
        cp_async16(tile + swz(r, c * 8),
                   ok ? x + (size_t)j * row_stride + c * 8 : x, ok ? 16 : 0);
      }
    }
  } else {
    for (int idx = tid; idx < kTileRows * head_dim; idx += kWarpgroup) {
      const int r = idx / head_dim, c = idx - r * head_dim;
      const int j = r0 + r;
      tile[swz(r, c)] =
          j < end ? x[(size_t)j * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of a row-major bf16 matrix
// (row j at x + j * ld) into a swizzled tile by synchronous element loads,
// by all kThreads threads of the block; rows at or past r_end and columns
// at or past c_end become zeros, so every element of the tile is written.
// The path for rows that TMA cannot copy (not 16-byte aligned).
template <int kThreads>
__device__ __forceinline__ void stage_block(bf16* tile,
                                            const bf16* __restrict__ x,
                                            size_t ld, int r0, int r_end,
                                            int c0, int c_end) {
  for (int idx = threadIdx.x; idx < kTileElems; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63, j = r0 + r, col = c0 + c;
    tile[swz(r, c)] = (j < r_end && col < c_end) ? x[(size_t)j * ld + col]
                                                 : __float2bfloat16(0.f);
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies whole tiles, in the 128-byte swizzle, and the
// copies complete on an mbarrier in shared memory

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// After the inits, before any thread uses the barriers (then a
// __syncthreads).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The issuing thread's arrival, and the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase of this parity has completed: the copies
// it counted are then visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// The box of `map` at column x, row y into `dst` (1024-byte aligned),
// completing on `bar`; elements outside the matrix arrive as zeros.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// 1-D bulk copy of `bytes` contiguous bytes from global `src` into `dst`,
// completing on `bar` (dst, src 16-byte aligned; bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: a grid launched with
// cudaLaunchAttributeProgrammaticStreamSerialization behind this one may
// start once every block of this grid has run launch_dependents (or
// exited); its threads wait in grid_dependency_wait until this grid has
// completed and its memory is visible. Both are no-ops without the
// attribute.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Host: a (rows, cols) row-major bf16 matrix as a TMA map of (box_rows,
// 64) boxes in the 128-byte swizzle, so a box lands as box_rows / 64
// stacked swizzled tiles. False where TMA cannot take the layout (rows not
// 16-byte aligned) or cuTensorMapEncodeTiled cannot be found: the caller
// then stages by element loads.
inline bool tma_map(CUtensorMap* map, const void* base, int rows, int cols,
                    int box_rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % 8) return false;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTileCols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// the attention kernels' epilogue and launch helpers (K7, K8)

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [0, rows) and columns [0, head_dim) of a 64 x 64 accumulator, each
// value times its row's factor f (the thread's two rows), to row r at
// base + r * row_stride. `vec`: head_dim % 8 == 0 and base 16-byte
// aligned, so each thread's column pairs are stored whole.
template <typename OutT>
__device__ __forceinline__ void store_acc(OutT* base, size_t row_stride,
                                          const float (&d)[32],
                                          const float (&f)[2], int rows,
                                          int head_dim, bool vec) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = acc_row(e), c = acc_col(e);
    const float fr = f[(e >> 1) & 1];
    if (r >= rows || c >= head_dim) continue;
    OutT* p = base + (size_t)r * row_stride + c;
    if (vec) {
      store2(p, d[e] * fr, d[e + 1] * fr);
    } else {
      mmt_store(p, d[e] * fr);
      if (c + 1 < head_dim) mmt_store(p + 1, d[e + 1] * fr);
    }
  }
}

// One (batch, head) slice's row 0 of a [B, S, H, Dh] tensor.
template <typename T>
__device__ __forceinline__ T* slice(T* x, int b, int h, int s, size_t rs,
                                    int head_dim) {
  return x + (size_t)b * s * rs + (size_t)h * head_dim;
}

// Host: raise a kernel's dynamic shared memory limit past the default
// 48 KB (once per kernel; a second call in a race sets the same value).
// Returns the call's error; `done` is set only once it succeeded.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = rc == cudaSuccess;
  return rc;
}

// Host: the cp.async path's condition (stage_tile's `aligned`, store_acc's
// `vec`): every row starts 16-byte aligned.
inline bool rows_aligned(int head_dim,
                         std::initializer_list<const void*> ptrs) {
  if (head_dim % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Zero `n` bf16 of shared memory (n a multiple of 8, 16-byte aligned).
__device__ __forceinline__ void zero_smem(bf16* p, int n) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace hopper
