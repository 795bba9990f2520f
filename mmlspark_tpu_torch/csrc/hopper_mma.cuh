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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Zero `n` bf16 of shared memory (n a multiple of 8, 16-byte aligned).
__device__ __forceinline__ void zero_smem(bf16* p, int n) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace hopper
