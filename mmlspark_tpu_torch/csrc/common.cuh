// Helpers shared by the port's kernels.
//
// Inputs come in f32 or bf16 (__nv_bfloat16); every kernel computes in f32
// and rounds to the input type only where the JAX kernels cast. The
// attention numerics follow the JAX package's Pallas kernels: masked
// scores take the -1e30 sentinel, the running max/normalizer/accumulator
// are updated once per key tile (m_new = max(m, max s); p = exp(s - m_new)
// on visible keys, 0 elsewhere; alpha = exp(m - m_new)), and the output
// is acc / max(l, 1e-30). Only the order of the f32 sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MMT_NEG_INF (-1e30f)
#define MMT_L_FLOOR (1e-30f)
#define MMT_FULL_MASK 0xffffffffu

// the largest head dim the kernels are instantiated for
constexpr int kMmtMaxHeadDim = 64;

// dtype codes of the C interface
constexpr int kMmtF32 = 0;
constexpr int kMmtBF16 = 1;

// Store an f32 value as T (round to nearest even for bf16).
__device__ __forceinline__ void mmt_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void mmt_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
