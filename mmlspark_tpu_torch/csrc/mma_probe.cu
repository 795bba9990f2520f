// A probe, not a kernel of the port: how fast this card runs
// mma.sync.m16n8k8 tf32 (tf32_mma.cuh's product), the instruction every
// 3xTF32 kernel here (K2, K3, the f32 routes of K4 and K6) is built on.
// The data sheet's 495 TFLOP/s TF32 is the rate of wgmma; mma.sync is the
// older warp-level path. Each warp issues kAcc independent products per
// step, the same A and B each time, so nothing but the tensor pipe bounds
// it. chip_smoke.py times it beside the f32 CE kernels.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kAcc = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mma_tf32_probe(float* out,
                                                           int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float d[kAcc][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) tf32::mma(d[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;  // keeps the products
}

}  // namespace

// blocks x 256 threads, each warp iters x 16 m16n8k8 products (2048 FLOP
// each); out holds blocks * 256 floats. Returns cudaGetLastError().
extern "C" int mmt_mma_tf32_probe(void* out, int blocks, int iters,
                                  void* stream) {
  mma_tf32_probe<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, iters);
  return (int)cudaGetLastError();
}
