// Shared helpers of the dasa_tpu_torch CUDA kernels (sm_90a).
//
// Every kernel is reached through an extern "C" entry point that takes raw
// device pointers, int sizes and the CUDA stream, launches on that stream,
// and returns cudaGetLastError() (or the launch's own error) so the Python
// wrapper can raise.  Kernels allocate nothing: the wrapper passes outputs
// and scratch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dasa {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 8 bf16 values packed in a uint4 -> 8 floats
__device__ __forceinline__ void unpack8(const uint4& v, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

}  // namespace dasa
