// Helpers shared by the conv residual's kernels: csrc/conv_residual.cu (the
// forward, and the forward that saves h and acc) and csrc/conv_residual_bwd.cu
// (the backward). Both GELUs are exact (erff) in both compute types, and the
// backward differentiates exactly that function.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace conv_residual {

constexpr int kHidden = 32;
constexpr int kTileR = 8;
constexpr int kTileC = 32;
constexpr int kThreads = kTileR * kTileC;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the compute type T, returned as fp32.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive channels stored at once (16 bytes in bf16, 32 in fp32);
// dst is aligned because the channel count is 32.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* dst,
                                              const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float (&v)[8]) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// d/dx of gelu: Phi(x) + x * phi(x).
__device__ __forceinline__ float dgelu(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * expf(-0.5f * x * x) * 0.39894228040143268f;
}

}  // namespace conv_residual
