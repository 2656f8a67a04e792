// Helpers shared by the attention kernels (axial_attention.cu,
// axial_attention_bwd.cu and, through hires_common.cuh, the hires sources):
// the CTA shape of the CUDA-core kernels, type conversions with the
// compute-type rounding, exact GELU, a warp sum, and what the runtime makes
// of a kernel (occupancy).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round to the compute type and back (identity for fp32).
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

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// What the card makes of one kernel launched with `threads` a CTA and
// `dyn` bytes of dynamic shared memory: out[0..3] = registers a thread,
// local (spill) bytes a thread, static + dynamic shared memory a CTA, CTAs
// resident per SM.
inline cudaError_t occupancy(const void* fn, int threads, size_t dyn,
                             int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      dyn);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes + dyn);
  out[3] = ctas;
  return cudaSuccess;
}

}  // namespace
