// Helpers shared by the attention kernels (forward: axial_attention.cu,
// backward: axial_attention_bwd.cu): the CTA shape, type conversions with
// the compute-type rounding, exact GELU, warp reductions, the loader that
// rotates and concatenates [content | rope] rows into shared memory, and
// the CUDA-core q k^T tile product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;             // query rows per warp
constexpr int kTq = kWarps * kRows;  // query rows per CTA
constexpr int kMaxDv = 64;           // two output columns per lane

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [row0, row0 + n_rows) of one head's [content | rotated rope] vectors
// into dst (row stride ld, `width` >= Dc + Dr columns); columns past D and
// rows at or past S become zeros. The rotation rounds like the plain
// PyTorch version in the compute type: round(round(x*cos) +
// round(rot(x)*sin)), tables rounded first.
template <typename T, typename Dst>
__device__ void load_rows(Dst* dst, int ld, int n_rows, int row0, int S,
                          const T* c, const T* r, const float* cs,
                          const float* sn, int Dc, int Dr, int width) {
  const int D = Dc + Dr;
  const int half = Dr / 2;
  for (int idx = threadIdx.x; idx < n_rows * width; idx += kThreads) {
    const int i = idx / width;
    const int d = idx - i * width;
    const int s = row0 + i;
    float val = 0.f;
    if (s < S && d < D) {
      if (d < Dc) {
        val = to_f(c[(size_t)s * Dc + d]);
      } else {
        const int e = d - Dc;
        const T* rr = r + (size_t)s * Dr;
        const float x = to_f(rr[e]);
        const float xr = e < half ? -to_f(rr[e + half]) : to_f(rr[e - half]);
        const float cv = rnd<T>(cs[s * Dr + e]);
        const float sv = rnd<T>(sn[s * Dr + e]);
        val = rnd<T>(rnd<T>(x * cv) + rnd<T>(xr * sv));
      }
    }
    put(dst + i * ld + d, val);
  }
}

// acc[i][c] += q[r0 + i] . k[lane + 32c] over d < D.
template <int NC>
__device__ __forceinline__ void qk(float (&acc)[kRows][NC], const float* sQ,
                                   const float* sK, int ld, int D, int r0,
                                   int lane) {
  for (int d = 0; d < D; ++d) {
    float qv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = sQ[(r0 + i) * ld + d];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float kv = sK[(lane + 32 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(qv[i], kv, acc[i][c]);
    }
  }
}

}  // namespace
