// Helpers shared by the conv residual's kernels: csrc/conv_residual.cu (the
// forward, and the forward that saves h and acc) and csrc/conv_residual_bwd.cu
// (the backward), each one design instantiated for two compute types. The
// fp32 route's GELUs are exact (erff), and its backward differentiates
// exactly that function; a GELU and its derivative share one erff (Phi)
// and take one expf (phi) more. The bf16 route evaluates both GELUs and
// their derivatives through `half_erfc` below (one exp and one reciprocal
// on the SFU for a GELU and its derivative together), and its backward
// differentiates that function's exact counterpart, as the fp32 route does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace conv_residual {

constexpr int kHidden = 32;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v stored in the compute type.
__device__ __forceinline__ void store_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// x rounded to bf16, returned as fp32.
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- The fp32 route's GELU -------------------------------------------------
// Phi(x), the normal CDF, from one erff.
__device__ __forceinline__ float cdf_exact(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

// Exact GELU: x Phi(x), the bits of 0.5 x (1 + erf(x / sqrt 2)) (the
// factor 0.5 is exact wherever it is applied).
__device__ __forceinline__ float gelu(float x) { return x * cdf_exact(x); }

// GELU'(x) = Phi(x) + x phi(x) from cdf = Phi(x): one expf.
__device__ __forceinline__ float dgelu_from(float x, float cdf) {
  return fmaf(x * kInvSqrt2Pi, expf(-0.5f * x * x), cdf);
}

// ---- The bf16 route's GELU ------------------------------------------------
// Abramowitz & Stegun 7.1.26: for z >= 0,
//   erfc(z) = t (a1 + t (a2 + t (a3 + t (a4 + t a5)))) exp(-z^2) + eps(z),
//   t = 1 / (1 + p z), |eps| <= 1.5e-7,
// taken at z = |x| / sqrt(2), so that exp(-z^2) = exp(-x^2 / 2) is also the
// normal density's exponential: the GELU Phi(x) x and its derivative
// Phi(x) + x phi(x) share one ex2.approx and one rcp.approx. Branch-free.
// Its largest absolute error against erff (erf_bf16 below) over a dense
// grid of [-10, 10] (2^20 + 1 points, on the card): 5.85e-7, against the
// exact erf 5.84e-7 (erff's own 8.8e-8); of gelu_bf16 against the exact
// GELU 3.3e-7, of dgelu_bf16 3.0e-7 (NVIDIA H100 80GB HBM3). The bound
// tests/test_torch_gpu.py holds: kErfBf16MaxErr. A GELU of +-inf gives NaN
// (inf * 0); finite inputs give finite outputs.
constexpr float kErfBf16MaxErr = 6e-7f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Returns q = erfc(|x| / sqrt(2)) / 2 (the normal tail beyond |x|) and sets
// e = exp(-x^2 / 2). The coefficients carry the 1/2.
__device__ __forceinline__ float half_erfc(float x, float& e) {
  const float t = rcp_approx(fmaf(0.3275911f * 0.70710678118654752f,
                                  fabsf(x), 1.0f));
  e = ex2_approx(x * (x * -0.72134752044448170f));   // -log2(e) / 2
  float p = fmaf(0.5f * 1.061405429f, t, 0.5f * -1.453152027f);
  p = fmaf(p, t, 0.5f * 1.421413741f);
  p = fmaf(p, t, 0.5f * -0.284496736f);
  p = fmaf(p, t, 0.5f * 0.254829592f);
  return p * t * e;
}

// Phi(x) from q = half_erfc(x).
__device__ __forceinline__ float cdf_from(float x, float q) {
  return x >= 0.0f ? 1.0f - q : q;
}

__device__ __forceinline__ float gelu_bf16(float x) {
  float e;
  const float q = half_erfc(x, e);
  return fmaf(-fabsf(x), q, fmaxf(x, 0.0f));   // x Phi(x), either sign
}

// GELU'(x) = Phi(x) + x phi(x), phi(x) = e / sqrt(2 pi); sets cdf = Phi(x).
__device__ __forceinline__ float dgelu_bf16(float x, float& cdf) {
  float e;
  const float q = half_erfc(x, e);
  cdf = cdf_from(x, q);
  return fmaf(x * 0.39894228040143268f, e, cdf);
}

// erf(x / sqrt(2)) = 2 Phi(x) - 1 as the bf16 route computes it.
__device__ __forceinline__ float erf_bf16(float x) {
  float e;
  const float q = half_erfc(x, e);
  return 2.0f * cdf_from(x, q) - 1.0f;
}

}  // namespace conv_residual
