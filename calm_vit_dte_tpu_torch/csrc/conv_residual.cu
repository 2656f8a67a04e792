// The CALM block's conv residual, forward, written for Hopper (sm_90a) in
// plain CUDA C++:
//   y = W2 . gelu(dw3x3(gelu(W1 . x + b1)) + bd) + b2
// on an NHWC image x (B, S, S, 3): a 1x1 conv 3->32, exact GELU, a
// depthwise 3x3 conv whose zero padding applies to the hidden tensor h (not
// to x), exact GELU, a 1x1 conv 32->3. Output NHWC (B, S, S, 3).
//
// Replaces two Pallas TPU kernels built by
// calm_vit_dte_tpu/kernels/conv_residual.py::_make_fused:
//   fwd_call (:355, body _fwd_kernel_plain -> _fwd_kernel): y only, the
//     eval/serve forward and the forward of the recomputing backward;
//   fwd_resid_call (:369, _fwd_kernel with save_resid): y, and the middle
//     activations h = gelu(W1 x + b1) and acc = dw3x3(h) + bd that the
//     CALM_CONV_BWD=xla backward reads, each (B, S, S, 32) channel-last in
//     the compute type.
// Dropped from the TPU kernels: the bordered, lane-aligned channel-major
// flat layout and the host-side pad/transpose around it (a VMEM-tiling
// device; the saved h here has no border, its zero padding is implicit),
// and the bf16 minimax GELU (_gelu_fast, which saved VPU ops on v5e): both
// GELUs here are exact erff in both compute types. Rounding follows
// _fwd_kernel: h is rounded to the compute type, the depthwise sum, second
// GELU and W2 product stay fp32, y (and the saved acc) are stored in the
// compute type. There is no S gate: the kernel runs at every S.
//
// What bounds it on the H100: per pixel the forward reads 3 values and
// writes 3 (bytes 2 * B*S^2*3 * itemsize: 77 MB at B=128, S=224, bf16, 23 us
// at 3.35 TB/s) and does 2*32*15 = 960 flops (6.2 GFLOP, 6.2 us at 989
// TFLOP/s), so by the roofline it is memory-bound. The forward with
// residuals also writes h and acc, 64 more values per pixel (140 B per
// pixel in bf16: 0.88 ms of bytes for a flagship step at B=128), and is
// memory-bound by far. The 32-channel hidden tensor otherwise never reaches
// device memory; in practice the forward is bound by its CUDA-core FMAs and
// erff calls (two GELUs x 32 channels per pixel, plus the recomputed halo).
//
// Design: one CTA of 256 threads per (image, 8-row x 32-column output
// tile). Phase 1 computes h for the tile plus a one-pixel halo (10 x 34
// pixels x 32 channels, 43.5 KB fp32 in shared memory, channel-major so
// neighbouring threads touch neighbouring pixels), zero outside the image;
// the forward with residuals also stores the tile's own h, eight channels
// per 16- or 32-byte store. Phase 2 gives each thread one output pixel: 9
// taps + bd, GELU and W2 for each of the 32 channels, then 3 stores (and
// acc, eight channels per store). The weights (1.7 KB) sit in shared memory.

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kHaloN = kHaloR * kHaloC;

// w1 (32,3), b1 (32), wd (3,3,32) [wd[a][b][c] = OIHW w[c][0][a][b]],
// bd (32), w2 (3,32), b2 (3), all fp32. h_out, acc_out: (B,S,S,32), written
// only when kSave.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads) conv_residual_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ y, T* __restrict__ h_out,
    T* __restrict__ acc_out, int S) {
  __shared__ float sh[kHidden * kHaloN];
  __shared__ float sw1[kHidden * 3], sb1[kHidden], swd[9 * kHidden];
  __shared__ float sbd[kHidden], sw2[3 * kHidden], sb2[3];
  const int t = threadIdx.x;
  if (t < kHidden * 3) {
    sw1[t] = w1[t];
    sw2[t] = w2[t];
  }
  if (t < kHidden) {
    sb1[t] = b1[t];
    sbd[t] = bd[t];
  }
  for (int i = t; i < 9 * kHidden; i += kThreads) swd[i] = wd[i];
  if (t < 3) sb2[t] = b2[t];
  __syncthreads();

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileR;
  const int c0 = blockIdx.x * kTileC;
  const T* xb = x + (size_t)b * S * S * 3;

  // Phase 1: h = gelu(W1 x + b1) on the tile and its halo, 0 off-image.
  for (int p = t; p < kHaloN; p += kThreads) {
    const int hr = p / kHaloC;
    const int hc = p % kHaloC;
    const int r = r0 - 1 + hr;
    const int c = c0 - 1 + hc;
    const bool inside = r >= 0 && r < S && c >= 0 && c < S;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (inside) {
      const T* px = xb + ((size_t)r * S + c) * 3;
      x0 = to_f(px[0]);
      x1 = to_f(px[1]);
      x2 = to_f(px[2]);
    }
    // The halo belongs to the neighbouring tiles: only the tile's own
    // pixels are saved.
    const bool own = kSave && inside && hr >= 1 && hr <= kTileR &&
                     hc >= 1 && hc <= kTileC;
    for (int cg = 0; cg < kHidden; cg += 8) {
      float hv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = cg + j;
        const float a = fmaf(sw1[ch * 3 + 2], x2,
                             fmaf(sw1[ch * 3 + 1], x1,
                                  fmaf(sw1[ch * 3], x0, sb1[ch])));
        hv[j] = inside ? rnd<T>(gelu(a)) : 0.f;
        sh[ch * kHaloN + p] = hv[j];
      }
      if (own)
        store8<T>(h_out + (((size_t)b * S + r) * S + c) * kHidden + cg, hv);
    }
  }
  __syncthreads();

  // Phase 2: one output pixel per thread.
  const int tr = t / kTileC;
  const int tc = t % kTileC;
  const int r = r0 + tr;
  const int c = c0 + tc;
  if (r >= S || c >= S) return;
  float o0 = sb2[0], o1 = sb2[1], o2 = sb2[2];
  for (int cg = 0; cg < kHidden; cg += 8) {
    float av[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = cg + j;
      const float* hp = sh + ch * kHaloN + tr * kHaloC + tc;
      float acc = sbd[ch];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int bb = 0; bb < 3; ++bb)
          acc = fmaf(hp[a * kHaloC + bb], swd[(a * 3 + bb) * kHidden + ch],
                     acc);
      av[j] = acc;
      const float g = gelu(acc);
      o0 = fmaf(sw2[ch], g, o0);
      o1 = fmaf(sw2[kHidden + ch], g, o1);
      o2 = fmaf(sw2[2 * kHidden + ch], g, o2);
    }
    if (kSave)
      store8<T>(acc_out + (((size_t)b * S + r) * S + c) * kHidden + cg, av);
  }
  T* py = y + (((size_t)b * S + r) * S + c) * 3;
  py[0] = from_f<T>(o0);
  py[1] = from_f<T>(o1);
  py[2] = from_f<T>(o2);
}

template <typename T, bool kSave>
cudaError_t launch(const void* x, const float* w1, const float* b1,
                   const float* wd, const float* bd, const float* w2,
                   const float* b2, void* y, void* h, void* acc, int B, int S,
                   cudaStream_t stream) {
  const dim3 grid((S + kTileC - 1) / kTileC, (S + kTileR - 1) / kTileR, B);
  conv_residual_fwd_kernel<T, kSave><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w1, b1, wd, bd, w2, b2, static_cast<T*>(y),
      static_cast<T*>(h), static_cast<T*>(acc), S);
  return cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t (0 on success). x, y: (B,S,S,3) contiguous NHWC
// in the compute type; weights fp32 contiguous in the layouts above.
extern "C" int conv_residual_fwd(int is_bf16, const void* x, const float* w1,
                                 const float* b1, const float* wd,
                                 const float* bd, const float* w2,
                                 const float* b2, void* y, int B, int S,
                                 void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(x, w1, b1, wd, bd, w2, b2, y,
                                             nullptr, nullptr, B, S, st);
  return (int)launch<float, false>(x, w1, b1, wd, bd, w2, b2, y, nullptr,
                                   nullptr, B, S, st);
}

// As conv_residual_fwd, and also h, acc: (B,S,S,32) contiguous in the
// compute type.
extern "C" int conv_residual_fwd_resid(int is_bf16, const void* x,
                                       const float* w1, const float* b1,
                                       const float* wd, const float* bd,
                                       const float* w2, const float* b2,
                                       void* y, void* h, void* acc, int B,
                                       int S, void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, true>(x, w1, b1, wd, bd, w2, b2, y, h,
                                            acc, B, S, st);
  return (int)launch<float, true>(x, w1, b1, wd, bd, w2, b2, y, h, acc, B,
                                  S, st);
}
