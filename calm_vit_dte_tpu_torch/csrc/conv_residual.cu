// The CALM block's conv residual, forward, written for Hopper (sm_90a) in
// plain CUDA C++:
//   y = W2 . gelu(dw3x3(gelu(W1 . x + b1)) + bd) + b2
// on an NHWC image x (B, S, S, 3): a 1x1 conv 3->32, GELU, a depthwise 3x3
// conv whose zero padding applies to the hidden tensor h (not to x), GELU, a
// 1x1 conv 32->3. Output NHWC (B, S, S, 3).
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
// and the bf16 minimax GELU (_gelu_fast, which saved VPU ops on v5e). The
// fp32 route's GELUs are exact erff; the bf16 route's are
// conv_residual_common.cuh's gelu_bf16 (erf within kErfBf16MaxErr of erff).
// Rounding follows _fwd_kernel: h is rounded to the compute type, the
// depthwise sum, second GELU and W2 product stay fp32, y (and the saved acc)
// are stored in the compute type. There is no S gate: the kernels run at
// every S.
//
// What bounds it on the H100: per pixel the forward reads 3 values and
// writes 3 (bytes 2 * B*S^2*3 * itemsize: 77 MB at B=128, S=224, bf16, 23 us
// at 3.35 TB/s) and does 2*32*15 = 960 flops, so by the roofline it is
// memory-bound. The forward with residuals also writes h and acc, 64 more
// values per pixel (140 B per pixel in bf16: 0.88 ms of bytes for a
// flagship step at B=128), and is memory-bound by far. The 32-channel
// hidden tensor otherwise never reaches device memory. In practice the
// forward is bound by instruction issue on the CUDA cores: per pixel 480
// FMAs and 64 GELUs, plus the first GELU on the recomputed halo; it is
// not a product the tensor cores can take (the depthwise taps are per
// channel, and the W1 and W2 products must stay fp32).
//
// bf16 design (conv_fwd_bf16_kernel<kSave>): one CTA of 256 threads (8
// warps) per (image, 64-row x 16-column output tile), every published conv
// S being a multiple of 16, so no column is idle there. The 32 hidden
// channels go in two passes of 16:
//   1 (thread per halo pixel): h = gelu(W1 x + b1) rounded to bf16, on the
//     66 x 18 halo (zero off the image), into shared memory as bf16, 32
//     bytes a pixel in four 8-byte chunks of four channels, chunk j at
//     slot j ^ ((column >> 2) & 3) so that sixteen neighbouring columns
//     read one chunk without a bank conflict; the forward with residuals
//     also stores the tile's own h, 16 channels per two 16-byte stores;
//   2 (thread per 4 rows of one column): for each chunk, the 3 x 3 taps as
//     register-blocked 8-byte reads, each bf16 pair widened to fp32 by a
//     shift and a mask (6 rows x 3 columns serve 4 outputs x 4 channels),
//     the second GELU and the W2 product into y held in registers across
//     both passes; the saved acc goes out eight channels (16 bytes) at a
//     time.
// Three barriers a tile. Shared memory: 38,016 bytes of h (fwd_bf16_smem)
// and 2,192 of weights. The forward is held to 80 registers so that three
// CTAs (24 warps) share an SM (__launch_bounds__(256, 3), no spills); the
// forward with residuals keeps 128 (__launch_bounds__(256, 2)): at 80 it
// spilled 40 bytes and ran 32% slower.
//   bf16 forward: 40208 bytes, 3 CTAs per SM
//   bf16 forward with residuals: 40208 bytes, 2 CTAs per SM
// (232,448 bytes a CTA at most). h as fp32 (76,032 bytes) leaves room for
// two CTAs only: at two CTAs the kernel ran as fast with either layout,
// and the bf16 layout at three CTAs took 7.7% off the flagship forward
// (NVIDIA H100 80GB HBM3; PERF.md, section 6).
//
// fp32 design (conv_residual_fwd_kernel<kSave>): one CTA of 256 threads
// per (image, 8-row x 32-column output tile). Phase 1 computes h
// for the tile plus a one-pixel halo (10 x 34 pixels x 32 channels, 43.5
// KB fp32 in shared memory, channel-major); phase 2 gives each thread one
// output pixel: 9 taps + bd, GELU and W2 for each of the 32 channels.

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

// ---- fp32 route ------------------------------------------------------------

constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kHaloN = kHaloR * kHaloC;

// w1 (32,3), b1 (32), wd (3,3,32) [wd[a][b][c] = OIHW w[c][0][a][b]],
// bd (32), w2 (3,32), b2 (3), all fp32. h_out, acc_out: (B,S,S,32), written
// only when kSave.
template <bool kSave>
__global__ void __launch_bounds__(kThreads) conv_residual_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ acc_out, int S) {
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
  const float* xb = x + (size_t)b * S * S * 3;

  // Phase 1: h = gelu(W1 x + b1) on the tile and its halo, 0 off-image.
  for (int p = t; p < kHaloN; p += kThreads) {
    const int hr = p / kHaloC;
    const int hc = p % kHaloC;
    const int r = r0 - 1 + hr;
    const int c = c0 - 1 + hc;
    const bool inside = r >= 0 && r < S && c >= 0 && c < S;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (inside) {
      const float* px = xb + ((size_t)r * S + c) * 3;
      x0 = px[0];
      x1 = px[1];
      x2 = px[2];
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
        hv[j] = inside ? gelu(a) : 0.f;
        sh[ch * kHaloN + p] = hv[j];
      }
      if (own)
        store8(h_out + (((size_t)b * S + r) * S + c) * kHidden + cg, hv);
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
      store8(acc_out + (((size_t)b * S + r) * S + c) * kHidden + cg, av);
  }
  float* py = y + (((size_t)b * S + r) * S + c) * 3;
  py[0] = o0;
  py[1] = o1;
  py[2] = o2;
}

// ---- bf16 route ------------------------------------------------------------

namespace fwd16 {
constexpr int kR = 64, kC = 16;              // output tile
constexpr int kHR = kR + 2, kHC = kC + 2;    // the h halo: 66 x 18
constexpr int kHN = kHR * kHC;
constexpr int kRB = 4;                       // output rows a thread
constexpr int kThreads = (kR / kRB) * kC;    // 256
constexpr int kPass = 16;                    // channels a pass
constexpr int kChunks = kPass / 4;           // 8-byte chunks a pixel
constexpr int kMinCtas = 3;                  // CTAs an SM: the forward
constexpr int kMinCtasSave = 2;              // ... with residuals
constexpr size_t kSmem = sizeof(uint2) * kHN * kChunks;    // 38,016
static_assert(kThreads == 256 && kHidden == 2 * kPass, "geometry");
// Four halo rows (one thread's step down the tile) span a multiple of 32
// banks, so the bank of a chunk depends on its column alone.
static_assert((kRB * kHC * kChunks * 2) % 32 == 0, "row stride");
}  // namespace fwd16

// The slot of chunk j of a halo pixel in column hc.
__device__ __forceinline__ int chunk_slot(int j, int hc) {
  return j ^ ((hc >> 2) & 3);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <bool kSave>
__global__ void __launch_bounds__(fwd16::kThreads, kSave ? fwd16::kMinCtasSave
                                                         : fwd16::kMinCtas)
conv_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ acc_out,
    int S) {
  using namespace fwd16;
  extern __shared__ uint2 hs[];               // kHN pixels x kChunks
  // Weights by channel quad: w1t[i][q] = w1[4q..4q+3][i], and so on.
  __shared__ float4 w1t[3][8], b1q[8], wdq[9][8], bdq[8], w2q[3][8];
  __shared__ float sb2[4];
  const int t = threadIdx.x;
  if (t < kHidden * 3) {
    reinterpret_cast<float*>(w1t)[(t % 3) * kHidden + t / 3] = w1[t];
    reinterpret_cast<float*>(w2q)[t] = w2[t];
  }
  if (t < kHidden) {
    reinterpret_cast<float*>(b1q)[t] = b1[t];
    reinterpret_cast<float*>(bdq)[t] = bd[t];
  }
  for (int i = t; i < 9 * kHidden; i += kThreads)
    reinterpret_cast<float*>(wdq)[i] = wd[i];
  if (t < 3) sb2[t] = b2[t];
  __syncthreads();

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kR;
  const int c0 = blockIdx.x * kC;
  const __nv_bfloat16* xb = x + (size_t)b * S * S * 3;

  // Phase 2's thread: rows orow..orow+3 of column ocol.
  const int col = t % kC;
  const int rg = t / kC;
  const int orow = r0 + rg * kRB;
  const int ocol = c0 + col;
  const bool active = orow < S && ocol < S;
  const uint2* hrow = hs + (rg * kRB * kHC + col) * kChunks;

  float yv[kRB][3];
#pragma unroll
  for (int o = 0; o < kRB; ++o)
#pragma unroll
    for (int m = 0; m < 3; ++m) yv[o][m] = sb2[m];

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int q0 = pass * kChunks;   // first channel quad of the pass
    if (pass) __syncthreads();       // phase 2 of pass 0 has read hs

    // Phase 1: h on the halo, zero off the image.
#pragma unroll 2
    for (int p = t; p < kHN; p += kThreads) {
      const int hr = p / kHC;
      const int hc = p - hr * kHC;
      const int r = r0 - 1 + hr;
      const int c = c0 - 1 + hc;
      uint2* dst = hs + p * kChunks;
      if (r >= 0 && r < S && c >= 0 && c < S) {
        const __nv_bfloat16* px = xb + ((size_t)r * S + c) * 3;
        const float x0 = to_f(px[0]), x1 = to_f(px[1]), x2 = to_f(px[2]);
        uint32_t packed[2 * kChunks];
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const float4 wa = w1t[0][q0 + j], wb = w1t[1][q0 + j],
                       wc = w1t[2][q0 + j], bq = b1q[q0 + j];
          const float a0 = fmaf(wc.x, x2, fmaf(wb.x, x1, fmaf(wa.x, x0, bq.x)));
          const float a1 = fmaf(wc.y, x2, fmaf(wb.y, x1, fmaf(wa.y, x0, bq.y)));
          const float a2 = fmaf(wc.z, x2, fmaf(wb.z, x1, fmaf(wa.z, x0, bq.z)));
          const float a3 = fmaf(wc.w, x2, fmaf(wb.w, x1, fmaf(wa.w, x0, bq.w)));
          const uint32_t lo = pack_bf16x2(gelu_bf16(a0), gelu_bf16(a1));
          const uint32_t hi = pack_bf16x2(gelu_bf16(a2), gelu_bf16(a3));
          packed[2 * j] = lo;
          packed[2 * j + 1] = hi;
          dst[chunk_slot(j, hc)] = make_uint2(lo, hi);
        }
        // The halo belongs to the neighbouring tiles: only the tile's own
        // pixels are saved.
        if (kSave && hr >= 1 && hr <= kR && hc >= 1 && hc <= kC) {
          uint4* ph = reinterpret_cast<uint4*>(
              h_out + (((size_t)b * S + r) * S + c) * kHidden + pass * kPass);
          ph[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          ph[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
          dst[j] = make_uint2(0u, 0u);
      }
    }
    __syncthreads();

    // Phase 2: for each pair of chunks (8 channels), acc of 4 rows x 8
    // channels, then the second GELU and W2 into y.
    if (active) {
#pragma unroll
      for (int jp = 0; jp < kChunks / 2; ++jp) {
        uint32_t av[kRB][4];   // acc of the 8 channels, bf16 pairs
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * jp + jj;
          const float4 bq = bdq[q0 + j];
          float acc[kRB][4];
#pragma unroll
          for (int o = 0; o < kRB; ++o) {
            acc[o][0] = bq.x;
            acc[o][1] = bq.y;
            acc[o][2] = bq.z;
            acc[o][3] = bq.w;
          }
#pragma unroll
          for (int bb = 0; bb < 3; ++bb) {
            const float4 wt[3] = {wdq[bb][q0 + j], wdq[3 + bb][q0 + j],
                                  wdq[6 + bb][q0 + j]};
            const uint2* src = hrow + bb * kChunks + chunk_slot(j, col + bb);
#pragma unroll
            for (int i = 0; i < kRB + 2; ++i) {
              const uint2 u = src[i * kHC * kChunks];
              const float4 v = make_float4(bf16_lo(u.x), bf16_hi(u.x),
                                           bf16_lo(u.y), bf16_hi(u.y));
#pragma unroll
              for (int o = 0; o < kRB; ++o) {
                const int a = i - o;
                if (a < 0 || a > 2) continue;
                acc[o][0] = fmaf(v.x, wt[a].x, acc[o][0]);
                acc[o][1] = fmaf(v.y, wt[a].y, acc[o][1]);
                acc[o][2] = fmaf(v.z, wt[a].z, acc[o][2]);
                acc[o][3] = fmaf(v.w, wt[a].w, acc[o][3]);
              }
            }
          }
          const float4 wy[3] = {w2q[0][q0 + j], w2q[1][q0 + j],
                                w2q[2][q0 + j]};
#pragma unroll
          for (int o = 0; o < kRB; ++o) {
            const float g0 = gelu_bf16(acc[o][0]), g1 = gelu_bf16(acc[o][1]),
                        g2 = gelu_bf16(acc[o][2]), g3 = gelu_bf16(acc[o][3]);
#pragma unroll
            for (int m = 0; m < 3; ++m)
              yv[o][m] = fmaf(wy[m].w, g3, fmaf(wy[m].z, g2,
                              fmaf(wy[m].y, g1, fmaf(wy[m].x, g0, yv[o][m]))));
            if (kSave) {
              av[o][2 * jj] = pack_bf16x2(acc[o][0], acc[o][1]);
              av[o][2 * jj + 1] = pack_bf16x2(acc[o][2], acc[o][3]);
            }
          }
        }
        if (kSave) {
#pragma unroll
          for (int o = 0; o < kRB; ++o) {
            if (orow + o >= S) break;
            *reinterpret_cast<uint4*>(
                acc_out + (((size_t)b * S + orow + o) * S + ocol) * kHidden +
                pass * kPass + jp * 8) =
                make_uint4(av[o][0], av[o][1], av[o][2], av[o][3]);
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int o = 0; o < kRB; ++o) {
    if (orow + o >= S) break;
    __nv_bfloat16* py = y + (((size_t)b * S + orow + o) * S + ocol) * 3;
    py[0] = __float2bfloat16(yv[o][0]);
    py[1] = __float2bfloat16(yv[o][1]);
    py[2] = __float2bfloat16(yv[o][2]);
  }
}

template <bool kSave>
cudaError_t launch_f32(const void* x, const float* w1, const float* b1,
                       const float* wd, const float* bd, const float* w2,
                       const float* b2, void* y, void* h, void* acc, int B,
                       int S, cudaStream_t stream) {
  const dim3 grid((S + kTileC - 1) / kTileC, (S + kTileR - 1) / kTileR, B);
  conv_residual_fwd_kernel<kSave><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), w1, b1, wd, bd, w2, b2,
      static_cast<float*>(y), static_cast<float*>(h),
      static_cast<float*>(acc), S);
  return cudaGetLastError();
}

dim3 fwd_bf16_grid(int B, int S) {
  return dim3((S + fwd16::kC - 1) / fwd16::kC,
              (S + fwd16::kR - 1) / fwd16::kR, B);
}

template <bool kSave>
cudaError_t launch_bf16(const void* x, const float* w1, const float* b1,
                        const float* wd, const float* bd, const float* w2,
                        const float* b2, void* y, void* h, void* acc, int B,
                        int S, cudaStream_t stream) {
  static bool configured = false;   // the attribute is per function
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_fwd_bf16_kernel<kSave>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd16::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_fwd_bf16_kernel<kSave><<<fwd_bf16_grid(B, S), fwd16::kThreads,
                                 fwd16::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w1, b1, wd, bd, w2, b2,
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(h),
      static_cast<__nv_bfloat16*>(acc), S);
  return cudaGetLastError();
}

__global__ void erf_bf16_probe_kernel(const float* __restrict__ x, int n,
                                      float* __restrict__ erf_out,
                                      float* __restrict__ gelu_out,
                                      float* __restrict__ dgelu_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float cdf;
  erf_out[i] = erf_bf16(x[i]);
  gelu_out[i] = gelu_bf16(x[i]);
  dgelu_out[i] = dgelu_bf16(x[i], cdf);
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
    return (int)launch_bf16<false>(x, w1, b1, wd, bd, w2, b2, y, nullptr,
                                   nullptr, B, S, st);
  return (int)launch_f32<false>(x, w1, b1, wd, bd, w2, b2, y, nullptr,
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
    return (int)launch_bf16<true>(x, w1, b1, wd, bd, w2, b2, y, h, acc, B,
                                  S, st);
  return (int)launch_f32<true>(x, w1, b1, wd, bd, w2, b2, y, h, acc, B, S,
                               st);
}

// The bf16 forward's launch geometry for (B, S): out[0..2] the grid, out[3]
// the threads a CTA, out[4] the dynamic shared memory a CTA.
extern "C" void conv_residual_fwd_bf16_geometry(int B, int S, int* out) {
  const dim3 g = fwd_bf16_grid(B, S);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = (int)g.z;
  out[3] = fwd16::kThreads;
  out[4] = (int)fwd16::kSmem;
}

// What the card makes of each forward instantiation, in this order: fp32,
// fp32 with residuals, bf16, bf16 with residuals. For kernel k, out[4k..4k+3]
// = registers a thread, local (spill) bytes a thread, static + dynamic
// shared memory a CTA, CTAs resident per SM. Returns a cudaError_t.
extern "C" int conv_residual_fwd_occupancy(int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(conv_residual_fwd_kernel<false>),
      reinterpret_cast<const void*>(conv_residual_fwd_kernel<true>),
      reinterpret_cast<const void*>(conv_fwd_bf16_kernel<false>),
      reinterpret_cast<const void*>(conv_fwd_bf16_kernel<true>)};
  const int threads[4] = {kThreads, kThreads, fwd16::kThreads,
                          fwd16::kThreads};
  const size_t dyn[4] = {0, 0, fwd16::kSmem, fwd16::kSmem};
  for (int k = 0; k < 4; ++k) {
    if (dyn[k]) {
      cudaError_t err = cudaFuncSetAttribute(
          fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn[k]);
      if (err != cudaSuccess) return (int)err;
    }
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[k]);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[k],
                                                        threads[k], dyn[k]);
    if (err != cudaSuccess) return (int)err;
    out[4 * k] = attr.numRegs;
    out[4 * k + 1] = (int)attr.localSizeBytes;
    out[4 * k + 2] = (int)(attr.sharedSizeBytes + dyn[k]);
    out[4 * k + 3] = ctas;
  }
  return 0;
}

// erf(x / sqrt 2), GELU(x) and GELU'(x) of n fp32 values as the bf16 route
// computes them (conv_residual_common.cuh), for the test of their error.
extern "C" int conv_residual_erf_bf16_probe(const float* x, int n,
                                            float* erf_out, float* gelu_out,
                                            float* dgelu_out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  erf_bf16_probe_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, n, erf_out, gelu_out, dgelu_out);
  return cudaGetLastError();
}
