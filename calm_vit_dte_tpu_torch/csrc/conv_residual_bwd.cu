// The CALM block's conv residual, backward, written for Hopper (sm_90a) in
// plain CUDA C++. For the forward of csrc/conv_residual.cu
//   a1 = W1 x + b1, h = gelu(a1) (rounded to the compute type),
//   acc = dw3x3(h) + bd, g2 = gelu(acc), y = W2 g2 + b2
// and an output gradient g (B, S, S, 3) it computes dx (B, S, S, 3) in the
// compute type and the fp32 weight grads, packed (32, 24) as the TPU kernel
// packs them: per hidden channel c, columns 0-8 dwd[c] by tap (a*3 + b), 9
// dbd, 10-12 dw1[c], 13 db1, 14-16 dw2^T[c], 17-23 zero. db2 = sum(g) is
// left to the caller, as the TPU wrapper computes it outside the kernel.
//
// Replaces: the Pallas TPU kernel built by
//   calm_vit_dte_tpu/kernels/conv_residual.py::_make_fused (bwd_call, :387),
//   body _bwd_kernel (:246-311), the CALM_CONV_BWD=pallas backward; and, as
//   a compile-time mask of its parts, the variants of
//   scripts/ablate_conv_bwd.py:119 (conv_residual_bwd_ablate below).
// Like the TPU kernel it recomputes h, acc and g2 flash-style: nothing of
// the forward is saved. Unlike it, both GELU derivatives are the exact
// derivative of the erf GELU in both compute types: the TPU's bf16 path
// differentiates its minimax polynomial (_dgelu_fast, :128-144), which the
// port's forward never computes, so the gradient here matches the port's
// own forward. Layout NHWC, not the TPU's bordered flat layout.
//
// What bounds it on the H100: per pixel it reads x and g and writes dx, 3
// channels each (18 B in bf16: 378 MB, 0.113 ms, for the flagship's eight
// conv stages at B=128), and does about 3 x 960 flops; memory-bound by the
// roofline. In practice it is bound by CUDA-core FMAs and erff/expf on the
// recomputed tile and halos (h on 1.69x, acc and dacc on 1.33x the tile's
// pixels), and by its shared-memory traffic.
//
// Design: one CTA of 256 threads per (image, 32-column strip, 4 row tiles
// of 8 rows), the tiles taken one after another. Per tile, x is staged on
// the tile plus a 2-pixel halo and g on the tile plus a 1-pixel halo; then
// the 32 hidden channels go in four chunks of 8, so that every buffer fits
// the 48 KB of static shared memory (46.5 KB, several CTAs per SM):
//   A (thread per pixel): h on the tile + 2-pixel halo, zero off the image;
//   B (thread per pixel): acc, dg2 = W2^T g, dacc = dg2 * gelu'(acc) on the
//     tile + 1-pixel halo (dacc zero off the image), and g2 of the tile;
//   C (warp per channel, lane per column, 8 rows): dh by the flipped taps,
//     da1 = dh * gelu'(a1); the 17 weight-grad sums of the channel over the
//     tile, reduced across the warp by a fixed shuffle tree and added by
//     lane 0 to the CTA's running sums in shared memory; da1 replaces g2 in
//     the tile buffer;
//   D (thread per pixel): dx += W1^T da1 over the chunk's channels.
// Weight grads without atomics: each CTA writes its (32, 17) sums to a
// partials buffer and conv_residual_wgrad_sum adds the partials in a fixed
// order, so two runs give the same bits.

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

constexpr int kChunk = 8;      // hidden channels per pass; one warp each
constexpr int kRowTiles = 4;   // 8-row tiles per CTA
constexpr int kHR = kTileR + 4, kHC = kTileC + 4, kHN = kHR * kHC;
constexpr int kAR = kTileR + 2, kAC = kTileC + 2, kAN = kAR * kAC;
constexpr int kWG = 17;        // weight-grad sums per hidden channel
constexpr int kWGOut = 24;     // the packed row
constexpr int kPartRow = kHidden * kWG;
static_assert(kChunk * 32 == kThreads, "phase C: one warp per channel");

// The parts of the backward, as scripts/ablate_conv_bwd.py names them; a
// variant without a part computes something else on purpose:
//   recompute  h = gelu(a1) and acc by the 9 taps (else h = a1, acc = h);
//   dgelu2     dacc = dg2 * gelu'(acc) (else dacc = dg2);
//   trans      the hand-off of g2 and da1 between the pixel-per-thread and
//              channel-per-warp layouts through shared memory (else the
//              dw2 sums and dx read zeros);
//   wdots      the weight-grad products and their reductions (else zeros);
//   dh         dh by the 9 flipped taps (else dh = dacc);
//   dgelu1     da1 = dh * gelu'(a1) (else da1 = dh).
enum : int {
  kRecompute = 1,
  kDgelu2 = 2,
  kTrans = 4,
  kWdots = 8,
  kDh = 16,
  kDgelu1 = 32,
  kAll = 63
};

template <typename T, int kParts>
__global__ void __launch_bounds__(kThreads) conv_residual_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ w2, T* __restrict__ dx,
    float* __restrict__ part, int S) {
  __shared__ float sh_h[kChunk * kHN];
  __shared__ float sh_dacc[kChunk * kAN];
  __shared__ float sh_t[kChunk * kThreads];   // g2, then da1, of the tile
  __shared__ float sh_x[kHN * 3];
  __shared__ float sh_g[kAN * 3];
  __shared__ float sh_wg[kPartRow];
  __shared__ float sw1[kHidden * 3], sb1[kHidden], swd[9 * kHidden];
  __shared__ float sbd[kHidden], sw2[3 * kHidden];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t < kHidden * 3) {
    sw1[t] = w1[t];
    sw2[t] = w2[t];
  }
  if (t < kHidden) {
    sb1[t] = b1[t];
    sbd[t] = bd[t];
  }
  for (int i = t; i < 9 * kHidden; i += kThreads) swd[i] = wd[i];
  for (int i = t; i < kPartRow; i += kThreads) sh_wg[i] = 0.f;
  for (int i = t; i < kChunk * kThreads; i += kThreads) sh_t[i] = 0.f;
  __syncthreads();

  const int b = blockIdx.z;
  const int c0 = blockIdx.x * kTileC;
  const T* xb = x + (size_t)b * S * S * 3;
  const T* gb = g + (size_t)b * S * S * 3;
  T* dxb = dx + (size_t)b * S * S * 3;

  for (int rt = 0; rt < kRowTiles; ++rt) {
    const int r0 = (blockIdx.y * kRowTiles + rt) * kTileR;
    if (r0 >= S) break;   // the same for every thread of the CTA

    // x on the tile + 2-pixel halo, g on the tile + 1-pixel halo, zero off
    // the image.
    for (int i = t; i < kHN * 3; i += kThreads) {
      const int p = i / 3;
      const int r = r0 - 2 + p / kHC;
      const int c = c0 - 2 + p % kHC;
      sh_x[i] = (r >= 0 && r < S && c >= 0 && c < S)
                    ? to_f(xb[((size_t)r * S + c) * 3 + i % 3]) : 0.f;
    }
    for (int i = t; i < kAN * 3; i += kThreads) {
      const int q = i / 3;
      const int r = r0 - 1 + q / kAC;
      const int c = c0 - 1 + q % kAC;
      sh_g[i] = (r >= 0 && r < S && c >= 0 && c < S)
                    ? to_f(gb[((size_t)r * S + c) * 3 + i % 3]) : 0.f;
    }
    __syncthreads();

    float dx0 = 0.f, dx1 = 0.f, dx2 = 0.f;
    for (int k0 = 0; k0 < kHidden; k0 += kChunk) {
      // A: h on the tile + 2-pixel halo (h-region (hr, hc) is image pixel
      // (r0 - 2 + hr, c0 - 2 + hc)).
      for (int p = t; p < kHN; p += kThreads) {
        const int r = r0 - 2 + p / kHC;
        const int c = c0 - 2 + p % kHC;
        const bool inside = r >= 0 && r < S && c >= 0 && c < S;
        const float x0 = sh_x[p * 3], x1 = sh_x[p * 3 + 1],
                    x2 = sh_x[p * 3 + 2];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int ch = k0 + j;
          const float a = fmaf(sw1[ch * 3 + 2], x2,
                               fmaf(sw1[ch * 3 + 1], x1,
                                    fmaf(sw1[ch * 3], x0, sb1[ch])));
          const float hv = (kParts & kRecompute) ? gelu(a) : a;
          sh_h[j * kHN + p] = inside ? rnd<T>(hv) : 0.f;
        }
      }
      __syncthreads();

      // B: acc, dacc on the tile + 1-pixel halo (acc-region (ar, ac) is
      // image pixel (r0 - 1 + ar, c0 - 1 + ac), h-region (ar + 1, ac + 1)).
      for (int q = t; q < kAN; q += kThreads) {
        const int ar = q / kAC;
        const int ac = q % kAC;
        const int r = r0 - 1 + ar;
        const int c = c0 - 1 + ac;
        const bool inside = r >= 0 && r < S && c >= 0 && c < S;
        const bool own = ar >= 1 && ar <= kTileR && ac >= 1 && ac <= kTileC;
        const float g0 = sh_g[q * 3], g1 = sh_g[q * 3 + 1],
                    g2v = sh_g[q * 3 + 2];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int ch = k0 + j;
          const float* hp = sh_h + j * kHN + ar * kHC + ac;
          float acc;
          if (kParts & kRecompute) {
            acc = sbd[ch];
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int bb = 0; bb < 3; ++bb)
                acc = fmaf(hp[a * kHC + bb],
                           swd[(a * 3 + bb) * kHidden + ch], acc);
          } else {
            acc = hp[kHC + 1];
          }
          const float dg2 = fmaf(sw2[2 * kHidden + ch], g2v,
                                 fmaf(sw2[kHidden + ch], g1,
                                      sw2[ch] * g0));
          const float dacc = (kParts & kDgelu2) ? dg2 * dgelu(acc) : dg2;
          sh_dacc[j * kAN + q] = inside ? dacc : 0.f;
          if ((kParts & kTrans) && own)
            sh_t[j * kThreads + (ar - 1) * kTileC + ac - 1] =
                (kParts & kRecompute) ? gelu(acc) : acc;
        }
      }
      __syncthreads();

      // C: warp `warp` takes channel k0 + warp, its lane one tile column.
      {
        const int j = warp;
        const int ch = k0 + j;
        const int tc = lane;
        const int c = c0 + tc;
        const float* dp = sh_dacc + j * kAN;
        const float* hq = sh_h + j * kHN;
        float* tq = sh_t + j * kThreads;
        float wdc[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wdc[k] = swd[k * kHidden + ch];
        float s[kWG];
#pragma unroll
        for (int k = 0; k < kWG; ++k) s[k] = 0.f;
        for (int tr = 0; tr < kTileR; ++tr) {
          if (r0 + tr >= S || c >= S) continue;
          const float dacc = dp[(tr + 1) * kAC + tc + 1];
          float dh = dacc;
          if (kParts & kDh) {
            dh = 0.f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int bb = 0; bb < 3; ++bb)
                dh = fmaf(dp[(tr + 2 - a) * kAC + tc + 2 - bb],
                          wdc[a * 3 + bb], dh);
          }
          const float* xq = sh_x + ((tr + 2) * kHC + tc + 2) * 3;
          const float a1 = fmaf(sw1[ch * 3 + 2], xq[2],
                                fmaf(sw1[ch * 3 + 1], xq[1],
                                     fmaf(sw1[ch * 3], xq[0], sb1[ch])));
          const float da1 = (kParts & kDgelu1) ? dh * dgelu(a1) : dh;
          if (kParts & kWdots) {
            const float g2 = tq[tr * kTileC + tc];
            const float* gq = sh_g + ((tr + 1) * kAC + tc + 1) * 3;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int bb = 0; bb < 3; ++bb)
                s[a * 3 + bb] = fmaf(dacc, hq[(tr + 1 + a) * kHC + tc + 1 + bb],
                                     s[a * 3 + bb]);
            s[9] += dacc;
            s[10] = fmaf(da1, xq[0], s[10]);
            s[11] = fmaf(da1, xq[1], s[11]);
            s[12] = fmaf(da1, xq[2], s[12]);
            s[13] += da1;
            s[14] = fmaf(g2, gq[0], s[14]);
            s[15] = fmaf(g2, gq[1], s[15]);
            s[16] = fmaf(g2, gq[2], s[16]);
          }
          if (kParts & kTrans) tq[tr * kTileC + tc] = da1;
        }
        if (kParts & kWdots) {
          // A fixed shuffle tree: lane 0's sums have the same bits every
          // run.
#pragma unroll
          for (int k = 0; k < kWG; ++k) {
            float v = s[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, off);
            s[k] = v;
          }
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < kWG; ++k) sh_wg[ch * kWG + k] += s[k];
          }
        }
      }
      __syncthreads();

      // D: dx of this thread's pixel, over the chunk's channels in order.
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int ch = k0 + j;
        const float da1 = sh_t[j * kThreads + t];
        dx0 = fmaf(sw1[ch * 3], da1, dx0);
        dx1 = fmaf(sw1[ch * 3 + 1], da1, dx1);
        dx2 = fmaf(sw1[ch * 3 + 2], da1, dx2);
      }
      // The next chunk rewrites sh_h, sh_dacc and sh_t; the next tile
      // rewrites sh_x and sh_g.
      __syncthreads();
    }
    const int r = r0 + t / kTileC;
    const int c = c0 + t % kTileC;
    if (r < S && c < S) {
      T* p = dxb + ((size_t)r * S + c) * 3;
      p[0] = from_f<T>(dx0);
      p[1] = from_f<T>(dx1);
      p[2] = from_f<T>(dx2);
    }
  }
  __syncthreads();
  float* out = part + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x) * kPartRow;
  for (int i = t; i < kPartRow; i += kThreads) out[i] = sh_wg[i];
}

// The (32, 24) packed weight grads from n partial rows of 32 x 17 sums.
// Block x owns 32 of the 544 sums: warp w adds rows w, w + 8, ... in order,
// then warp 0 adds the eight warp sums in order. Block 0 also writes the
// zero columns 17-23.
__global__ void __launch_bounds__(256) conv_wgrad_sum_kernel(
    const float* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ float s[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float v = 0.f;
  for (int i = warp; i < n; i += 8) v += part[(size_t)i * kPartRow + j];
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) total += s[w][lane];
    out[(j / kWG) * kWGOut + j % kWG] = total;
  }
  if (blockIdx.x == 0) {
    constexpr int kPad = kWGOut - kWG;
    for (int i = threadIdx.x; i < kHidden * kPad; i += 256)
      out[(i / kPad) * kWGOut + kWG + i % kPad] = 0.f;
  }
}

dim3 bwd_grid(int B, int S) {
  return dim3((S + kTileC - 1) / kTileC,
              (S + kTileR * kRowTiles - 1) / (kTileR * kRowTiles), B);
}

template <typename T, int kParts>
cudaError_t launch_bwd(const void* x, const void* g, const float* w1,
                       const float* b1, const float* wd, const float* bd,
                       const float* w2, void* dx, float* part, int B, int S,
                       cudaStream_t stream) {
  conv_residual_bwd_kernel<T, kParts><<<bwd_grid(B, S), kThreads, 0,
                                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w1, b1, wd, bd, w2,
      static_cast<T*>(dx), part, S);
  return cudaGetLastError();
}

}  // namespace

// The number of partial rows (CTAs) the backward writes for (B, S); each
// row holds 32 x 17 fp32 sums.
extern "C" int conv_residual_bwd_rows(int B, int S) {
  const dim3 grid = bwd_grid(B, S);
  return (int)(grid.x * grid.y * grid.z);
}

// Returns a cudaError_t (0 on success). x, g, dx: (B,S,S,3) contiguous NHWC
// in the compute type; w1 (32,3), b1 (32), wd (3,3,32), bd (32), w2 (3,32)
// fp32; part: conv_residual_bwd_rows(B, S) x 544 fp32.
extern "C" int conv_residual_bwd(int is_bf16, const void* x, const void* g,
                                 const float* w1, const float* b1,
                                 const float* wd, const float* bd,
                                 const float* w2, void* dx, float* part,
                                 int B, int S, void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16, kAll>(x, g, w1, b1, wd, bd, w2, dx,
                                                part, B, S, st);
  return (int)launch_bwd<float, kAll>(x, g, w1, b1, wd, bd, w2, dx, part, B,
                                      S, st);
}

// out (32, 24) fp32 from the n partial rows of conv_residual_bwd.
extern "C" int conv_residual_wgrad_sum(const float* part, int n, float* out,
                                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  conv_wgrad_sum_kernel<<<kPartRow / 32, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(part, n, out);
  return cudaGetLastError();
}

// The bf16 backward built without some of its parts (a bit mask of the enum
// above): all parts (63, the production kernel), or all but one. For
// timing only; the variants compute something else on purpose.
extern "C" int conv_residual_bwd_ablate(int parts, const void* x,
                                        const void* g, const float* w1,
                                        const float* b1, const float* wd,
                                        const float* bd, const float* w2,
                                        void* dx, float* part, int B, int S,
                                        void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using T = __nv_bfloat16;
#define CALM_ABLATE_CASE(P)                                               \
  case P:                                                                 \
    return (int)launch_bwd<T, P>(x, g, w1, b1, wd, bd, w2, dx, part, B, S, \
                                 st);
  switch (parts) {
    CALM_ABLATE_CASE(kAll)
    CALM_ABLATE_CASE(kAll & ~kRecompute)
    CALM_ABLATE_CASE(kAll & ~kDgelu2)
    CALM_ABLATE_CASE(kAll & ~kTrans)
    CALM_ABLATE_CASE(kAll & ~kWdots)
    CALM_ABLATE_CASE(kAll & ~kDh)
    CALM_ABLATE_CASE(kAll & ~kDgelu1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CALM_ABLATE_CASE
}
