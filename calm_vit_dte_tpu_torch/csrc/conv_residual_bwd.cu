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
// the forward is saved. Both GELU derivatives are the derivative of the
// port's own forward GELU (exact erf in fp32, conv_residual_common.cuh's
// half_erfc in bf16), not the TPU's bf16 minimax polynomial (_dgelu_fast,
// :128-144), which the port's forward never computes. Layout NHWC, not the
// TPU's bordered flat layout.
//
// What bounds it on the H100: per pixel it reads x and g and writes dx, 3
// channels each (18 B in bf16: 378 MB, 0.113 ms, for the flagship's eight
// conv stages at B=128), and does about 3 x 960 flops; memory-bound by the
// roofline. In practice it is bound by instruction issue on the CUDA cores:
// per pixel and channel the forward recomputed (h on the tile's 2-pixel
// halo, acc on its 1-pixel halo, one GELU each), the 9 flipped taps, two
// GELU derivatives and 17 weight-grad products.
//
// bf16 design (conv_bwd_bf16_kernel<kParts>): one CTA of 8 warps per (image,
// 16-row x 32-column output tile). x is staged on the tile + 2 halo and g on
// the tile + 1 halo as float4 (the 4th lane: 1 inside the image, and for g
// 1 on the tile's own pixels only), behind the only barrier before the
// channels. Then each warp owns 4 of the 32 hidden channels (warp, warp + 8,
// ...) and takes them one at a time through three phases on planes of its
// own in shared memory, so no barrier but __syncwarp separates them:
//   A (20 x 36, a lane a column, then the last 4 columns a lane a pixel):
//     h = gelu(a1) rounded to bf16, zero off the image; on the tile also
//     gelu'(a1), from the same exp and reciprocal;
//   B (18 x 34, a lane a column 6 rows at a time, each h read serving up to
//     3 rows; then the last 2 columns): acc by the 9 taps, dg2 = W2^T g,
//     dacc = dg2 gelu'(acc) (zero off the image, since g is); on the tile's
//     own pixels the dbd and dw2 sums, g2 = gelu(acc) sharing gelu'(acc)'s
//     exp;
//   C (lane per column, 2 blocks of 8 rows): dh by the flipped taps and the
//     dwd sums, each as register-blocked reads of 10 rows x 3 columns;
//     da1 = dh gelu'(a1); the dw1, db1 sums; dx of the lane's 16 pixels
//     accumulated in registers over the warp's channels.
// After each channel the warp adds its 17 sums over the lanes by recursive
// halving (a fixed order) and writes them to the CTA's partial row. After
// the last one, the 8 warps' dx partials meet in shared memory (over the
// planes) and are added in warp order. Weight grads without atomics: the
// partial rows are summed in a fixed order by conv_residual_wgrad_sum, so
// two runs give the same bits. Unlike the fp32 kernel's, this design needs
// no hand-off of g2 and da1 between a pixel-per-thread and a
// channel-per-warp layout.
// Shared memory (bwd_bf16_smem): 21,312 bytes of x and g, 59,008 of the
// eight warps' planes; at most 128 registers (__launch_bounds__(256, 2)):
//   bf16 backward: 80320 bytes, 2 CTAs per SM
// (232,448 bytes a CTA at most; 16 warps an SM). The planes stay fp32:
// registers, not shared memory, hold the backward to two CTAs (a lane's dx
// alone takes 48 of its 127), so bf16 planes would buy no third CTA and
// would cost a widening per read (not tried on the card).
//
// fp32 design (conv_residual_bwd_kernel): one CTA of 256 threads per
// (image, 32-column strip, 4 row tiles of 8 rows); per tile, x and g staged
// with halos, then four chunks of 8 channels through four phases (h; acc
// and dacc; a warp per channel for dh, da1 and the weight-grad sums; dx)
// separated by barriers, exact erf throughout.

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

constexpr int kWG = 17;        // weight-grad sums per hidden channel
constexpr int kWGOut = 24;     // the packed row
constexpr int kPartRow = kHidden * kWG;

// ---- fp32 route ------------------------------------------------------------

namespace bwd32 {
constexpr int kChunk = 8;      // hidden channels per pass; one warp each
constexpr int kRowTiles = 4;   // 8-row tiles per CTA
constexpr int kHR = kTileR + 4, kHC = kTileC + 4, kHN = kHR * kHC;
constexpr int kAR = kTileR + 2, kAC = kTileC + 2, kAN = kAR * kAC;
static_assert(kChunk * 32 == kThreads, "phase C: one warp per channel");
}  // namespace bwd32

__global__ void __launch_bounds__(kThreads) conv_residual_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ w2, float* __restrict__ dx,
    float* __restrict__ part, int S) {
  using namespace bwd32;
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
  const float* xb = x + (size_t)b * S * S * 3;
  const float* gb = g + (size_t)b * S * S * 3;
  float* dxb = dx + (size_t)b * S * S * 3;

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
                    ? xb[((size_t)r * S + c) * 3 + i % 3] : 0.f;
    }
    for (int i = t; i < kAN * 3; i += kThreads) {
      const int q = i / 3;
      const int r = r0 - 1 + q / kAC;
      const int c = c0 - 1 + q % kAC;
      sh_g[i] = (r >= 0 && r < S && c >= 0 && c < S)
                    ? gb[((size_t)r * S + c) * 3 + i % 3] : 0.f;
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
          sh_h[j * kHN + p] = inside ? gelu(a) : 0.f;
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
          float acc = sbd[ch];
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int bb = 0; bb < 3; ++bb)
              acc = fmaf(hp[a * kHC + bb], swd[(a * 3 + bb) * kHidden + ch],
                         acc);
          const float dg2 = fmaf(sw2[2 * kHidden + ch], g2v,
                                 fmaf(sw2[kHidden + ch], g1,
                                      sw2[ch] * g0));
          sh_dacc[j * kAN + q] = inside ? dg2 * dgelu(acc) : 0.f;
          if (own)
            sh_t[j * kThreads + (ar - 1) * kTileC + ac - 1] = gelu(acc);
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
          float dh = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int bb = 0; bb < 3; ++bb)
              dh = fmaf(dp[(tr + 2 - a) * kAC + tc + 2 - bb],
                        wdc[a * 3 + bb], dh);
          const float* xq = sh_x + ((tr + 2) * kHC + tc + 2) * 3;
          const float a1 = fmaf(sw1[ch * 3 + 2], xq[2],
                                fmaf(sw1[ch * 3 + 1], xq[1],
                                     fmaf(sw1[ch * 3], xq[0], sb1[ch])));
          const float da1 = dh * dgelu(a1);
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
          tq[tr * kTileC + tc] = da1;
        }
        // A fixed shuffle tree: lane 0's sums have the same bits every run.
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
      float* p = dxb + ((size_t)r * S + c) * 3;
      p[0] = dx0;
      p[1] = dx1;
      p[2] = dx2;
    }
  }
  __syncthreads();
  float* out = part + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x) * kPartRow;
  for (int i = t; i < kPartRow; i += kThreads) out[i] = sh_wg[i];
}

dim3 bwd_f32_grid(int B, int S) {
  constexpr int kRows = kTileR * bwd32::kRowTiles;
  return dim3((S + kTileC - 1) / kTileC, (S + kRows - 1) / kRows, B);
}

// ---- bf16 route ------------------------------------------------------------

// The parts of the bf16 backward, as scripts/ablate_conv_bwd.py names them;
// a variant without a part computes something else on purpose:
//   recompute  h = gelu(a1) and acc by the 9 taps (else h = a1, acc = h);
//   dgelu2     dacc = dg2 * gelu'(acc) (else dacc = dg2; gelu(acc) for the
//              dw2 sums still takes the shared exp and reciprocal);
//   wdots      the weight-grad products and their reductions (else zeros);
//   dh         dh by the 9 flipped taps (else dh = dacc);
//   dgelu1     da1 = dh * gelu'(a1) (else da1 = dh).
// The script's sixth part, trans (the hand-off between two layouts through
// shared memory), has no counterpart in this design.
enum : int {
  kRecompute = 1,
  kDgelu2 = 2,
  kWdots = 4,
  kDh = 8,
  kDgelu1 = 16,
  kAll = 31
};

namespace bwd16 {
constexpr int kR = 16, kC = 32;                 // output tile
constexpr int kHR = kR + 4, kHC = kC + 4;       // h plane: the tile + 2
constexpr int kAR = kR + 2, kAC = kC + 2;       // acc, dacc plane: + 1
constexpr int kHN = kHR * kHC;                  // 720
constexpr int kAN = kAR * kAC;                  // 612
constexpr int kTN = kR * kC;                    // 512
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMinCtas = 2;                     // CTAs an SM
constexpr int kRB = 8, kBlocks = kR / kRB;      // phase C: rows a block
constexpr int kBR = 6;                          // phase B: rows a block
constexpr int kPlane = kHN + kAN + kTN;         // floats a warp
constexpr size_t kSmem = sizeof(float4) * (kHN + kAN) +
                         sizeof(float) * kWarps * kPlane;   // 80,320
static_assert(kC == 32, "phases A-C: a lane a column");
static_assert(kAR % kBR == 0, "phase B: whole blocks");
static_assert(kWarps * 3 * kTN <= kWarps * kPlane, "dx partials alias");
}  // namespace bwd16

constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Sums v[0..15] over the warp by recursive halving, in a fixed order (the
// same bits every run); returns, in lane l, the sum of v[(l >> 1) & 15].
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
#pragma unroll
  for (int half = 8; half >= 1; half >>= 1) {
    const bool up = lane & (2 * half);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = up ? v[i + half] : v[i];
      const float send = up ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kParts>
__global__ void __launch_bounds__(bwd16::kThreads, bwd16::kMinCtas)
conv_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ part, int S) {
  using namespace bwd16;
  extern __shared__ float4 smem4[];
  float4* xs = smem4;                  // kHN: x0, x1, x2, inside the image
  float4* gs = smem4 + kHN;            // kAN: g0, g1, g2, own pixel
  float* planes = reinterpret_cast<float*>(smem4 + kHN + kAN);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kR;
  const int c0 = blockIdx.x * kC;
  const __nv_bfloat16* xb = x + (size_t)b * S * S * 3;
  const __nv_bfloat16* gb = g + (size_t)b * S * S * 3;

  // x on the tile + 2 (x plane (hr, hc) is image pixel (r0 - 2 + hr,
  // c0 - 2 + hc)), g on the tile + 1 (g plane (ar, ac) is (r0 - 1 + ar,
  // c0 - 1 + ac)); zero off the image. A thread's pixels of both planes are
  // loaded before any is stored, so that all its loads are in flight at
  // once.
  constexpr int kXIt = (kHN + kThreads - 1) / kThreads;
  constexpr int kGIt = (kAN + kThreads - 1) / kThreads;
  float4 xin[kXIt], gin[kGIt];
#pragma unroll
  for (int k = 0; k < kXIt; ++k) {
    const int p = t + k * kThreads;
    const int hr = p / kHC;
    const int r = r0 - 2 + hr;
    const int c = c0 - 2 + p - hr * kHC;
    xin[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < kHN && r >= 0 && r < S && c >= 0 && c < S) {
      const __nv_bfloat16* px = xb + ((size_t)r * S + c) * 3;
      xin[k] = make_float4(to_f(px[0]), to_f(px[1]), to_f(px[2]), 1.f);
    }
  }
#pragma unroll
  for (int k = 0; k < kGIt; ++k) {
    const int p = t + k * kThreads;
    const int ar = p / kAC;
    const int ac = p - ar * kAC;
    const int r = r0 - 1 + ar;
    const int c = c0 - 1 + ac;
    gin[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < kAN && r >= 0 && r < S && c >= 0 && c < S) {
      const __nv_bfloat16* pg = gb + ((size_t)r * S + c) * 3;
      const bool own = ar >= 1 && ar <= kR && ac >= 1 && ac <= kC;
      gin[k] = make_float4(to_f(pg[0]), to_f(pg[1]), to_f(pg[2]),
                           own ? 1.f : 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < kXIt; ++k)
    if (t + k * kThreads < kHN) xs[t + k * kThreads] = xin[k];
#pragma unroll
  for (int k = 0; k < kGIt; ++k)
    if (t + k * kThreads < kAN) gs[t + k * kThreads] = gin[k];
  __syncthreads();

  float* hp = planes + warp * kPlane;  // h, the tile + 2
  float* dp = hp + kHN;                // dacc, the tile + 1
  float* d1 = dp + kAN;                // gelu'(a1), the tile
  float* prow = part + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *
                            gridDim.x + blockIdx.x) * kPartRow;
  float dxa[kBlocks][kRB][3];
#pragma unroll
  for (int k = 0; k < kBlocks; ++k)
#pragma unroll
    for (int o = 0; o < kRB; ++o)
#pragma unroll
      for (int m = 0; m < 3; ++m) dxa[k][o][m] = 0.f;

#pragma unroll 1
  for (int k = 0; k < kHidden / kWarps; ++k) {
    const int ch = warp + kWarps * k;
    const float w10 = __ldg(w1 + ch * 3), w11 = __ldg(w1 + ch * 3 + 1),
                w12 = __ldg(w1 + ch * 3 + 2), b1c = __ldg(b1 + ch);
    float wdc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) wdc[i] = __ldg(wd + i * kHidden + ch);
    const float bdc = __ldg(bd + ch), w20 = __ldg(w2 + ch),
                w21 = __ldg(w2 + kHidden + ch),
                w22 = __ldg(w2 + 2 * kHidden + ch);

    // A: h on the tile + 2, zero off the image; gelu'(a1) on the tile (at
    // tile index tp; -1 off the tile). Plane columns 0-31 a lane each, row
    // by row; then the last four columns, a lane a pixel.
    auto h_pixel = [&](int p, int tp) {
      const float4 xv = xs[p];
      const float a = fmaf(w12, xv.z, fmaf(w11, xv.y, fmaf(w10, xv.x, b1c)));
      float e;
      const float q = half_erfc(a, e);
      const float hv = (kParts & kRecompute)
                           ? fmaf(-fabsf(a), q, fmaxf(a, 0.f)) : a;
      hp[p] = rnd_bf16(hv) * xv.w;
      if ((kParts & kDgelu1) && tp >= 0)
        d1[tp] = fmaf(a * kInvSqrt2Pi, e, cdf_from(a, q));
    };
#pragma unroll 4
    for (int hr = 0; hr < kHR; ++hr) {
      const int tr = hr - 2;
      h_pixel(hr * kHC + lane,
              tr >= 0 && tr < kR && lane >= 2 ? tr * kC + lane - 2 : -1);
    }
    for (int q = lane; q < kHR * (kHC - 32); q += 32) {
      const int hr = q / (kHC - 32);
      const int hc = 32 + q % (kHC - 32);
      const int tr = hr - 2;
      h_pixel(hr * kHC + hc,
              tr >= 0 && tr < kR && hc < kC + 2 ? tr * kC + hc - 2 : -1);
    }
    __syncwarp();

    // B: acc and dacc on the tile + 1 (h plane (ar + 1, ac + 1) is acc
    // plane (ar, ac)); the own pixels' dbd and dw2 sums. Plane columns 0-31
    // a lane each, kBR rows at a time from kBR + 2 rows of h; then the last
    // two columns, a lane a pixel.
    float s[kWG];
#pragma unroll
    for (int i = 0; i < kWG; ++i) s[i] = 0.f;
    auto dacc_pixel = [&](int p, float acc) {
      const float4 gv = gs[p];
      const float dg2 = fmaf(w22, gv.z, fmaf(w21, gv.y, w20 * gv.x));
      float e;
      const float cdf = cdf_from(acc, half_erfc(acc, e));
      const float dacc = (kParts & kDgelu2)
                             ? dg2 * fmaf(acc * kInvSqrt2Pi, e, cdf) : dg2;
      dp[p] = dacc;
      if (kParts & kWdots) {
        const float g2 = ((kParts & kRecompute) ? acc * cdf : acc) * gv.w;
        s[9] = fmaf(dacc, gv.w, s[9]);
        s[14] = fmaf(g2, gv.x, s[14]);
        s[15] = fmaf(g2, gv.y, s[15]);
        s[16] = fmaf(g2, gv.z, s[16]);
      }
    };
#pragma unroll 1
    for (int ar0 = 0; ar0 < kAR; ar0 += kBR) {
      float acc[kBR];
#pragma unroll
      for (int o = 0; o < kBR; ++o)
        acc[o] = (kParts & kRecompute)
                     ? bdc : hp[(ar0 + o + 1) * kHC + lane + 1];
      if (kParts & kRecompute) {
        // h plane row ar0 + i serves acc row o with tap row a = i - o.
#pragma unroll
        for (int bb = 0; bb < 3; ++bb)
#pragma unroll
          for (int i = 0; i < kBR + 2; ++i) {
            const float v = hp[(ar0 + i) * kHC + lane + bb];
#pragma unroll
            for (int o = 0; o < kBR; ++o) {
              const int a = i - o;
              if (a >= 0 && a <= 2) acc[o] = fmaf(v, wdc[a * 3 + bb], acc[o]);
            }
          }
      }
#pragma unroll
      for (int o = 0; o < kBR; ++o) dacc_pixel((ar0 + o) * kAC + lane, acc[o]);
    }
    for (int q = lane; q < kAR * (kAC - 32); q += 32) {
      const int ar = q / (kAC - 32);
      const int ac = 32 + q % (kAC - 32);
      const float* hq = hp + ar * kHC + ac;
      float acc = hq[kHC + 1];
      if (kParts & kRecompute) {
        acc = bdc;
#pragma unroll
        for (int bb = 0; bb < 3; ++bb)
#pragma unroll
          for (int a = 0; a < 3; ++a)
            acc = fmaf(hq[a * kHC + bb], wdc[a * 3 + bb], acc);
      }
      dacc_pixel(ar * kAC + ac, acc);
    }
    __syncwarp();

    // C: lane = tile column; dacc plane (tr + 1, tc + 1), h plane
    // (tr + 2, tc + 2) and x plane (tr + 2, tc + 2) are tile pixel (tr, tc).
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int tr0 = blk * kRB;
      float dh[kRB], dac[kRB];
#pragma unroll
      for (int o = 0; o < kRB; ++o) dh[o] = 0.f;
      // dh(p) = sum_ab dacc(p - (a - 1, b - 1)) wd[a][b]: dacc plane row
      // tr0 + i serves output row o with a = o + 2 - i, column lane + bb
      // with b = 2 - bb.
#pragma unroll
      for (int bb = 0; bb < 3; ++bb)
#pragma unroll
        for (int i = 0; i < kRB + 2; ++i) {
          const float v = dp[(tr0 + i) * kAC + lane + bb];
          if (bb == 1 && i >= 1 && i <= kRB) dac[i - 1] = v;
#pragma unroll
          for (int o = 0; o < kRB; ++o) {
            const int a = o + 2 - i;
            if (a >= 0 && a <= 2) dh[o] = fmaf(v, wdc[a * 3 + 2 - bb], dh[o]);
          }
        }
      if (!(kParts & kDh)) {
#pragma unroll
        for (int o = 0; o < kRB; ++o) dh[o] = dac[o];
      }
      // dwd[a][b] += dacc(p) h(p + (a - 1, b - 1)): h plane row
      // tr0 + 1 + i serves output row o with a = i - o.
      if (kParts & kWdots) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb)
#pragma unroll
          for (int i = 0; i < kRB + 2; ++i) {
            const float hv = hp[(tr0 + 1 + i) * kHC + lane + 1 + bb];
#pragma unroll
            for (int o = 0; o < kRB; ++o) {
              const int a = i - o;
              if (a >= 0 && a <= 2)
                s[a * 3 + bb] = fmaf(dac[o], hv, s[a * 3 + bb]);
            }
          }
      }
#pragma unroll
      for (int o = 0; o < kRB; ++o) {
        const float4 xv = xs[(tr0 + o + 2) * kHC + lane + 2];
        float da1 = dh[o] * xv.w;   // zero off the image
        if (kParts & kDgelu1) da1 *= d1[(tr0 + o) * kC + lane];
        if (kParts & kWdots) {
          s[10] = fmaf(da1, xv.x, s[10]);
          s[11] = fmaf(da1, xv.y, s[11]);
          s[12] = fmaf(da1, xv.z, s[12]);
          s[13] += da1;
        }
        dxa[blk][o][0] = fmaf(w10, da1, dxa[blk][o][0]);
        dxa[blk][o][1] = fmaf(w11, da1, dxa[blk][o][1]);
        dxa[blk][o][2] = fmaf(w12, da1, dxa[blk][o][2]);
      }
    }

    // The channel's 17 sums over the warp, into the CTA's partial row.
    float v16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v16[i] = s[i];
    const float total = warp_sum16(v16, lane);
    const float last = warp_sum(s[16]);
    const bool wdots = kParts & kWdots;
    if ((lane & 1) == 0)
      prow[ch * kWG + ((lane >> 1) & 15)] = wdots ? total : 0.f;
    if (lane == 1) prow[ch * kWG + 16] = wdots ? last : 0.f;
    __syncwarp();   // the next channel rewrites the planes
  }

  // dx: the warps' partials (over the planes, which every warp is done
  // with), added in warp order.
  __syncthreads();
  float* dxp = planes;   // [warp][3][kTN]
#pragma unroll
  for (int blk = 0; blk < kBlocks; ++blk)
#pragma unroll
    for (int o = 0; o < kRB; ++o)
#pragma unroll
      for (int m = 0; m < 3; ++m)
        dxp[(warp * 3 + m) * kTN + (blk * kRB + o) * kC + lane] =
            dxa[blk][o][m];
  __syncthreads();
  for (int p = t; p < kTN; p += kThreads) {
    const int r = r0 + p / kC;
    const int c = c0 + p % kC;
    if (r >= S || c >= S) continue;
    __nv_bfloat16* pd = dx + (((size_t)b * S + r) * S + c) * 3;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += dxp[(w * 3 + m) * kTN + p];
      pd[m] = __float2bfloat16(v);
    }
  }
}

dim3 bwd_bf16_grid(int B, int S) {
  return dim3((S + bwd16::kC - 1) / bwd16::kC,
              (S + bwd16::kR - 1) / bwd16::kR, B);
}

template <int kParts>
cudaError_t launch_bf16(const void* x, const void* g, const float* w1,
                        const float* b1, const float* wd, const float* bd,
                        const float* w2, void* dx, float* part, int B, int S,
                        cudaStream_t stream) {
  static bool configured = false;   // the attribute is per function
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bwd_bf16_kernel<kParts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bwd16::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_bwd_bf16_kernel<kParts><<<bwd_bf16_grid(B, S), bwd16::kThreads,
                                  bwd16::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), w1, b1, wd, bd, w2,
      static_cast<__nv_bfloat16*>(dx), part, S);
  return cudaGetLastError();
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

}  // namespace

// The number of partial rows (CTAs) the backward writes for (B, S) in the
// compute type (bf16 if is_bf16); each row holds 32 x 17 fp32 sums.
extern "C" int conv_residual_bwd_rows(int is_bf16, int B, int S) {
  const dim3 grid = is_bf16 ? bwd_bf16_grid(B, S) : bwd_f32_grid(B, S);
  return (int)(grid.x * grid.y * grid.z);
}

// The bf16 backward's launch geometry for (B, S): out[0..2] the grid,
// out[3] the threads a CTA, out[4] the dynamic shared memory a CTA.
extern "C" void conv_residual_bwd_bf16_geometry(int B, int S, int* out) {
  const dim3 g = bwd_bf16_grid(B, S);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = (int)g.z;
  out[3] = bwd16::kThreads;
  out[4] = (int)bwd16::kSmem;
}

// Returns a cudaError_t (0 on success). x, g, dx: (B,S,S,3) contiguous NHWC
// in the compute type; w1 (32,3), b1 (32), wd (3,3,32), bd (32), w2 (3,32)
// fp32; part: conv_residual_bwd_rows(is_bf16, B, S) x 544 fp32.
extern "C" int conv_residual_bwd(int is_bf16, const void* x, const void* g,
                                 const float* w1, const float* b1,
                                 const float* wd, const float* bd,
                                 const float* w2, void* dx, float* part,
                                 int B, int S, void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_bf16<kAll>(x, g, w1, b1, wd, bd, w2, dx, part, B, S,
                                  st);
  conv_residual_bwd_kernel<<<bwd_f32_grid(B, S), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), w1, b1, wd,
      bd, w2, static_cast<float*>(dx), part, S);
  return (int)cudaGetLastError();
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
// above): all parts (31, the production kernel), or all but one. For
// timing only; the variants compute something else on purpose.
extern "C" int conv_residual_bwd_ablate(int parts, const void* x,
                                        const void* g, const float* w1,
                                        const float* b1, const float* wd,
                                        const float* bd, const float* w2,
                                        void* dx, float* part, int B, int S,
                                        void* stream) {
  if (B < 1 || B > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALM_ABLATE_CASE(P)                                                 \
  case P:                                                                   \
    return (int)launch_bf16<P>(x, g, w1, b1, wd, bd, w2, dx, part, B, S, st);
  switch (parts) {
    CALM_ABLATE_CASE(kAll)
    CALM_ABLATE_CASE(kAll & ~kRecompute)
    CALM_ABLATE_CASE(kAll & ~kDgelu2)
    CALM_ABLATE_CASE(kAll & ~kWdots)
    CALM_ABLATE_CASE(kAll & ~kDh)
    CALM_ABLATE_CASE(kAll & ~kDgelu1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CALM_ABLATE_CASE
}

// What the card makes of each backward kernel, in this order: fp32, bf16
// (production), the weight-grad sum. For kernel k, out[4k..4k+3] =
// registers a thread, local (spill) bytes a thread, static + dynamic shared
// memory a CTA, CTAs resident per SM. Returns a cudaError_t.
extern "C" int conv_residual_bwd_occupancy(int* out) {
  const void* fns[3] = {
      reinterpret_cast<const void*>(conv_residual_bwd_kernel),
      reinterpret_cast<const void*>(conv_bwd_bf16_kernel<kAll>),
      reinterpret_cast<const void*>(conv_wgrad_sum_kernel)};
  const int threads[3] = {kThreads, bwd16::kThreads, 256};
  const size_t dyn[3] = {0, bwd16::kSmem, 0};
  for (int k = 0; k < 3; ++k) {
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
