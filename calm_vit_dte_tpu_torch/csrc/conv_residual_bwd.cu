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
// Design (conv_bwd_kernel<T, kParts>, one source for both compute types):
// one CTA of 8 warps per (image, 16-row x 32-column output tile). x is
// staged on the tile + 2 halo and g on the tile + 1 halo as float4 (the 4th
// lane: 1 inside the image, and for g 1 on the tile's own pixels only),
// read in the compute type and widened, behind the only barrier before the
// channels. Then each warp owns 4 of the 32 hidden channels (warp, warp +
// 8, ...) and takes them one at a time through three phases on planes of
// its own in shared memory, so no barrier but __syncwarp separates them:
//   A (20 x 36, a lane a column, then the last 4 columns a lane a pixel):
//     h = gelu(a1) (rounded to bf16 in bf16), zero off the image; on the
//     tile also gelu'(a1), sharing the GELU's exp and reciprocal (bf16) or
//     its erff, with one expf more (fp32);
//   B (18 x 34, a lane a column 6 rows at a time, each h read serving up to
//     3 rows; then the last 2 columns): acc by the 9 taps, dg2 = W2^T g,
//     dacc = dg2 gelu'(acc) (zero off the image, since g is); on the tile's
//     own pixels the dbd and dw2 sums, g2 = gelu(acc) sharing gelu'(acc)'s
//     exp (bf16) or erff (fp32);
//   C (lane per column, 2 blocks of 8 rows): dh by the flipped taps and the
//     dwd sums, each as register-blocked reads of 10 rows x 3 columns;
//     da1 = dh gelu'(a1); the dw1, db1 sums; dx of the lane's 16 pixels
//     accumulated in registers over the warp's channels.
// After each channel the warp adds its 17 sums over the lanes by recursive
// halving (a fixed order) and writes them to the CTA's partial row. After
// the last one, the 8 warps' dx partials meet in shared memory (over the
// planes) and are added in warp order. Weight grads without atomics: the
// partial rows are summed in a fixed order by conv_residual_wgrad_sum, so
// two runs give the same bits. No g2 or da1 changes layout between
// pixel-per-thread and channel-per-warp work.
// Only the GELU, the rounding of h and the types of x, g and dx differ by
// type: bf16 evaluates both GELUs through half_erfc and rounds h to bf16;
// fp32 keeps every GELU exact (erff) and h in fp32. The planes are fp32 in
// both. Shared memory (bwd_smem): 21,312 bytes of x and g, 59,008 of the
// eight warps' planes; at most 128 registers (__launch_bounds__(256, 2)):
//   bf16 backward: 80320 bytes, 2 CTAs per SM
//   fp32 backward: 80320 bytes, 2 CTAs per SM
// (232,448 bytes a CTA at most; 16 warps an SM). Registers, not shared
// memory, hold the backward to two CTAs (a lane's dx alone takes 48 of its
// 128), so bf16 planes would buy no third CTA and would cost a widening per
// read (not tried on the card).

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

constexpr int kWG = 17;        // weight-grad sums per hidden channel
constexpr int kWGOut = 24;     // the packed row
constexpr int kPartRow = kHidden * kWG;

// The parts of the backward (the ablation builds them in bf16 only), as scripts/ablate_conv_bwd.py names them;
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

namespace bwd {
constexpr int kR = 16, kC = 32;                 // output tile
constexpr int kHR = kR + 4, kHC = kC + 4;       // h plane: the tile + 2
constexpr int kAR = kR + 2, kAC = kC + 2;       // acc, dacc plane: + 1
constexpr int kHN = kHR * kHC;                  // 720
constexpr int kAN = kAR * kAC;                  // 612
constexpr int kTN = kR * kC;                    // 512
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMinCtasBf16 = 2;                 // CTAs an SM: bf16
constexpr int kMinCtasF32 = 2;                  // ... fp32
constexpr int kRB = 8, kBlocks = kR / kRB;      // phase C: rows a block
constexpr int kBR = 6;                          // phase B: rows a block
constexpr int kPlane = kHN + kAN + kTN;         // floats a warp
constexpr size_t kSmem = sizeof(float4) * (kHN + kAN) +
                         sizeof(float) * kWarps * kPlane;   // 80,320
static_assert(kC == 32, "phases A-C: a lane a column");
static_assert(kAR % kBR == 0, "phase B: whole blocks");
static_assert(kWarps * 3 * kTN <= kWarps * kPlane, "dx partials alias");

// The CTAs an SM each instantiation's launch bound asks for.
__host__ __device__ constexpr int min_ctas(bool bf16) {
  return bf16 ? kMinCtasBf16 : kMinCtasF32;
}
}  // namespace bwd

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

// x, g, dx (B,S,S,3) in the compute type T; w1 (32,3), b1 (32), wd
// (3,3,32), bd (32), w2 (3,32) fp32; part: one row of 32 x 17 fp32 sums a
// CTA.
template <typename T, int kParts>
__global__ void __launch_bounds__(bwd::kThreads, bwd::min_ctas(kIsBf16<T>))
conv_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ w2, T* __restrict__ dx,
    float* __restrict__ part, int S) {
  using namespace bwd;
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
  const T* xb = x + (size_t)b * S * S * 3;
  const T* gb = g + (size_t)b * S * S * 3;

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
      const T* px = xb + ((size_t)r * S + c) * 3;
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
      const T* pg = gb + ((size_t)r * S + c) * 3;
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
      if constexpr (kIsBf16<T>) {
        float e;
        const float q = half_erfc(a, e);
        const float hv = (kParts & kRecompute)
                             ? fmaf(-fabsf(a), q, fmaxf(a, 0.f)) : a;
        hp[p] = rnd_bf16(hv) * xv.w;
        if ((kParts & kDgelu1) && tp >= 0)
          d1[tp] = fmaf(a * kInvSqrt2Pi, e, cdf_from(a, q));
      } else {
        const float cdf = cdf_exact(a);   // the forward's h: a Phi(a)
        hp[p] = ((kParts & kRecompute) ? a * cdf : a) * xv.w;
        if ((kParts & kDgelu1) && tp >= 0) d1[tp] = dgelu_from(a, cdf);
      }
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
      float cdf, dgelu;
      if constexpr (kIsBf16<T>) {
        float e;
        cdf = cdf_from(acc, half_erfc(acc, e));
        dgelu = fmaf(acc * kInvSqrt2Pi, e, cdf);
      } else {
        cdf = cdf_exact(acc);
        dgelu = dgelu_from(acc, cdf);
      }
      const float dacc = (kParts & kDgelu2) ? dg2 * dgelu : dg2;
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
    T* pd = dx + (((size_t)b * S + r) * S + c) * 3;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += dxp[(w * 3 + m) * kTN + p];
      store_f(pd + m, v);
    }
  }
}

dim3 bwd_grid(int B, int S) {
  return dim3((S + bwd::kC - 1) / bwd::kC, (S + bwd::kR - 1) / bwd::kR, B);
}

template <typename T, int kParts>
cudaError_t launch(const void* x, const void* g, const float* w1,
                   const float* b1, const float* wd, const float* bd,
                   const float* w2, void* dx, float* part, int B, int S,
                   cudaStream_t stream) {
  static bool configured = false;   // the attribute is per function
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bwd_kernel<T, kParts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bwd::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_bwd_kernel<T, kParts><<<bwd_grid(B, S), bwd::kThreads, bwd::kSmem,
                               stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w1, b1, wd, bd, w2,
      static_cast<T*>(dx), part, S);
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
// compute type (bf16 if is_bf16; both types tile alike); each row holds
// 32 x 17 fp32 sums.
extern "C" int conv_residual_bwd_rows(int is_bf16, int B, int S) {
  (void)is_bf16;
  const dim3 grid = bwd_grid(B, S);
  return (int)(grid.x * grid.y * grid.z);
}

// The backward's launch geometry for (B, S), the same in both compute
// types: out[0..2] the grid, out[3] the threads a CTA, out[4] the dynamic
// shared memory a CTA.
extern "C" void conv_residual_bwd_geometry(int B, int S, int* out) {
  const dim3 g = bwd_grid(B, S);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = (int)g.z;
  out[3] = bwd::kThreads;
  out[4] = (int)bwd::kSmem;
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
    return (int)launch<__nv_bfloat16, kAll>(x, g, w1, b1, wd, bd, w2, dx,
                                            part, B, S, st);
  return (int)launch<float, kAll>(x, g, w1, b1, wd, bd, w2, dx, part, B, S,
                                  st);
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
    return (int)launch<__nv_bfloat16, P>(x, g, w1, b1, wd, bd, w2, dx, part, \
                                         B, S, st);
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
      reinterpret_cast<const void*>(conv_bwd_kernel<float, kAll>),
      reinterpret_cast<const void*>(conv_bwd_kernel<__nv_bfloat16, kAll>),
      reinterpret_cast<const void*>(conv_wgrad_sum_kernel)};
  const int threads[3] = {bwd::kThreads, bwd::kThreads, 256};
  const size_t dyn[3] = {bwd::kSmem, bwd::kSmem, 0};
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
