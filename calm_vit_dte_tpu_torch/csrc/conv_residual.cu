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
// flagship step at B=128; twice that in fp32), and is memory-bound by far.
// The 32-channel hidden tensor otherwise never reaches device memory. In
// practice the forward is bound by instruction issue on the CUDA cores: per
// pixel 480 FMAs and 64 GELUs, plus the first GELU on the recomputed halo;
// it is not a product the tensor cores can take (the depthwise taps are per
// channel, and the W1 and W2 products must stay fp32).
//
// Design (conv_fwd_kernel<T, kSave>, one source for both compute types):
// one CTA of 256 threads (8 warps) per (image, 64-row x 16-column output
// tile; 32 x 16 for fp32 with residuals, below), every published conv S
// being a multiple of 16, so no column is idle there. The 32 hidden
// channels go in two passes of 16:
//   1 (thread per halo pixel): h = gelu(W1 x + b1) in the compute type, on
//     the tile's one-pixel halo (zero off the image), into shared memory, a
//     pixel in four chunks of four channels: in bf16 8-byte chunks, chunk j
//     at slot j ^ ((column >> 2) & 3); in fp32 16-byte chunks in order and
//     a fifth of padding (an 80-byte pixel stride, odd in 16-byte units).
//     Either way sixteen neighbouring columns read one chunk without a
//     bank conflict (swizzle_conflict_free, a static_assert for both
//     types); the fp32 layout also makes every chunk address the pixel's
//     base plus a constant, where the swizzle held 12 chunk offsets in
//     registers. The bf16 forward with residuals also stores the tile's own
//     h, 16 channels in two 16-byte stores a pixel;
//   2 (thread per 4 rows of one column, 2 for fp32 with residuals): for
//     each chunk, the 3 x 3 taps as register-blocked chunk reads (each bf16
//     pair widened to fp32 by a shift and a mask; fp32 read as it is), 6
//     rows x 3 columns serving 4 outputs x 4 channels, the second GELU and
//     the W2 product into y held in registers across both passes; the
//     saved acc goes out eight channels (a 32-byte sector) a row at a time:
//     one 16-byte store in bf16, two back-to-back in fp32, the first chunk
//     of the pair kept meanwhile in a stash of shared memory private to the
//     thread (stored chunk by chunk, half a sector a store, the fp32
//     forward with residuals ran 1.6x slower).
// In fp32 the tile's own h leaves after phase 1's barrier, copied from
// shared memory four lanes a pixel, so that a warp writes whole 64-byte
// runs (stored from phase 1, 16 bytes at a time, it ran 1.24x slower).
// Three barriers a tile. Only the GELU, the rounding, the layout of h and
// the stores of h and acc differ by type: bf16 rounds h to bf16 and
// evaluates both GELUs through half_erfc (one exp, one reciprocal); fp32
// keeps h in fp32 and both GELUs exact (erff, 25 lane-ops a GELU).
// Registers are capped by the CTAs an SM each launch bound asks for
// (fwd::min_ctas). The bf16 forward is held to 80 registers so that three
// CTAs (24 warps) share an SM (__launch_bounds__(256, 3), no spills); the
// bf16 forward with residuals keeps 128 (two CTAs): at 80 it spilled 40
// bytes and ran 32% slower. The fp32 h (95,040 bytes a pass) leaves room
// for two CTAs only. The fp32 forward with residuals takes 32-row tiles, 2
// rows a thread (kRSaveF32, kRBSaveF32): at 64 rows its addresses spilled
// 16-72 bytes under the 128 registers of two CTAs. Shared memory a CTA
// (fwd_smem: h, the fp32 stash, 2,192 bytes of weights):
//   bf16 forward: 40208 bytes, 3 CTAs per SM
//   bf16 forward with residuals: 40208 bytes, 2 CTAs per SM
//   fp32 forward: 97232 bytes, 2 CTAs per SM
//   fp32 forward with residuals: 59344 bytes, 2 CTAs per SM
// (232,448 bytes a CTA at most). For the bf16 route, h held as fp32 ran
// as fast at two CTAs as h held as bf16, and the bf16 layout at three
// CTAs took 7.7% off the flagship forward.
// For the fp32 forward, 32 x 16 tiles (4 or 2 rows a thread) and 16 x 16
// tiles ran no faster at B=8 and up to 10% slower at hires-cls-1024's S,
// B=8 (NVIDIA H100 80GB HBM3; PERF.md, section 6).

#include "conv_residual_common.cuh"

#include <cstddef>

namespace {

using namespace conv_residual;

namespace fwd {
constexpr int kR = 64, kC = 16;              // output tile
constexpr int kRB = 4;                       // output rows a thread
constexpr int kRSaveF32 = 32;                // fp32 with residuals: 32 rows,
constexpr int kRBSaveF32 = 2;                // 2 a thread
constexpr int kHC = kC + 2;                  // halo columns: 18
constexpr int kThreads = (kR / kRB) * kC;    // 256
constexpr int kPass = 16;                    // channels a pass
constexpr int kChunks = kPass / 4;           // chunks of 4 channels a pixel
constexpr int kMinCtasBf16 = 3;              // CTAs an SM: the bf16 forward
constexpr int kMinCtasSaveBf16 = 2;          // ... with residuals
constexpr int kMinCtasF32 = 2;               // the fp32 forward
constexpr int kMinCtasSaveF32 = 2;           // ... with residuals
static_assert(kThreads == 256 && kHidden == 2 * kPass &&
                  (kRSaveF32 / kRBSaveF32) * kC == kThreads,
              "geometry");

// The tile of each instantiation: fp32 with residuals takes 32-row tiles,
// 2 rows a thread, so that its acc and y take 14 registers fewer than at
// 4 rows (at 64 x 16, with the padding and fresh() below, it still spilled
// 28 bytes).
template <typename T, bool kSave>
constexpr bool kSmallTile = kSave && !kIsBf16<T>;
template <typename T, bool kSave>
constexpr int kRows = kSmallTile<T, kSave> ? kRSaveF32 : kR;
template <typename T, bool kSave>
constexpr int kRowsA = kSmallTile<T, kSave> ? kRBSaveF32 : kRB;
template <typename T, bool kSave>
constexpr int kHaloN = (kRows<T, kSave> + 2) * kHC;   // halo pixels

// The CTAs an SM each instantiation's launch bound asks for.
__host__ __device__ constexpr int min_ctas(bool bf16, bool save) {
  return bf16 ? (save ? kMinCtasSaveBf16 : kMinCtasBf16)
              : (save ? kMinCtasSaveF32 : kMinCtasF32);
}

// A halo pixel's chunk of 4 channels in shared memory.
template <typename T>
using Chunk = std::conditional_t<kIsBf16<T>, uint2, float4>;
// Chunks a halo pixel takes in shared memory: its four in bf16, whose slots
// the swizzle below permutes; four and one of padding in fp32, an 80-byte
// pixel stride, odd in 16-byte units, so that every chunk of a pixel is
// its base plus a constant (with the swizzle, the fp32 kernel held 12
// chunk offsets in registers it could not spare: the forward with
// residuals spilled 40-72 bytes).
template <typename T>
constexpr int kPixChunks = kIsBf16<T> ? kChunks : kChunks + 1;
template <typename T, bool kSave>
constexpr size_t kSmemH =                      // h of a pass
    sizeof(Chunk<T>) * kHaloN<T, kSave> * kPixChunks<T>;
// fp32 with residuals also stashes each thread's first chunk of a chunk
// pair (16 bytes a row), so that the pair leaves in two back-to-back
// 16-byte stores (a whole 32-byte sector) without holding it in registers.
template <typename T, bool kSave>
constexpr size_t kSmem =
    kSmemH<T, kSave> +
    (kSmallTile<T, kSave> ? sizeof(float4) * kRBSaveF32 * kThreads : 0);

// bf16: 1 << kLineShift pixels of a halo row in one 128-byte bank line,
// the swizzle's period.
constexpr int kLineShift = 2;
static_assert((1 << kLineShift) * kChunks * sizeof(uint2) == 128,
              "bf16: 4 pixels a bank line");

// The slot of chunk j of a halo pixel in column hc >= 0: swizzled in bf16,
// in order in fp32.
template <typename T>
__host__ __device__ constexpr int chunk_slot(int j, int hc) {
  if constexpr (kIsBf16<T>) return j ^ ((hc >> kLineShift) & 3);
  else return j;
}

// A warp reads a chunk in phases of 128 / sizeof(chunk) lanes (16 lanes of
// 8 bytes, 8 lanes of 16): true when the lanes of every phase, neighbouring
// columns of one halo row from any first column, read chunk j of their
// pixels from distinct units of a 128-byte bank line (bf16 by the swizzle,
// fp32 by the odd pixel stride).
template <typename T>
constexpr bool swizzle_conflict_free() {
  constexpr int kUnits = 128 / (int)sizeof(Chunk<T>);
  for (int c0 = 0; c0 < kHC; ++c0)
    for (int j = 0; j < kChunks; ++j)
      for (int a = 0; a < kUnits; ++a)
        for (int b = a + 1; b < kUnits; ++b) {
          const int ua = (c0 + a) * kPixChunks<T> + chunk_slot<T>(j, c0 + a);
          const int ub = (c0 + b) * kPixChunks<T> + chunk_slot<T>(j, c0 + b);
          if (ua % kUnits == ub % kUnits) return false;
        }
  return true;
}
static_assert(swizzle_conflict_free<__nv_bfloat16>(), "bf16 swizzle");
static_assert(swizzle_conflict_free<float>(), "fp32 padding");
static_assert(kSmem<__nv_bfloat16, true> == 38016 &&
                  kSmem<float, false> == 95040 &&
                  kSmem<float, true> == 57152,
              "fwd_smem");
}  // namespace fwd

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

// h of four channels from their a = W1 x + b1, in the compute type.
template <typename T>
__device__ __forceinline__ fwd::Chunk<T> h_chunk(float a0, float a1,
                                                 float a2, float a3) {
  if constexpr (kIsBf16<T>)
    return make_uint2(pack_bf16x2(gelu_bf16(a0), gelu_bf16(a1)),
                      pack_bf16x2(gelu_bf16(a2), gelu_bf16(a3)));
  else
    return make_float4(gelu(a0), gelu(a1), gelu(a2), gelu(a3));
}

__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }

// v, as a value the fp32 compiler may not take for loop-invariant: what
// the fp32 forward with residuals derives from it (the h copy's and the
// acc stores' addresses) is computed where it is used, not held across the
// pass loop in registers that two CTAs an SM cannot spare (held, they
// spilled 24 bytes at 32-row tiles). bf16: v itself, the code unchanged.
template <typename T>
__device__ __forceinline__ int fresh(int v) {
  if constexpr (!kIsBf16<T>) asm volatile("" : "+r"(v));
  return v;
}

// The second GELU, of the compute type's route.
template <typename T>
__device__ __forceinline__ float gelu_of(float x) {
  if constexpr (kIsBf16<T>) return gelu_bf16(x);
  else return gelu(x);
}

// w1, b1 (32,3), (32); wd (3,3,32) [wd[a][b][c] = OIHW w[c][0][a][b]]; bd
// (32); w2 (3,32); b2 (3); all fp32. x, y (B,S,S,3) and, when kSave, h_out,
// acc_out (B,S,S,32) in the compute type T.
template <typename T, bool kSave>
__global__ void __launch_bounds__(fwd::kThreads,
                                  fwd::min_ctas(kIsBf16<T>, kSave))
conv_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ y, T* __restrict__ h_out,
    T* __restrict__ acc_out, int S) {
  using namespace fwd;
  constexpr int kR = kRows<T, kSave>, kRB = kRowsA<T, kSave>;
  constexpr int kHN = kHaloN<T, kSave>;
  using C = Chunk<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* hs = reinterpret_cast<C*>(smem_raw);     // kHN pixels x kPixChunks
  // [kRB][kThreads], fp32 with residuals only
  float4* stash = reinterpret_cast<float4*>(smem_raw + kSmemH<T, kSave>);
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
  const T* xb = x + (size_t)b * S * S * 3;

  // Phase 2's thread: rows orow..orow+3 of column ocol.
  const int col = t % kC;
  const int rg = t / kC;
  const int orow = r0 + rg * kRB;
  const int ocol = c0 + col;
  const bool active = orow < S && ocol < S;
  constexpr int kPix = kPixChunks<T>;          // chunks a halo pixel
  const C* hrow = hs + (rg * kRB * kHC + col) * kPix;

  float yv[kRB][3];
#pragma unroll
  for (int o = 0; o < kRB; ++o)
#pragma unroll
    for (int m = 0; m < 3; ++m) yv[o][m] = sb2[m];

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int q0 = pass * kChunks;   // first channel quad of the pass
    const int tp = fresh<T>(t);
    if (pass) __syncthreads();       // phase 2 of pass 0 has read hs

    // Phase 1: h on the halo, zero off the image.
#pragma unroll 2
    for (int p = tp; p < kHN; p += kThreads) {
      const int hr = p / kHC;
      const int hc = p - hr * kHC;
      const int r = r0 - 1 + hr;
      const int c = c0 - 1 + hc;
      C* dst = hs + p * kPix;
      if (r >= 0 && r < S && c >= 0 && c < S) {
        const T* px = xb + ((size_t)r * S + c) * 3;
        const float x0 = to_f(px[0]), x1 = to_f(px[1]), x2 = to_f(px[2]);
        C packed[kChunks];
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const float4 wa = w1t[0][q0 + j], wb = w1t[1][q0 + j],
                       wc = w1t[2][q0 + j], bq = b1q[q0 + j];
          const float a0 = fmaf(wc.x, x2, fmaf(wb.x, x1, fmaf(wa.x, x0, bq.x)));
          const float a1 = fmaf(wc.y, x2, fmaf(wb.y, x1, fmaf(wa.y, x0, bq.y)));
          const float a2 = fmaf(wc.z, x2, fmaf(wb.z, x1, fmaf(wa.z, x0, bq.z)));
          const float a3 = fmaf(wc.w, x2, fmaf(wb.w, x1, fmaf(wa.w, x0, bq.w)));
          packed[j] = h_chunk<T>(a0, a1, a2, a3);
          dst[chunk_slot<T>(j, hc)] = packed[j];
        }
        // The halo belongs to the neighbouring tiles: only the tile's own
        // pixels are saved (fp32: after the barrier, from shared memory).
        if constexpr (kSave && kIsBf16<T>) {
          if (hr >= 1 && hr <= kR && hc >= 1 && hc <= kC) {
            uint4* ph = reinterpret_cast<uint4*>(
                h_out + (((size_t)b * S + r) * S + c) * kHidden +
                pass * kPass);
            ph[0] = make_uint4(packed[0].x, packed[0].y, packed[1].x,
                               packed[1].y);
            ph[1] = make_uint4(packed[2].x, packed[2].y, packed[3].x,
                               packed[3].y);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunks; ++j) dst[j] = C{};
      }
    }
    __syncthreads();

    // fp32 with residuals: the tile's own h of the pass from shared memory,
    // four lanes a pixel, so that a warp writes eight whole 64-byte runs.
    if constexpr (kSave && !kIsBf16<T>) {
      // A thread's chunk j and column stay; its row steps by kCopyRows.
      constexpr int kCopyRows = kThreads / (kC * kChunks);
      const int j = tp % kChunks;
      const int hc = (tp / kChunks) % kC + 1;
      int r = r0 + tp / (kC * kChunks);
      const C* src = hs + ((r - r0 + 1) * kHC + hc) * kPix + j;
      float4* dst = reinterpret_cast<float4*>(
          h_out + (((size_t)b * S + r) * S + c0 - 1 + hc) * kHidden +
          pass * kPass + 4 * j);
      const bool col_in = c0 - 1 + hc < S;
#pragma unroll 1
      for (; r < r0 + kR && r < S; r += kCopyRows) {
        if (col_in) *dst = *src;
        src += kCopyRows * kHC * kPix;
        dst += (size_t)kCopyRows * S * (kHidden / 4);
      }
    }

    // Phase 2: for each pair of chunks (8 channels), acc of 4 rows x 8
    // channels, then the second GELU and W2 into y.
    if (active) {
#pragma unroll
      for (int jp = 0; jp < kChunks / 2; ++jp) {
        uint32_t av[kRB][4];   // bf16: acc of the 8 channels, bf16 pairs
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
            const C* src = hrow + bb * kPix + chunk_slot<T>(j, col + bb);
#pragma unroll
            for (int i = 0; i < kRB + 2; ++i) {
              const float4 v = widen(src[i * kHC * kPix]);
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
            const float g0 = gelu_of<T>(acc[o][0]),
                        g1 = gelu_of<T>(acc[o][1]),
                        g2 = gelu_of<T>(acc[o][2]),
                        g3 = gelu_of<T>(acc[o][3]);
#pragma unroll
            for (int m = 0; m < 3; ++m)
              yv[o][m] = fmaf(wy[m].w, g3, fmaf(wy[m].z, g2,
                              fmaf(wy[m].y, g1, fmaf(wy[m].x, g0, yv[o][m]))));
            if constexpr (kSave && kIsBf16<T>) {
              av[o][2 * jj] = pack_bf16x2(acc[o][0], acc[o][1]);
              av[o][2 * jj + 1] = pack_bf16x2(acc[o][2], acc[o][3]);
            } else if constexpr (kSave) {
              const float4 a4 = make_float4(acc[o][0], acc[o][1], acc[o][2],
                                            acc[o][3]);
              const int ro = fresh<T>(orow + o);
              if (jj == 0) {
                stash[o * kThreads + t] = a4;
              } else if (ro < S) {
                float4* pa = reinterpret_cast<float4*>(
                    acc_out + (((size_t)b * S + ro) * S + ocol) * kHidden +
                    pass * kPass + jp * 8);
                pa[0] = stash[o * kThreads + t];
                pa[1] = a4;
              }
            }
          }
        }
        if constexpr (kSave && kIsBf16<T>) {
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
    T* py = y + (((size_t)b * S + orow + o) * S + ocol) * 3;
    store_f(py, yv[o][0]);
    store_f(py + 1, yv[o][1]);
    store_f(py + 2, yv[o][2]);
  }
}

template <typename T, bool kSave>
dim3 fwd_grid(int B, int S) {
  constexpr int kR = fwd::kRows<T, kSave>;
  return dim3((S + fwd::kC - 1) / fwd::kC, (S + kR - 1) / kR, B);
}

template <typename T, bool kSave>
cudaError_t launch(const void* x, const float* w1, const float* b1,
                   const float* wd, const float* bd, const float* w2,
                   const float* b2, void* y, void* h, void* acc, int B, int S,
                   cudaStream_t stream) {
  static bool configured = false;   // the attribute is per function
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_fwd_kernel<T, kSave>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fwd::kSmem<T, kSave>);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_fwd_kernel<T, kSave><<<fwd_grid<T, kSave>(B, S), fwd::kThreads,
                              fwd::kSmem<T, kSave>, stream>>>(
      static_cast<const T*>(x), w1, b1, wd, bd, w2, b2, static_cast<T*>(y),
      static_cast<T*>(h), static_cast<T*>(acc), S);
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

// GELU(x) and, with kDeriv, GELU'(x) of n fp32 values as the fp32 route
// computes them (conv_residual_common.cuh); the SASS of the two gives the
// fp32 GELU's lane-op count (tools/time_conv.py --sass).
template <bool kDeriv>
__global__ void gelu_f32_probe_kernel(const float* __restrict__ x, int n,
                                      float* __restrict__ gelu_out,
                                      float* __restrict__ dgelu_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  const float cdf = cdf_exact(v);
  gelu_out[i] = v * cdf;
  if (kDeriv) dgelu_out[i] = dgelu_from(v, cdf);
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

// The launch geometry of the forward (with residuals if save) for (B, S)
// in the compute type (bf16 if is_bf16): out[0..2] the grid, out[3] the
// threads a CTA, out[4] the dynamic shared memory a CTA.
template <typename T, bool kSave>
void geometry(int B, int S, int* out) {
  const dim3 g = fwd_grid<T, kSave>(B, S);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = (int)g.z;
  out[3] = fwd::kThreads;
  out[4] = (int)fwd::kSmem<T, kSave>;
}

extern "C" void conv_residual_fwd_geometry(int is_bf16, int save, int B,
                                           int S, int* out) {
  if (is_bf16 && save) geometry<__nv_bfloat16, true>(B, S, out);
  else if (is_bf16) geometry<__nv_bfloat16, false>(B, S, out);
  else if (save) geometry<float, true>(B, S, out);
  else geometry<float, false>(B, S, out);
}

// What the card makes of each forward instantiation, in this order: fp32,
// fp32 with residuals, bf16, bf16 with residuals. For kernel k, out[4k..4k+3]
// = registers a thread, local (spill) bytes a thread, static + dynamic
// shared memory a CTA, CTAs resident per SM. Returns a cudaError_t.
extern "C" int conv_residual_fwd_occupancy(int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(conv_fwd_kernel<float, false>),
      reinterpret_cast<const void*>(conv_fwd_kernel<float, true>),
      reinterpret_cast<const void*>(conv_fwd_kernel<__nv_bfloat16, false>),
      reinterpret_cast<const void*>(conv_fwd_kernel<__nv_bfloat16, true>)};
  const size_t dyn[4] = {fwd::kSmem<float, false>, fwd::kSmem<float, true>,
                         fwd::kSmem<__nv_bfloat16, false>,
                         fwd::kSmem<__nv_bfloat16, true>};
  for (int k = 0; k < 4; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn[k]);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fns[k]);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[k],
                                                        fwd::kThreads, dyn[k]);
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

// GELU(x) and GELU'(x) (dgelu_out null: GELU alone) of n fp32 values as the
// fp32 kernels compute them.
extern "C" int conv_residual_gelu_f32_probe(const float* x, int n,
                                            float* gelu_out, float* dgelu_out,
                                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dgelu_out)
    gelu_f32_probe_kernel<true><<<grid, 256, 0, st>>>(x, n, gelu_out,
                                                       dgelu_out);
  else
    gelu_f32_probe_kernel<false><<<grid, 256, 0, st>>>(x, n, gelu_out,
                                                        nullptr);
  return cudaGetLastError();
}
