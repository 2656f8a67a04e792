// The fp32 rope attention route's own kernels and pointer slots. The route
// (kernels/axial_attention.py::_launch_f32, ::_launch_bwd_f32) runs the
// function of csrc/axial_attention{,_bwd}.cu in fp32 on the CUDA cores; its
// C entries, rope_attention_fwd_f32 (hires_attention.cu) and
// rope_attention_bwd_f32 (hires_attention_bwd.cu), sit beside the hires
// CUDA-core kernels they launch, and these kernels do the rest: the
// rotation of q and k (prologue), delta = rowsum(g * o) and the
// un-rotation of dq and dk with the table gradients. Every sum runs in a
// fixed order (no atomics).
#pragma once

#include "attention_common.cuh"

namespace {

// Slots of the route's pointer array (the wrapper fills the same order);
// a slot is null where its tensor does not exist (content halves when Dc
// == 0, rope halves and tables when Dr == 0, the mask MLP's tensors
// without the mask, the backward's when only the forward runs).
enum RopeF32Slot {
  // inputs (B,H,S,Dc), (B,H,S,Dr), (B,H,S,Dv), tables (S,Dr), W1 (2S,S),
  // b1 (2S), W2 (S,2S), b2 (S)
  rQc, rKc, rQr, rKr, rV, rG, rCosQ, rSinQ, rCosK, rSinK, rW1, rB1, rW2, rB2,
  // the forward's output (B,H,S,Dv) and its scratch or residuals: q and k
  // rotated (B,H,S,DP); ssum (B,S,S), a and gelu'(h1) (B,S,2S), m (B,S,S);
  // lse and delta (B,H,S)
  rOut, rQp, rKp, rSsum, rA, rGp, rM, rLse, rDelta,
  // the backward's scratch: dm, dssum (B,S,S), dh1 (B,S,2S), dq and dk
  // before the un-rotation (B,H,S,DP), the weight grads' scratch
  // (hires_weight_grads_scratch(0, S) floats)
  rDm, rDssum, rDh1, rDq, rDk, rWPart,
  // the backward's outputs: dqc, dkc (B,H,S,Dc), dqr, dkr (B,H,S,Dr), dv
  // (B,H,S,Dv), the table grads (4,S,Dr), the flat weight grads dW1 | db1 |
  // dW2 | db2
  rDqc, rDqr, rDkc, rDkr, rDv, rTab, rWGrad,
  rSlots
};

inline int pad4(int x) { return (x + 3) / 4 * 4; }

// One side of the prologue: rows (B*H*S) of [content | rotated rope] fp32
// into dst (B*H*S, DP), zero-padded to DP (a multiple of 4) columns.
struct PrepF32 {
  const float *c, *r, *cs, *sn;
  float* dst;
};

// q (blockIdx.y 0) or k (1) rotated as the plain version rounds it: x * cos
// and rot(x) * sin each rounded, then their sum (no fused multiply-add).
// The two sides are two parameters, selected field by field, so nothing is
// indexed in parameter space.
__global__ void __launch_bounds__(256) rope_prep_f32_kernel(
    const PrepF32 q, const PrepF32 k, size_t rows, int S, int Dc, int Dr,
    int DP) {
  const bool ks = blockIdx.y != 0;
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= rows * DP) return;
  const size_t row = idx / DP;
  const int d = (int)(idx - row * DP);
  float v = 0.f;
  if (d < Dc) {
    v = (ks ? k.c : q.c)[row * Dc + d];
  } else if (d < Dc + Dr) {
    const int e = d - Dc, half = Dr / 2, s = (int)(row % S);
    const float* x = (ks ? k.r : q.r) + row * Dr;
    const float xr = e < half ? -x[e + half] : x[e - half];
    v = __fadd_rn(__fmul_rn(x[e], (ks ? k.cs : q.cs)[s * Dr + e]),
                  __fmul_rn(xr, (ks ? k.sn : q.sn)[s * Dr + e]));
  }
  (ks ? k.dst : q.dst)[idx] = v;
}

// delta[r] = sum_c g[r][c] * o[r][c] over Dv columns, for rows (B*H*S):
// one warp a row, lanes striding the columns, a fixed shuffle tree.
__global__ void __launch_bounds__(256) rope_delta_kernel(
    const float* __restrict__ g, const float* __restrict__ o,
    float* __restrict__ delta, size_t rows, int Dv) {
  const size_t r = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp
  float s = 0.f;
  for (int c = lane; c < Dv; c += 32)
    s = fmaf(g[r * Dv + c], o[r * Dv + c], s);
  s = warp_sum(s);
  if (lane == 0) delta[r] = s;
}

// One side of the un-rotation: grad (B*H, S, DP) fp32 before it; x the
// un-rotated rope half (B*H, S, Dr); out_c (B*H, S, Dc) and out_r (B*H, S,
// Dr); tabs (2, S, Dr): the side's cos and sin table gradients.
struct UnrotF32 {
  const float *grad, *x, *cs, *sn;
  float *out_c, *out_r, *tabs;
};

// q (blockIdx.y 0) or k (1). The thread of (s, column d < Dc + Dr) walks
// the B*H heads in order: a content column is copied; a rope column e is
// un-rotated, d_r[e] = g[e] cos[e] -/+ g[pe] sin[pe] (pe its rotation
// partner, R^T = -R), and adds x[e] g[e] and rot(x)[e] g[e] to the table
// gradients.
__global__ void __launch_bounds__(256) rope_unrotate_f32_kernel(
    const UnrotF32 q, const UnrotF32 k, int BH, int S, int Dc, int Dr,
    int DP) {
  const bool ks = blockIdx.y != 0;
  const float* __restrict__ grad = ks ? k.grad : q.grad;
  const int D = Dc + Dr;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= S * D) return;
  const int s = idx / D, d = idx - s * D;
  if (d < Dc) {
    float* __restrict__ out_c = ks ? k.out_c : q.out_c;
#pragma unroll 8
    for (int bh = 0; bh < BH; ++bh) {
      const size_t row = (size_t)bh * S + s;
      out_c[row * Dc + d] = grad[row * DP + d];
    }
    return;
  }
  const float* __restrict__ x = ks ? k.x : q.x;
  float* __restrict__ out_r = ks ? k.out_r : q.out_r;
  const int e = d - Dc, half = Dr / 2;
  const bool low = e < half;
  const int pe = low ? e + half : e - half;
  const float cv = (ks ? k.cs : q.cs)[s * Dr + e];
  const float sv = (ks ? k.sn : q.sn)[s * Dr + pe];
  float tc = 0.f, ts = 0.f;
#pragma unroll 8
  for (int bh = 0; bh < BH; ++bh) {
    const size_t row = (size_t)bh * S + s;
    const float gv = grad[row * DP + Dc + e];
    const float gp = grad[row * DP + Dc + pe];
    const float xe = x[row * Dr + e], xp = x[row * Dr + pe];
    const float t1 = __fmul_rn(gv, cv), t2 = __fmul_rn(gp, sv);
    out_r[row * Dr + e] = low ? __fadd_rn(t1, t2) : __fsub_rn(t1, t2);
    tc = fmaf(xe, gv, tc);
    ts = fmaf(low ? -xp : xp, gv, ts);
  }
  float* tabs = ks ? k.tabs : q.tabs;
  tabs[s * Dr + e] = tc;
  tabs[(size_t)S * Dr + s * Dr + e] = ts;
}

// What the card makes of the three kernels above: kernel k (prologue,
// delta, un-rotation) fills out[4k..4k+3] as occupancy() does
// (attention_common.cuh).
constexpr int kF32RouteKernels = 3;
inline cudaError_t f32_route_occupancy(int* out) {
  const void* fns[kF32RouteKernels] = {
      reinterpret_cast<const void*>(rope_prep_f32_kernel),
      reinterpret_cast<const void*>(rope_delta_kernel),
      reinterpret_cast<const void*>(rope_unrotate_f32_kernel)};
  for (int k = 0; k < kF32RouteKernels; ++k) {
    const cudaError_t err = occupancy(fns[k], 256, 0, out + 4 * k);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
