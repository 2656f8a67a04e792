// Backward of the fused axial attention (in-kernel RoPE, learned additive
// mask), written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernels built by
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_rope_fused (backward
//   pallas_call, body _make_rope_kernels.bwd_kernel on top of _bwd_core) and,
//   as its Dr == 0 case, ::_make_fused (backward pallas_call, _bwd_kernel).
//
// Computes, per batch element, with g = dL/dout (B,H,S,Dv):
//   rebuild q = [qc | rope(qr)], k = [kc | rope(kr)]; recompute scores, ssum,
//   h1 = ssum W1^T + b1, a = gelu(h1), m = a W2^T + b2, p = softmax(scale *
//   scores + m) as the forward does;
//   dv_h = p_h^T g_h;  dp_h = g_h v_h^T;  dl_h = p_h * (dp_h - rowsum(dp_h p_h))
//   dm = sum_h dl_h;  da = dm W2;  dW2 = dm^T a;  db2 = colsum(dm)
//   dh1 = da * gelu'(h1);  dW1 = dh1^T ssum;  db1 = colsum(dh1);  dssum = dh1 W1
//   ds_h = scale * dl_h + dssum;  dq_h = ds_h k_h;  dk_h = ds_h^T q_h
//   content halves of dq/dk out as they are; rope halves un-rotated,
//   d_r = g_r cos - rot_half(g_r sin); table grads dcos = sum_{b,h} x_r g_r,
//   dsin = sum_{b,h} rot_half(x_r) g_r for q and k.
// Rounding follows _bwd_core: p, dm, a, dh1 and ds are rounded to the compute
// type before their products, every product accumulates in fp32, dq is
// written in the compute type, everything else in fp32. gelu' is exact.
//
// What bounds it on the H100: at the flagship's widest shape (B=128, H=12,
// S=224, D=Dv=56, bf16) about 3x the forward's work, 86 GFLOP (87 us at 989
// TFLOP/s), against 347 MB of q, k, v, g read and dq, dk, dv written (104 us
// at 3.35 TB/s): memory-bound by the roofline. This first version is far from
// that: all products are fp32 FMAs on the CUDA cores, one CTA of 8 warps per
// SM, and it trades device-memory scratch for simplicity and determinism.
//
// Design (no atomics anywhere, so results are the same from run to run):
//   * Reductions over query tiles (dk, dv). CUDA blocks run in no order, so
//     the TPU grid's "carry a sum to the next step" becomes a loop inside the
//     block: one CTA per batch element walks its query tiles of 32 rows in
//     turn and adds each tile's p^T g and ds^T q into fp32 device buffers
//     that only it touches. Each (key, column) is owned by the same thread in
//     every tile, so the read-modify-write needs no fence. When the loop
//     ends, the CTA un-rotates its dk and forms its k-side table terms.
//   * The heads are coupled through ssum and dssum, so each tile makes three
//     passes over the heads: (1) scores -> ssum, then the mask MLP; (2)
//     scores -> p, dp, dl; dv += p^T g; dm += dl; dl goes to an fp32 scratch
//     (B,H,S,S) that the same thread reads back in pass 3; then the MLP
//     backward gives dssum; (3) ds = scale*dl + dssum -> dq (with the q-side
//     un-rotation and table terms) and dk += ds^T q.
//   * Reductions over the batch (dW1, dW2, db1, db2, the four tables). The
//     main kernel writes ssum, a, dm, dh1 (compute type) and per-batch table
//     terms; a second kernel forms X^T Y over the B*S rows in 64x64 output
//     tiles with the rows split over CTAs, and a third sums the splits (and
//     the per-batch table terms) in a fixed order.
//   * W1/W2 and their transposes (fp32, rounded on load) stream from L1/L2 as
//     in the forward; lanes always read consecutive columns.

#include "attention_common.cuh"

namespace {

__device__ __forceinline__ float dgelu(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// Pointer slots of the argument array (the wrapper fills the same order).
enum Slot {
  kQc, kKc, kQr, kKr, kV, kG, kCosQ, kSinQ, kCosK, kSinK,
  kW1, kW1t, kB1, kW2, kW2t, kB2,
  kDqc, kDqr, kDkc, kDkr, kDv, kTabOut, kWGrad,
  kTabPart, kDkFull, kDlog, kGprime, kSsum, kA, kDm, kDh1, kWPart,
  kSlots
};

template <typename T>
struct Args {
  const T *qc, *kc, *qr, *kr, *v, *g;
  const float *cos_q, *sin_q, *cos_k, *sin_k;
  const float *w1, *w1t, *b1, *w2, *w2t, *b2;
  T *dqc, *dqr;
  float *dkc, *dkr, *dv;
  float *tab_part;  // (B, 4, S, Dr): cos_q, sin_q, cos_k, sin_k terms
  float *dk_full;   // (B, H, S, D) fp32 dk before the un-rotation
  float *dlog;      // (B, H, S, S) fp32 dl
  float *gprime;    // (B, S, 2S) gelu'(h1)
  T *ssum, *a, *dm, *dh1;  // (B,S,S), (B,S,2S), (B,S,S), (B,S,2S)
  int H, S, Dc, Dr, Dv, use_mask;
  float scale;
};

// out[k * dim + d] (+)= sum_i sA[i * lda + k] * sB[i * ldb + d] over the
// tile's kTq rows i, for k < S and d < dim <= 64. The thread that owns
// (k, d) is the same in every call, so `out` needs no synchronisation.
__device__ void accumulate_t(float* out, int dim, const float* sA, int lda,
                             const float* sB, int ldb, int S, bool first) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has0 = lane < dim;
  const bool has1 = lane + 32 < dim;
  for (int k0 = warp * 4; k0 < S; k0 += kWarps * 4) {
    float o[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = 0.f;
    for (int i = 0; i < kTq; ++i) {
      const float b0 = has0 ? sB[i * ldb + lane] : 0.f;
      const float b1 = has1 ? sB[i * ldb + lane + 32] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = sA[i * lda + k0 + j];
        o[j][0] = fmaf(a, b0, o[j][0]);
        o[j][1] = fmaf(a, b1, o[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      if (k >= S) continue;
      float* row = out + (size_t)k * dim;
      if (has0) row[lane] = first ? o[j][0] : row[lane] + o[j][0];
      if (has1) row[lane + 32] = first ? o[j][1] : row[lane + 32] + o[j][1];
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
rope_attention_bwd_kernel(const Args<T> A) {
  extern __shared__ float smem[];
  constexpr int SP = NC * 32;  // key count padded to whole lanes
  const int H = A.H, S = A.S, Dc = A.Dc, Dr = A.Dr, Dv = A.Dv;
  const int D = Dc + Dr;
  const int half = Dr / 2;
  const int ld = D | 1;
  const int ldv = Dv | 1;
  const int ldq = ld > ldv ? ld : ldv;
  const int S2 = 2 * S;
  const bool use_mask = A.use_mask != 0;
  const float scale = A.scale;
  float* sQ = smem;               // kTq x ldq   q tile, then g tile
  float* sKV = sQ + kTq * ldq;    // SP x ldq    k_h, then v_h
  float* sM = sKV + SP * ldq;     // kTq x SP    ssum, m, dm, then dssum
  float* sP = sM + kTq * SP;      // kTq x 2SP   a, p, dh1, then ds
  float* sD = sP + kTq * 2 * SP;  // kTq x ld    dq rows, for the partner column

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const size_t bh0 = (size_t)b * H;
  auto head = [&](const T* base, int h, int dim) -> const T* {
    return base ? base + (bh0 + h) * S * dim : nullptr;
  };
  const bool has0 = lane < D;
  const bool has1 = lane + 32 < D;

  for (int q0 = 0; q0 < S; q0 += kTq) {
    const bool first = q0 == 0;
    const size_t row0 = (size_t)b * S + q0 + r0;  // this warp's first row

    if (use_mask) {
      // Pass 1: head-summed scores, in registers.
      float acc[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
      for (int h = 0; h < H; ++h) {
        __syncthreads();
        load_rows<T>(sQ, ld, kTq, q0, S, head(A.qc, h, Dc), head(A.qr, h, Dr),
                     A.cos_q, A.sin_q, Dc, Dr, D);
        load_rows<T>(sKV, ld, SP, 0, S, head(A.kc, h, Dc), head(A.kr, h, Dr),
                     A.cos_k, A.sin_k, Dc, Dr, D);
        __syncthreads();
        qk<NC>(acc, sQ, sKV, ld, D, r0, lane);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const bool live = q0 + r0 + i < S;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          const float val = rnd<T>(acc[i][c]);
          sM[(r0 + i) * SP + k] = val;
          if (live && k < S) A.ssum[(row0 + i) * S + k] = from_f<T>(val);
        }
      }
      __syncwarp();

      // Mask MLP forward on the warp's own 4 rows: h1 -> a, gelu'(h1).
      float hacc[kRows][2 * NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) hacc[i][c] = 0.f;
      for (int k = 0; k < S; ++k) {
        float sv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) sv[i] = sM[(r0 + i) * SP + k];
        const float* wrow = A.w1t + (size_t)k * S2;
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) {
          const int j = lane + 32 * c;
          const float w = j < S2 ? rnd<T>(__ldg(wrow + j)) : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            hacc[i][c] = fmaf(sv[i], w, hacc[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) {
        const int j = lane + 32 * c;
        if (j < S2) {
          const float bj = __ldg(A.b1 + j);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float h1 = hacc[i][c] + bj;
            const float av = rnd<T>(gelu(h1));
            sP[(r0 + i) * 2 * SP + j] = av;
            if (q0 + r0 + i < S) {
              A.a[(row0 + i) * S2 + j] = from_f<T>(av);
              A.gprime[(row0 + i) * S2 + j] = dgelu(h1);
            }
          }
        }
      }
      __syncwarp();

      float macc[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) macc[i][c] = 0.f;
      for (int j = 0; j < S2; ++j) {
        float av[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = sP[(r0 + i) * 2 * SP + j];
        const float* wrow = A.w2t + (size_t)j * S;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          const float w = k < S ? rnd<T>(__ldg(wrow + k)) : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            macc[i][c] = fmaf(av[i], w, macc[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int k = lane + 32 * c;
        const float bk = k < S ? __ldg(A.b2 + k) : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) sM[(r0 + i) * SP + k] = macc[i][c] + bk;
      }
    }

    // Pass 2: per head p, dp, dl; dv += p^T g; dm += dl.
    float dmacc[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) dmacc[i][c] = 0.f;
    for (int h = 0; h < H; ++h) {
      __syncthreads();  // the previous head is done with sQ, sKV and sP
      load_rows<T>(sQ, ld, kTq, q0, S, head(A.qc, h, Dc), head(A.qr, h, Dr),
                   A.cos_q, A.sin_q, Dc, Dr, D);
      load_rows<T>(sKV, ld, SP, 0, S, head(A.kc, h, Dc), head(A.kr, h, Dr),
                   A.cos_k, A.sin_k, Dc, Dr, D);
      __syncthreads();
      float acc[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
      qk<NC>(acc, sQ, sKV, ld, D, r0, lane);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {  // fp32 softmax, kept unrounded
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          float x = -INFINITY;
          if (k < S) {
            x = acc[i][c] * scale;
            if (use_mask) x += sM[(r0 + i) * SP + k];
          }
          acc[i][c] = x;
          mx = fmaxf(mx, x);
        }
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float e = lane + 32 * c < S ? expf(acc[i][c] - mx) : 0.f;
          acc[i][c] = e;
          sum += e;
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] / sum;
      }
      __syncthreads();  // every warp is done with q_h and k_h

      load_rows<T>(sQ, ldv, kTq, q0, S, head(A.g, h, Dv), nullptr, nullptr,
                   nullptr, Dv, 0, Dv);
      load_rows<T>(sKV, ldv, SP, 0, S, head(A.v, h, Dv), nullptr, nullptr,
                   nullptr, Dv, 0, Dv);
      __syncthreads();
      float dp[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dp[i][c] = 0.f;
      qk<NC>(dp, sQ, sKV, ldv, Dv, r0, lane);  // g_h v_h^T
      float* dlh = A.dlog + (bh0 + h) * S * S;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float delta = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) delta = fmaf(dp[i][c], acc[i][c], delta);
        delta = warp_sum(delta);
        const int q = q0 + r0 + i;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          const float dl = acc[i][c] * (dp[i][c] - delta);
          dmacc[i][c] += dl;
          if (q < S && k < S) dlh[(size_t)q * S + k] = dl;
          sP[(r0 + i) * SP + k] = rnd<T>(acc[i][c]);
        }
      }
      __syncthreads();  // p of all 32 rows is in sP
      accumulate_t(A.dv + (bh0 + h) * S * Dv, Dv, sP, SP, sQ, ldv, S, first);
    }
    __syncthreads();  // the last head's dv product is done with sP

    if (use_mask) {
      // Mask MLP backward on the warp's own rows: dm -> da -> dh1 -> dssum.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const bool live = q0 + r0 + i < S;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          const float val = k < S ? rnd<T>(dmacc[i][c]) : 0.f;
          sM[(r0 + i) * SP + k] = val;
          if (live && k < S) A.dm[(row0 + i) * S + k] = from_f<T>(val);
        }
      }
      __syncwarp();
      float hacc[kRows][2 * NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) hacc[i][c] = 0.f;
      for (int k = 0; k < S; ++k) {  // da = dm W2, W2 (S, 2S) row-major
        float sv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) sv[i] = sM[(r0 + i) * SP + k];
        const float* wrow = A.w2 + (size_t)k * S2;
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) {
          const int j = lane + 32 * c;
          const float w = j < S2 ? rnd<T>(__ldg(wrow + j)) : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            hacc[i][c] = fmaf(sv[i], w, hacc[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) {
        const int j = lane + 32 * c;
        if (j < S2) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float dh = 0.f;
            if (q0 + r0 + i < S) {
              dh = rnd<T>(hacc[i][c] * A.gprime[(row0 + i) * S2 + j]);
              A.dh1[(row0 + i) * S2 + j] = from_f<T>(dh);
            }
            sP[(r0 + i) * 2 * SP + j] = dh;
          }
        }
      }
      __syncwarp();
      float macc[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) macc[i][c] = 0.f;
      for (int j = 0; j < S2; ++j) {  // dssum = dh1 W1, W1 (2S, S) row-major
        float av[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = sP[(r0 + i) * 2 * SP + j];
        const float* wrow = A.w1 + (size_t)j * S;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          const float w = k < S ? rnd<T>(__ldg(wrow + k)) : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            macc[i][c] = fmaf(av[i], w, macc[i][c]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          sM[(r0 + i) * SP + lane + 32 * c] = macc[i][c];
    }

    // Pass 3: ds -> dq (un-rotated, with the q-side table terms), dk += ds^T q.
    float tcos[kRows][2], tsin[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      tcos[i][0] = tcos[i][1] = tsin[i][0] = tsin[i][1] = 0.f;
    for (int h = 0; h < H; ++h) {
      __syncthreads();  // the previous head is done with sQ, sKV and sP
      load_rows<T>(sQ, ld, kTq, q0, S, head(A.qc, h, Dc), head(A.qr, h, Dr),
                   A.cos_q, A.sin_q, Dc, Dr, D);
      load_rows<T>(sKV, ld, SP, 0, S, head(A.kc, h, Dc), head(A.kr, h, Dr),
                   A.cos_k, A.sin_k, Dc, Dr, D);
      const float* dlh = A.dlog + (bh0 + h) * S * S;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = q0 + r0 + i;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          float ds = 0.f;
          if (q < S && k < S) {
            ds = scale * dlh[(size_t)q * S + k];
            if (use_mask) ds += sM[(r0 + i) * SP + k];
            ds = rnd<T>(ds);
          }
          sP[(r0 + i) * SP + k] = ds;
        }
      }
      __syncthreads();  // q_h, k_h and ds of all 32 rows are in place

      float o[kRows][2];
#pragma unroll
      for (int i = 0; i < kRows; ++i) o[i][0] = o[i][1] = 0.f;
      for (int k = 0; k < S; ++k) {
        const float k0 = has0 ? sKV[k * ld + lane] : 0.f;
        const float k1 = has1 ? sKV[k * ld + lane + 32] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float dsv = sP[(r0 + i) * SP + k];
          o[i][0] = fmaf(dsv, k0, o[i][0]);
          o[i][1] = fmaf(dsv, k1, o[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (has0) sD[(r0 + i) * ld + lane] = o[i][0];
        if (has1) sD[(r0 + i) * ld + lane + 32] = o[i][1];
      }
      __syncwarp();
      const T* qrh = head(A.qr, h, Dr);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = q0 + r0 + i;
        if (q >= S) continue;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const int d = lane + 32 * slot;
          if (d >= D) continue;
          const float gv = o[i][slot];
          if (d < Dc) {
            A.dqc[((bh0 + h) * S + q) * Dc + d] = from_f<T>(gv);
            continue;
          }
          const int e = d - Dc;
          const int pe = e < half ? e + half : e - half;
          const float gp = rnd<T>(sD[(r0 + i) * ld + Dc + pe]);
          const float t1 = rnd<T>(rnd<T>(gv) * rnd<T>(A.cos_q[q * Dr + e]));
          const float t2 = rnd<T>(gp * rnd<T>(A.sin_q[q * Dr + pe]));
          A.dqr[((bh0 + h) * S + q) * Dr + e] =
              from_f<T>(t1 - (e < half ? -t2 : t2));
          const float x = to_f(qrh[(size_t)q * Dr + e]);
          const float xp = to_f(qrh[(size_t)q * Dr + pe]);
          tcos[i][slot] = fmaf(x, gv, tcos[i][slot]);
          tsin[i][slot] = fmaf(e < half ? -xp : xp, gv, tsin[i][slot]);
        }
      }
      accumulate_t(A.dk_full + (bh0 + h) * S * D, D, sP, SP, sQ, ld, S,
                   first);
    }
    if (Dr > 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = q0 + r0 + i;
        if (q >= S) continue;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const int d = lane + 32 * slot;
          if (d < Dc || d >= D) continue;
          const size_t at = (size_t)q * Dr + d - Dc;
          A.tab_part[((size_t)b * 4 + 0) * S * Dr + at] = tcos[i][slot];
          A.tab_part[((size_t)b * 4 + 1) * S * Dr + at] = tsin[i][slot];
        }
      }
    }
  }

  if (Dr == 0) return;  // dk_full is dkc itself
  __syncthreads();      // dk_full of this batch element is complete
  for (int idx = threadIdx.x; idx < S * D; idx += kThreads) {
    const int s = idx / D;
    const int d = idx - s * D;
    if (d < Dc) {
      for (int h = 0; h < H; ++h)
        A.dkc[((bh0 + h) * S + s) * Dc + d] =
            A.dk_full[((bh0 + h) * S + s) * D + d];
      continue;
    }
    const int e = d - Dc;
    const int pe = e < half ? e + half : e - half;
    const float cv = rnd<T>(A.cos_k[s * Dr + e]);
    const float sv = rnd<T>(A.sin_k[s * Dr + pe]);
    float acc_c = 0.f, acc_s = 0.f;
    for (int h = 0; h < H; ++h) {
      const float* grow = A.dk_full + ((bh0 + h) * S + s) * D + Dc;
      const float gv = grow[e];
      const float t1 = rnd<T>(rnd<T>(gv) * cv);
      const float t2 = rnd<T>(rnd<T>(grow[pe]) * sv);
      A.dkr[((bh0 + h) * S + s) * Dr + e] =
          rnd<T>(t1 - (e < half ? -t2 : t2));
      const T* krh = A.kr + ((bh0 + h) * S + s) * Dr;
      const float x = to_f(krh[e]);
      const float xp = to_f(krh[pe]);
      acc_c = fmaf(x, gv, acc_c);
      acc_s = fmaf(e < half ? -xp : xp, gv, acc_s);
    }
    const size_t at = (size_t)s * Dr + e;
    A.tab_part[((size_t)b * 4 + 2) * S * Dr + at] = acc_c;
    A.tab_part[((size_t)b * 4 + 3) * S * Dr + at] = acc_s;
  }
}

// Weight grads over the B*S rows: for the rows of split z,
//   out[z][m][n] = sum_r X[r][m] * Y[r][n],   col[z][m] = sum_r X[r][m],
// X (R, M) and Y (R, N) in the compute type, 64x64 output tile per CTA, each
// thread a 4x4 micro-tile, rows staged through shared memory 16 at a time.
constexpr int kWTile = 64;
constexpr int kWChunk = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
xty_kernel(const T* __restrict__ X, const T* __restrict__ Y, int R, int M,
           int N, int rows_per_split, float* __restrict__ out,
           float* __restrict__ col, size_t split_stride) {
  __shared__ float sX[kWChunk][kWTile];
  __shared__ float sY[kWChunk][kWTile];
  const int m0 = blockIdx.x * kWTile;
  const int n0 = blockIdx.y * kWTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kWChunk) {
    for (int idx = threadIdx.x; idx < kWChunk * kWTile; idx += kThreads) {
      const int rr = idx / kWTile;
      const int cc = idx - rr * kWTile;
      const int r = r0 + rr;
      sX[rr][cc] = r < r_end && m0 + cc < M
                       ? to_f(X[(size_t)r * M + m0 + cc]) : 0.f;
      sY[rr][cc] = r < r_end && n0 + cc < N
                       ? to_f(Y[(size_t)r * N + n0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWChunk; ++rr) {
      float x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        x[a] = sX[rr][ty * 4 + a];
        y[a] = sY[rr][tx * 4 + a];
        cs[a] += x[a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
    }
    __syncthreads();
  }
  float* o = out + blockIdx.z * split_stride;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty * 4 + a;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) o[(size_t)m * N + n] = acc[a][c];
    }
    if (blockIdx.y == 0 && tx == 0) col[blockIdx.z * split_stride + m] = cs[a];
  }
}

// out[i] = sum over the leading axis of part (n_lead, n), in order.
__global__ void reduce_leading_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int n_lead,
                                      size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int l = 0; l < n_lead; ++l) s += part[(size_t)l * n + i];
  out[i] = s;
}

template <typename T, int NC>
cudaError_t launch_main(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr int SP = NC * 32;
  const int ld = (a.Dc + a.Dr) | 1;
  const int ldv = a.Dv | 1;
  const int ldq = ld > ldv ? ld : ldv;
  const size_t smem =
      sizeof(float) * ((size_t)kTq * ldq + (size_t)SP * ldq +
                       (size_t)kTq * SP + (size_t)kTq * 2 * SP +
                       (size_t)kTq * ld);
  auto kern = rope_attention_bwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(void* const* p, int B, int H, int S, int Dc, int Dr, int Dv,
                float scale, int use_mask, int splits, cudaStream_t st) {
  auto in = [&](int slot) { return static_cast<const T*>(p[slot]); };
  auto f32 = [&](int slot) { return static_cast<float*>(p[slot]); };
  Args<T> a;
  a.qc = in(kQc); a.kc = in(kKc); a.qr = in(kQr); a.kr = in(kKr);
  a.v = in(kV); a.g = in(kG);
  a.cos_q = f32(kCosQ); a.sin_q = f32(kSinQ);
  a.cos_k = f32(kCosK); a.sin_k = f32(kSinK);
  a.w1 = f32(kW1); a.w1t = f32(kW1t); a.b1 = f32(kB1);
  a.w2 = f32(kW2); a.w2t = f32(kW2t); a.b2 = f32(kB2);
  a.dqc = static_cast<T*>(p[kDqc]); a.dqr = static_cast<T*>(p[kDqr]);
  a.dkc = f32(kDkc); a.dkr = f32(kDkr); a.dv = f32(kDv);
  a.tab_part = f32(kTabPart); a.dk_full = f32(kDkFull); a.dlog = f32(kDlog);
  a.gprime = f32(kGprime);
  a.ssum = static_cast<T*>(p[kSsum]); a.a = static_cast<T*>(p[kA]);
  a.dm = static_cast<T*>(p[kDm]); a.dh1 = static_cast<T*>(p[kDh1]);
  a.H = H; a.S = S; a.Dc = Dc; a.Dr = Dr; a.Dv = Dv; a.use_mask = use_mask;
  a.scale = scale;

  cudaError_t err;
#define CASE(N)                          \
  case N:                                \
    err = launch_main<T, N>(a, B, st);   \
    break;
  switch ((S + 31) / 32) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
  if (err != cudaSuccess) return err;

  if (Dr > 0) {
    const size_t n = (size_t)4 * S * Dr;
    reduce_leading_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        a.tab_part, f32(kTabOut), B, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (use_mask) {
    // Flat layout of the weight grads: dW1 (2S,S) | db1 (2S) | dW2 (S,2S) |
    // db2 (S); the partial buffer holds `splits` such vectors.
    const int S2 = 2 * S, R = B * S;
    const size_t total = (size_t)2 * S2 * S + S2 + S;
    const int rows = (R + splits - 1) / splits;
    float* part = f32(kWPart);
    const size_t o_dw1 = 0, o_db1 = (size_t)S2 * S, o_dw2 = o_db1 + S2,
                 o_db2 = o_dw2 + (size_t)S * S2;
    auto tiles = [](int n) { return (unsigned)((n + kWTile - 1) / kWTile); };
    xty_kernel<T><<<dim3(tiles(S2), tiles(S), splits), kThreads, 0, st>>>(
        a.dh1, a.ssum, R, S2, S, rows, part + o_dw1, part + o_db1, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    xty_kernel<T><<<dim3(tiles(S), tiles(S2), splits), kThreads, 0, st>>>(
        a.dm, a.a, R, S, S2, rows, part + o_dw2, part + o_db2, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_leading_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, f32(kWGrad), splits, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t (0 on success). `ptrs` holds kSlots device pointers
// in the order of enum Slot; a slot may be null where its tensor does not
// exist (content halves when Dc == 0, rope halves and tables when Dr == 0,
// everything of the mask MLP when use_mask == 0). Inputs as in
// rope_attention_fwd plus g (B,H,S,Dv) in the compute type, w1 (2S,S), w2
// (S,2S) and their transposes in fp32. Outputs: dqc/dqr in the compute type;
// dkc, dkr, dv, the tables (4,S,Dr) and the flat weight grads in fp32. The
// scratch buffers are described at struct Args; the weight-grad partial
// buffer holds `splits` copies of the flat weight grads. When Dr == 0 the dkc
// and dk_full slots hold the same buffer. All contiguous.
extern "C" int rope_attention_bwd(int is_bf16, void* const* ptrs, int B,
                                  int H, int S, int Dc, int Dr, int Dv,
                                  float scale, int use_mask, int splits,
                                  void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > 256 || Dc < 0 || Dr < 0 || Dr % 2 ||
      Dc + Dr < 1 || Dc + Dr > 64 || Dv < 1 || Dv > kMaxDv || splits < 1 ||
      (Dr == 0 && ptrs[kDkc] != ptrs[kDkFull]))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(ptrs, B, H, S, Dc, Dr, Dv, scale, use_mask,
                                   splits, st);
  return (int)run<float>(ptrs, B, H, S, Dc, Dr, Dv, scale, use_mask, splits,
                         st);
}
