// Backward of the fused axial attention (in-kernel RoPE, learned additive
// mask), written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernels built by
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_rope_fused (backward
//   pallas_call at :717, body _make_rope_kernels.bwd_kernel on top of
//   _bwd_core :281) and, as its Dr == 0 case, ::_make_fused (backward
//   pallas_call at :547, _bwd_kernel).
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
// type before their products, the softmax vjp uses the fp32 p and dp, every
// product accumulates in fp32, dq is written in the compute type, everything
// else in fp32. gelu' is exact.
//
// Two routes compute the function, each deterministic (no atomics: every
// sum has one owner thread or a fixed order, so the gradients are the same
// bits on every run):
//   * bf16 (training): the rows kernel, the keys kernel and the weight-grad
//     products below, every product on the tensor cores (mma.sync.m16n8k16,
//     bf16 in, fp32 accumulate);
//   * fp32 (the card-vs-CPU parity checks): the CUDA-core kernel, one CTA per
//     batch element walking its query tiles, with an fp32 (B,H,S,S) dl
//     scratch.
//
// What bounds it on the H100: at the flagship's widest shape (B=128, H=12,
// S=224, D=Dv=56, bf16) about 3x the forward's work, 86 GFLOP (87 us at 989
// TFLOP/s), against 347 MB of q, k, v, g read and dq, dk, dv written (104 us
// at 3.35 TB/s): the bound is bytes. The earlier design ran every product as
// an fp32 FMA on 128 CTAs of 8 warps (one per batch element, one per SM),
// and wrote and re-read a 308 MB dl scratch; it took 25.5 ms at that shape.
// The bf16 route recomputes instead of storing dl (about 160 GFLOP of
// tensor-core work at that shape: q k^T four times and g v^T three times in
// the rows kernel, once each in the keys kernel), needs no (B,H,S,S) scratch
// (the largest are m and dssum, (B*S, S) fp32), and spreads the work over
// ceil(S/64) x B CTAs per kernel.
//
// bf16 route design:
//   * a prologue (rope_prep_kernel, rope_mma.cuh) writes q and k rotated and
//     rounded, v and g, each zero-padded to rows of pad16(D) or pad16(Dv)
//     elements, once per call: the kernels below load tiles by 16-byte
//     cp.async and fragments by 32-bit loads, and rotate nothing;
//   * rows kernel, grid (ceil(S/64), B), 4 warps of 16 query rows, the whole
//     key axis per warp (scores, dm and dssum as S/2 fp32 registers):
//       pass 1: ssum over the heads -> the mask MLP forward (rope_mma.cuh,
//               W1 / W2 in bf16 through two cp.async stages) -> m; writes
//               ssum and a (bf16) and m (fp32) rows;
//       pass 2: per head, two sweeps over the keys in 16-key blocks, q k^T
//               and g v^T recomputed each time: the row max and sum online,
//               with delta = rowsum(dp p) rescaled alongside, then dm +=
//               dl; writes (max, sum, delta);
//       MLP backward: dm (bf16) and the reloaded ssum tile; per chunk of 16
//               hidden units h1 is recomputed, da = dm W2, dh1 = rnd(da
//               gelu'(h1)) (written for dW1), and dssum += dh1 W1 in
//               registers; writes dm and dssum rows;
//       pass 3: per head, ds = rnd(scale dl + dssum) from the recomputed p
//               and dp, dq = ds k_h with ds taken from registers as bf16 A
//               fragments; dq is staged per warp in shared memory to pair
//               each rope column with its partner for the un-rotation, and
//               the q-side table terms are summed over the heads by the
//               thread that owns each (row, column);
//   * keys kernel, grid (ceil(S/64), B), 4 warps of 16 keys: per head the
//     warp keeps its k_h and v_h rows as A fragments and walks the query
//     rows in blocks of 64 (q, g, m and dssum blocks by cp.async and the row
//     statistics in shared memory): s^T = k q^T, p^T from m and the statistics, dp^T =
//     v g^T, dl and ds^T, then dv += p^T g and dk += ds^T q from registers;
//     dk is un-rotated through the warp's staging tile and the k-side table
//     terms summed over the heads by their owner threads;
//   * p is rebuilt everywhere as __expf(x - max) times the reciprocal of
//     the row sum (the forward's fp32 softmax on the SFU), and the online
//     statistics rescale with __expf;
//   * weight grads: dW1 = dh1^T ssum and dW2 = dm^T a over the B*S rows,
//     64 x 64 output tiles of 4 warps, rows in chunks of 32 through two
//     cp.async stages and split over CTAs; the splits, and the per-batch
//     table terms, are summed in a fixed order by a last kernel.
// Shared memory and residency (RowsSmem, KeysSmem; ptxas, sm_90a, nvcc
// 12.9: the rows kernel 255 registers from S=65 up, spilling 40-1820
// bytes at S > 96 (1444 at S=224), the keys kernel 162, the weight-grad
// kernel 72; chip_smoke.py phase 2 prints them):
//   rows at (S, D, Dv) = (224, 56, 56): 113152 bytes, 2 CTAs per SM
//   keys at (S, D, Dv) = (224, 56, 56): 71680 bytes, 3 CTAs per SM
//   rows at (S, D, Dv) = (256, 64, 64): 126464 bytes, 1 CTA per SM
//   keys at (S, D, Dv) = (256, 64, 64): 71680 bytes, 3 CTAs per SM
// so at the flagship's widest shape 8 warps per SM run the rows kernel (2
// CTAs, by shared memory and registers) and 12 the keys kernel (3 CTAs, by
// registers). At B=128 and S=224 each kernel has 4 x 128 = 512 CTAs
// (the earlier kernel: 128).

#include "attention_common.cuh"
#include "rope_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Three stages, no atomics:
//   rows kernel  (one CTA of 4 warps per 64 query rows of one batch element)
//     pass 1: ssum over the heads -> the mask MLP forward -> m; writes
//             ssum, a (bf16) and m (fp32) rows;
//     pass 2: per head, two sweeps over the keys in 16-key blocks with
//             the scores recomputed on the tensor cores: the row max and
//             sum online with delta = rowsum(dp * p) rescaled alongside,
//             then dm += dl; writes the head's (max, sum, delta) per row;
//     MLP backward: dm (bf16) -> da = dm W2 -> dh1 = rnd(da gelu'(h1)),
//             h1 recomputed -> dssum = dh1 W1 in registers; writes dm,
//             dh1 (bf16) and dssum (fp32) rows;
//     pass 3: per head, ds = rnd(scale * dl + dssum) from the recomputed
//             p and dp, dq = ds k_h from registers; the rope half of dq is
//             un-rotated through a per-warp staging tile, and the q-side
//             table terms are summed over the heads by their owner thread.
//   keys kernel (one CTA of 4 warps per 64 keys of one batch element,
//     each warp 16 keys): per head, walks the query rows in blocks of 64,
//     recomputes p^T from q, k, m and the row statistics, forms dl from
//     delta and ds with dssum, and accumulates dv = p^T g and dk = ds^T q
//     in registers; un-rotates dk and sums the k-side table terms.
//   weight grads: dW1 = dh1^T ssum and dW2 = dm^T a over the B*S rows on
//     the tensor cores, rows split over CTAs; the splits are summed in a
//     fixed order.
struct BArgs {
  const tcore::bf16 *qc, *kc, *qr, *kr, *v, *g;
  const float *cos_q, *sin_q, *cos_k, *sin_k;
  const tcore::bf16 *w1, *w2;  // (H2P, SP), (SP, H2P), rounded, padded
  const float *b1, *b2;        // (H2P) padded, (S)
  tcore::bf16 *dqc, *dqr;
  float *dkc, *dkr, *dv;
  float* tab_part;                   // (B, 4, S, Dr)
  tcore::bf16 *ssum, *a, *dm, *dh1;  // (B*S, SP), (B*S, H2P), ...
  float *m, *dssum;                  // (B*S, SP)
  float* stats;                      // (B, H, S, 3): max, sum, delta
  const tcore::bf16 *qp, *kp, *vp, *gp;  // the prologue's padded rows
  int H, S, Dc, Dr, Dv, use_mask;
  float scale;
};

// Shared memory of the rows kernel (bytes): U = max(K [SP][ld(D)] + V
// [SP][ld(Dv)], ssum and dm tiles [64][SP+8] + two weight stages), then the
// warps' fp32 dq staging tiles [16][pad16(D)+4]. q_h and g_h rows are read
// as A fragments straight from the prologue's padded rows.
struct RowsSmem {
  size_t slices, slice, bytes;
  __host__ __device__ RowsSmem(int S, int D, int Dv, bool mask) {
    using namespace tcore;
    const int SP = pad16(S);
    size_t u = (size_t)SP * (ld_bf16(D) + ld_bf16(Dv)) * 2;
    const size_t mlp = 2 * (size_t)kRowsCta * (SP + 8) * 2 +
                       2 * w_stage_elems(SP) * 2;
    if (mask && mlp > u) u = mlp;
    slice = (size_t)16 * (pad16(D) + 4) * 4;
    slices = u;
    bytes = u + kWarps4 * slice;
  }
};

// Shared memory of the keys kernel (bytes): q and g blocks [64][ld], m and
// dssum blocks fp32 [64][68] (with the mask), row statistics [64][4], and
// the warps' fp32 dk staging tiles [16][pad16(D)+4]. k_h and v_h rows are
// read as A fragments straight from the prologue's padded rows.
struct KeysSmem {
  size_t gb, mb, db, st, slices, slice, bytes;
  __host__ __device__ KeysSmem(int S, int D, int Dv, bool mask) {
    using namespace tcore;
    gb = (size_t)kRowsCta * ld_bf16(D) * 2;
    mb = gb + (size_t)kRowsCta * ld_bf16(Dv) * 2;
    const size_t blk = mask ? (size_t)kRowsCta * 68 * 4 : 0;
    db = mb + blk;
    st = db + blk;
    slices = st + (size_t)kRowsCta * 4 * 4;
    slice = (size_t)16 * (pad16(D) + 4) * 4;
    bytes = slices + kWarps4 * slice;
  }
};

__device__ __forceinline__ void unrotate_pair(float gv, float gp, float cv,
                                              float sv, bool low, float* t) {
  using tcore::bround;
  const float t1 = bround(bround(gv) * bround(cv));
  const float t2 = bround(bround(gp) * bround(sv));
  *t = t1 - (low ? -t2 : t2);
}

template <int NC>
__global__ void __launch_bounds__(tcore::kThreads4, 2)
bwd_rows_kernel(const BArgs A) {
  using namespace tcore;
  constexpr int NT = 4 * NC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = A.H, S = A.S, Dc = A.Dc, Dr = A.Dr, Dv = A.Dv;
  const int D = Dc + Dr, half = Dr / 2;
  const bool use_mask = A.use_mask != 0;
  const float scale = A.scale;
  const RowsSmem L(S, D, Dv, use_mask);
  const int SP = pad16(S), H2P = pad16(2 * S), nk16 = SP / 16;
  const int ldk = ld_bf16(D), ldv = ld_bf16(Dv);
  const int nd = pad16(D) / 16, nv = pad16(Dv) / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kRowsCta;
  const int live = S - q0;  // rows of the tile that exist (may exceed 64)
  const size_t row0 = (size_t)b * S + q0;
  const size_t bh0 = (size_t)b * H;
  bf16* U = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = U;
  bf16* Vs = U + SP * ldk;
  bf16* Xs = U;                          // ssum tile (MLP)
  bf16* Xd = U + kRowsCta * (SP + 8);    // dm tile (MLP backward)
  bf16* W = Xd + kRowsCta * (SP + 8);    // weight stages
  float* Stg = reinterpret_cast<float*>(smem_raw + L.slices +
                                        warp * L.slice);
  const int lds = pad16(D) + 4;
  const int DP = pad16(D), DVP = pad16(Dv);
  const int r0 = q0 + warp * 16;  // the warp's first row
  auto head = [&](const bf16* base, int h, int dim) -> const bf16* {
    return base ? base + (bh0 + h) * S * dim : nullptr;
  };
  // K_h (and V_h) tiles by cp.async; the warp's q_h (and g_h) fragments.
  auto load_head = [&](int h, bool with_v, uint32_t (&qf)[4][4],
                       uint32_t (&gf)[4][4]) {
    __syncthreads();
    copy_tile(Ks, ldk, A.kp + (bh0 + h) * S * DP, DP, SP, S, 0, DP, tid,
              kThreads4);
    if (with_v)
      copy_tile(Vs, ldv, A.vp + (bh0 + h) * S * DVP, DVP, SP, S, 0, DVP, tid,
                kThreads4);
    cp_commit();
    global_frags(qf, A.qp + ((bh0 + h) * S + r0) * DP, DP, S - r0, nd, lane);
    if (with_v)
      global_frags(gf, A.gp + ((bh0 + h) * S + r0) * DVP, DVP, S - r0, nv,
                   lane);
    cp_wait<0>();
    __syncthreads();
  };
  // m (fp32) of the warp's rows g, g + 8 at the 16 keys of block j2 (zeros
  // without the mask, past the last block or past the tile's rows); loaded
  // one block ahead of its use, so the L2 latency hides behind a block's
  // products.
  auto load_mask = [&](float2 (&mv)[2][2], int j2) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tr = warp * 16 + g + 8 * hf;
        mv[nt][hf] = make_float2(0.f, 0.f);
        if (use_mask && tr < live && j2 < nk16)
          mv[nt][hf] = *reinterpret_cast<const float2*>(
              A.m + (row0 + tr) * SP + j2 * 16 + nt * 8 + 2 * t);
      }
  };
  // Logits of 16 keys (two C tiles) of the warp's rows: -inf past S.
  auto logits = [&](float (&x)[2][4], int j2, const uint32_t (&qf)[4][4],
                    const float2 (&mv)[2][2]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nd) {
        uint32_t bb[4];
        load_b_nk(bb, Ks, ldk, j2 * 16, kk * 16, lane);
        mma(x[0], qf[kk], bb[0], bb[1]);
        mma(x[1], qf[kk], bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = j2 * 16 + nt * 8 + 2 * t;
        x[nt][2 * hf] =
            k < S ? x[nt][2 * hf] * scale + mv[nt][hf].x : -INFINITY;
        x[nt][2 * hf + 1] =
            k + 1 < S ? x[nt][2 * hf + 1] * scale + mv[nt][hf].y : -INFINITY;
      }
  };
  auto dprod = [&](float (&dp)[2][4], int j2, const uint32_t (&gf)[4][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nv) {
        uint32_t bb[4];
        load_b_nk(bb, Vs, ldv, j2 * 16, kk * 16, lane);
        mma(dp[0], gf[kk], bb[0], bb[1]);
        mma(dp[1], gf[kk], bb[2], bb[3]);
      }
    }
  };

  float acc[NT][4];  // ssum, then m, then dm, then dssum
  if (use_mask) {
    zero_tiles(acc);
    for (int h = 0; h < H; ++h) {
      uint32_t qf[4][4], gf[4][4];
      load_head(h, false, qf, gf);
      qk_rows(acc, qf, Ks, ldk, nd, nk16, lane);
    }
    __syncthreads();  // K is done: U holds the ssum tile and weight stages
    store_rows_bf16(acc, Xs, SP + 8, A.ssum + row0 * SP, SP, live, nk16,
                    lane, warp);
    __syncwarp();
    zero_tiles(acc);
    mask_mlp_fwd(acc, Xs, W, A.w1, A.w2, A.b1, SP, H2P, nk16,
                 A.a + row0 * H2P, live, tid);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j / 2 < nk16) {
        const int k = j * 8 + 2 * t;
        const float c0 = k < S ? A.b2[k] : 0.f;
        const float c1 = k + 1 < S ? A.b2[k + 1] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int tr = warp * 16 + g + 8 * hf;
          if (tr < live)
            *reinterpret_cast<float2*>(A.m + (row0 + tr) * SP + k) =
                make_float2(acc[j][2 * hf] + c0, acc[j][2 * hf + 1] + c1);
        }
      }
    }
  }

  // Pass 2: row statistics, delta, dm.
  zero_tiles(acc);
  for (int h = 0; h < H; ++h) {
    uint32_t qf[4][4], gf[4][4];
    load_head(h, true, qf, gf);
    // One sweep: the row max and sum online, and with them the unscaled
    // sum of e * dp, e = exp(x - max); delta = that sum / the row sum.
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
    float delta[2] = {0.f, 0.f}, rs[2];
    float2 mv[2][2], mn[2][2];
    load_mask(mv, 0);
    for (int j2 = 0; j2 < nk16; ++j2) {
      float x[2][4], dp[2][4];
      load_mask(mn, j2 + 1);
      logits(x, j2, qf, mv);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) mv[nt][hf] = mn[nt][hf];
      dprod(dp, j2, gf);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float lm = fmaxf(fmaxf(x[0][2 * hf], x[0][2 * hf + 1]),
                               fmaxf(x[1][2 * hf], x[1][2 * hf + 1]));
        const float nm = fmaxf(mx[hf], lm);
        if (nm == -INFINITY) continue;
        const float f = mx[hf] == -INFINITY ? 0.f : __expf(mx[hf] - nm);
        float s = sm[hf] * f, dsum = delta[hf] * f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = __expf(x[nt][2 * hf + e] - nm);
            s += ex;
            dsum += ex * dp[nt][2 * hf + e];
          }
        mx[hf] = nm;
        sm[hf] = s;
        delta[hf] = dsum;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[hf], o);
        const float os = __shfl_xor_sync(0xffffffffu, sm[hf], o);
        const float od = __shfl_xor_sync(0xffffffffu, delta[hf], o);
        const float nm = fmaxf(mx[hf], om);
        const float fa = mx[hf] == -INFINITY ? 0.f : __expf(mx[hf] - nm);
        const float fb = om == -INFINITY ? 0.f : __expf(om - nm);
        sm[hf] = sm[hf] * fa + os * fb;
        delta[hf] = delta[hf] * fa + od * fb;
        mx[hf] = nm;
      }
      delta[hf] = delta[hf] / sm[hf];
      rs[hf] = 1.f / sm[hf];
    }
    load_mask(mv, 0);
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      if (j2 < nk16) {
        float x[2][4], dp[2][4];
        load_mask(mn, j2 + 1);
        logits(x, j2, qf, mv);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) mv[nt][hf] = mn[nt][hf];
        dprod(dp, j2, gf);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(x[nt][e] - mx[e >> 1]) * rs[e >> 1];
            acc[2 * j2 + nt][e] += p * (dp[nt][e] - delta[e >> 1]);
          }
      }
    }
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tr = warp * 16 + g + 8 * hf;
        if (tr < live) {
          float* st = A.stats + ((bh0 + h) * S + q0 + tr) * 3;
          st[0] = mx[hf];
          st[1] = sm[hf];
          st[2] = delta[hf];
        }
      }
    }
  }

  if (use_mask) {
    // MLP backward: dm -> da -> dh1 -> dssum (in acc).
    __syncthreads();  // K and V are done: U holds the tiles and stages
    store_rows_bf16(acc, Xd, SP + 8, A.dm + row0 * SP, SP, live, nk16, lane,
                    warp);
    copy_tile(Xs, SP + 8, A.ssum + row0 * SP, SP, kRowsCta, live, 0, SP, tid,
              kThreads4);
    cp_commit();
    zero_tiles(acc);
    const bf16* Xsw = Xs + warp * 16 * (SP + 8);
    const bf16* Xdw = Xd + warp * 16 * (SP + 8);
    const int nch = H2P / kHC;
    load_w_chunk(W, 0, 0, A.w1, A.w2, SP, H2P, tid);
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) {
        load_w_chunk(W, (c + 1) & 1, c + 1, A.w1, A.w2, SP, H2P, tid);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* w1c = W + (c & 1) * w_stage_elems(SP);
      const bf16* w2c = w1c + kHC * (SP + 8);
      float hc[2][4], da[2][4];
      h1_chunk(hc, Xsw, w1c, SP, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[nt][e] = 0.f;
      for (int kk = 0; kk < SP; kk += 16) {
        uint32_t a[4], bb[4];
        load_a(a, Xdw, SP + 8, kk, lane);
        load_b_kn(bb, w2c, kLdW2, 0, kk, lane);
        mma(da[0], a, bb[0], bb[1]);
        mma(da[1], a, bb[2], bb[3]);
      }
      float dh[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c * kHC + nt * 8 + 2 * t + (e & 1);
          dh[nt][e] = bround(da[nt][e] * dgelu_exact(hc[nt][e] + A.b1[j]));
        }
      uint32_t a[4];
      c_to_a(a, dh[0], dh[1]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int tr = warp * 16 + g + 8 * hf;
          if (tr < live)
            *reinterpret_cast<uint32_t*>(A.dh1 + (row0 + tr) * H2P +
                                         c * kHC + nt * 8 + 2 * t) =
                a[nt * 2 + hf];
        }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if (j2 < nk16) {
          uint32_t bb[4];
          load_b_kn(bb, w1c, SP + 8, j2 * 16, 0, lane);
          mma(acc[2 * j2], a, bb[0], bb[1]);
          mma(acc[2 * j2 + 1], a, bb[2], bb[3]);
        }
      }
      __syncthreads();  // the stage is free for chunk c + 2
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j / 2 < nk16) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int tr = warp * 16 + g + 8 * hf;
          if (tr < live)
            *reinterpret_cast<float2*>(A.dssum + (row0 + tr) * SP + j * 8 +
                                       2 * t) =
                make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        }
      }
    }
  } else {
    zero_tiles(acc);
  }

  // Pass 3: ds -> dq, un-rotated, with the q-side table terms.
  for (int h = 0; h < H; ++h) {
    uint32_t qf[4][4], gf[4][4];
    load_head(h, true, qf, gf);
    float mx[2], rs[2], delta[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tr = warp * 16 + g + 8 * hf;
      mx[hf] = 0.f, rs[hf] = 1.f, delta[hf] = 0.f;
      if (tr < live) {
        const float* st = A.stats + ((bh0 + h) * S + q0 + tr) * 3;
        mx[hf] = st[0];
        rs[hf] = 1.f / st[1];
        delta[hf] = st[2];
      }
    }
    float dq[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
    float2 mv[2][2], mn[2][2];
    load_mask(mv, 0);
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      if (j2 < nk16) {
        float x[2][4], dp[2][4], ds[2][4];
        load_mask(mn, j2 + 1);
        logits(x, j2, qf, mv);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) mv[nt][hf] = mn[nt][hf];
        dprod(dp, j2, gf);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(x[nt][e] - mx[e >> 1]) * rs[e >> 1];
            const float dl = p * (dp[nt][e] - delta[e >> 1]);
            ds[nt][e] = bround(dl * scale + acc[2 * j2 + nt][e]);
          }
        uint32_t a[4];
        c_to_a(a, ds[0], ds[1]);
#pragma unroll
        for (int d2 = 0; d2 < 4; ++d2) {
          if (d2 < nd) {
            uint32_t bb[4];
            load_b_kn(bb, Ks, ldk, d2 * 16, j2 * 16, lane);
            mma(dq[2 * d2], a, bb[0], bb[1]);
            mma(dq[2 * d2 + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    __syncwarp();  // the previous head's staging tile has been read
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < 2 * nd) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Stg + (g + 8 * hf) * lds + n * 8 +
                                     2 * t) =
              make_float2(dq[n][2 * hf], dq[n][2 * hf + 1]);
      }
    }
    __syncwarp();
    const bf16* qrh = head(A.qr, h, Dr);
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = idx / D, d = idx - r * D;
      const int q = q0 + warp * 16 + r;
      if (q >= S) continue;
      const float gv = Stg[r * lds + d];
      if (d < Dc) {
        A.dqc[((bh0 + h) * S + q) * Dc + d] = __float2bfloat16(gv);
        continue;
      }
      const int e = d - Dc, pe = e < half ? e + half : e - half;
      float val;
      unrotate_pair(gv, Stg[r * lds + Dc + pe], A.cos_q[q * Dr + e],
                    A.sin_q[q * Dr + pe], e < half, &val);
      A.dqr[((bh0 + h) * S + q) * Dr + e] = __float2bfloat16(val);
      const float x = __bfloat162float(qrh[(size_t)q * Dr + e]);
      const float xp = __bfloat162float(qrh[(size_t)q * Dr + pe]);
      float* tc = A.tab_part + ((size_t)b * 4 + 0) * S * Dr + q * Dr + e;
      float* ts = A.tab_part + ((size_t)b * 4 + 1) * S * Dr + q * Dr + e;
      const float vc = x * gv, vs = (e < half ? -xp : xp) * gv;
      *tc = h == 0 ? vc : *tc + vc;
      *ts = h == 0 ? vs : *ts + vs;
    }
  }
}

__device__ __forceinline__ void copy_f32_block(float* dst, const float* src,
                                               int SP, int rows, int col0,
                                               int tid) {
  // [64][68] fp32 block of rows [0, rows) x cols [col0, col0 + 64) of a
  // (., SP) matrix; missing rows and columns past SP are zeros.
  for (int idx = tid; idx < 64 * 16; idx += tcore::kThreads4) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float* d = dst + r * 68 + c;
    if (r < rows && col0 + c < SP)
      tcore::cp_async16(d, src + (size_t)r * SP + col0 + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(tcore::kThreads4, 3)
bwd_keys_kernel(const BArgs A) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = A.H, S = A.S, Dc = A.Dc, Dr = A.Dr, Dv = A.Dv;
  const int D = Dc + Dr, half = Dr / 2;
  const bool use_mask = A.use_mask != 0;
  const float scale = A.scale;
  const KeysSmem L(S, D, Dv, use_mask);
  const int SP = pad16(S);
  const int ldk = ld_bf16(D), ldv = ld_bf16(Dv);
  const int nd = pad16(D) / 16, nv = pad16(Dv) / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, k0 = blockIdx.x * kRowsCta;
  const int kw = k0 + warp * 16;  // the warp's first key
  const size_t bh0 = (size_t)b * H;
  bf16* Qb = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gb = reinterpret_cast<bf16*>(smem_raw + L.gb);
  float* Mb = reinterpret_cast<float*>(smem_raw + L.mb);
  float* Db = reinterpret_cast<float*>(smem_raw + L.db);
  float* St = reinterpret_cast<float*>(smem_raw + L.st);
  float* Stg = reinterpret_cast<float*>(smem_raw + L.slices +
                                        warp * L.slice);
  const int lds = pad16(D) + 4;
  const int DP = pad16(D), DVP = pad16(Dv);
  auto head = [&](const bf16* base, int h, int dim) -> const bf16* {
    return base ? base + (bh0 + h) * S * dim : nullptr;
  };

  for (int h = 0; h < H; ++h) {
    uint32_t kf[4][4], vf[4][4];
    global_frags(kf, A.kp + ((bh0 + h) * S + kw) * DP, DP, S - kw, nd, lane);
    global_frags(vf, A.vp + ((bh0 + h) * S + kw) * DVP, DVP, S - kw, nv,
                 lane);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int qb = 0; qb < S; qb += kRowsCta) {
      const int rows = S - qb < kRowsCta ? S - qb : kRowsCta;
      __syncthreads();  // every warp is done with the previous blocks
      copy_tile(Qb, ldk, A.qp + ((bh0 + h) * S + qb) * DP, DP, kRowsCta,
                rows, 0, DP, tid, kThreads4);
      copy_tile(Gb, ldv, A.gp + ((bh0 + h) * S + qb) * DVP, DVP, kRowsCta,
                rows, 0, DVP, tid, kThreads4);
      if (use_mask) {
        copy_f32_block(Mb, A.m + ((size_t)b * S + qb) * SP, SP, rows, k0,
                       tid);
        copy_f32_block(Db, A.dssum + ((size_t)b * S + qb) * SP, SP, rows, k0,
                       tid);
      }
      cp_commit();
      if (tid < kRowsCta) {
        const float* st = A.stats + ((bh0 + h) * S + qb + tid) * 3;
        const bool ok = tid < rows;
        St[tid * 4 + 0] = ok ? st[0] : 0.f;
        St[tid * 4 + 1] = ok ? 1.f / st[1] : 1.f;   // 1 / the row sum
        St[tid * 4 + 2] = ok ? st[2] : 0.f;
      }
      cp_wait<0>();
      __syncthreads();

#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        if (qt * 16 < rows) {
          float s[2][4], dp[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk < nd) {
              uint32_t bb[4];
              load_b_nk(bb, Qb, ldk, qt * 16, kk * 16, lane);
              mma(s[0], kf[kk], bb[0], bb[1]);
              mma(s[1], kf[kk], bb[2], bb[3]);
            }
            if (kk < nv) {
              uint32_t bb[4];
              load_b_nk(bb, Gb, ldv, qt * 16, kk * 16, lane);
              mma(dp[0], vf[kk], bb[0], bb[1]);
              mma(dp[1], vf[kk], bb[2], bb[3]);
            }
          }
          float p[2][4], ds[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kl = warp * 16 + g + 8 * (e >> 1);  // local key
              const int ql = qt * 16 + nt * 8 + 2 * t + (e & 1);
              const bool ok = k0 + kl < S && ql < rows;
              float x = s[nt][e] * scale;
              if (use_mask) x += Mb[ql * 68 + kl];
              const float pv =
                  ok ? __expf(x - St[ql * 4]) * St[ql * 4 + 1] : 0.f;
              const float dl = pv * (dp[nt][e] - St[ql * 4 + 2]);
              float dsv = dl * scale;
              if (use_mask) dsv += Db[ql * 68 + kl];
              p[nt][e] = pv;
              ds[nt][e] = ok ? bround(dsv) : 0.f;
            }
          uint32_t ap[4], ad[4];
          c_to_a(ap, p[0], p[1]);
          c_to_a(ad, ds[0], ds[1]);
#pragma unroll
          for (int d2 = 0; d2 < 4; ++d2) {
            if (d2 < nv) {
              uint32_t bb[4];
              load_b_kn(bb, Gb, ldv, d2 * 16, qt * 16, lane);
              mma(dv[2 * d2], ap, bb[0], bb[1]);
              mma(dv[2 * d2 + 1], ap, bb[2], bb[3]);
            }
            if (d2 < nd) {
              uint32_t bb[4];
              load_b_kn(bb, Qb, ldk, d2 * 16, qt * 16, lane);
              mma(dk[2 * d2], ad, bb[0], bb[1]);
              mma(dk[2 * d2 + 1], ad, bb[2], bb[3]);
            }
          }
        }
      }
    }

    float* dvh = A.dv + (bh0 + h) * S * Dv;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < Dv) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = kw + g + 8 * hf;
          if (key < S)
            *reinterpret_cast<float2*>(dvh + (size_t)key * Dv + d) =
                make_float2(dv[n][2 * hf], dv[n][2 * hf + 1]);
        }
      }
    }
    __syncwarp();  // the previous head's staging tile has been read
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < 2 * nd) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Stg + (g + 8 * hf) * lds + n * 8 +
                                     2 * t) =
              make_float2(dk[n][2 * hf], dk[n][2 * hf + 1]);
      }
    }
    __syncwarp();
    const bf16* krh = head(A.kr, h, Dr);
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = idx / D, d = idx - r * D;
      const int key = kw + r;
      if (key >= S) continue;
      const float gv = Stg[r * lds + d];
      if (d < Dc) {
        A.dkc[((bh0 + h) * S + key) * Dc + d] = gv;
        continue;
      }
      const int e = d - Dc, pe = e < half ? e + half : e - half;
      float val;
      unrotate_pair(gv, Stg[r * lds + Dc + pe], A.cos_k[key * Dr + e],
                    A.sin_k[key * Dr + pe], e < half, &val);
      A.dkr[((bh0 + h) * S + key) * Dr + e] = bround(val);
      const float x = __bfloat162float(krh[(size_t)key * Dr + e]);
      const float xp = __bfloat162float(krh[(size_t)key * Dr + pe]);
      float* tc = A.tab_part + ((size_t)b * 4 + 2) * S * Dr + key * Dr + e;
      float* ts = A.tab_part + ((size_t)b * 4 + 3) * S * Dr + key * Dr + e;
      const float vc = x * gv, vs = (e < half ? -xp : xp) * gv;
      *tc = h == 0 ? vc : *tc + vc;
      *ts = h == 0 ? vs : *ts + vs;
    }
  }
}

// Weight grads on the tensor cores: for the rows of split z,
//   out[z][m][n] = sum_r X[r][m] Y[r][n],   col[z][m] = sum_r X[r][m],
// X (R, ldx) and Y (R, ldy) bf16 (zero-padded columns), M <= ldx and
// N <= ldy real columns. A CTA of 4 warps owns a 64 x 64 output tile (each
// warp 16 x 64) and walks its rows in chunks of 32 through two cp.async
// stages; the column sums are fp32 sums in row order.
constexpr int kXChunk = 32;
constexpr int kXLd = 64 + 8;

__device__ __forceinline__ void xty_load(tcore::bf16* dst,
                                         const tcore::bf16* src, int ld,
                                         int r0, int r_end, int c0, int tid) {
  for (int idx = tid; idx < kXChunk * 8; idx += tcore::kThreads4) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    tcore::bf16* d = dst + r * kXLd + c;
    if (r0 + r < r_end && c0 + c < ld)
      tcore::cp_async16(d, src + (size_t)(r0 + r) * ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  tcore::cp_commit();
}

__global__ void __launch_bounds__(tcore::kThreads4)
xty_mma_kernel(const tcore::bf16* __restrict__ X, int ldx,
               const tcore::bf16* __restrict__ Y, int ldy, int R, int M,
               int N, int rows_per_split, float* __restrict__ out,
               float* __restrict__ col, size_t split_stride) {
  using namespace tcore;
  __shared__ __align__(128) bf16 sX[2][kXChunk * kXLd];
  __shared__ __align__(128) bf16 sY[2][kXChunk * kXLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float cs = 0.f;
  const int nch = r_end > r_begin ? (r_end - r_begin + kXChunk - 1) / kXChunk
                                  : 0;
  if (nch > 0) {
    xty_load(sX[0], X, ldx, r_begin, r_end, m0, tid);
    xty_load(sY[0], Y, ldy, r_begin, r_end, n0, tid);
  }
  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    if (c + 1 < nch) {
      const int r1 = r_begin + (c + 1) * kXChunk;
      xty_load(sX[st ^ 1], X, ldx, r1, r_end, m0, tid);
      xty_load(sY[st ^ 1], Y, ldy, r1, r_end, n0, tid);
      cp_wait<2>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (tid < 64) {
      for (int r = 0; r < kXChunk; ++r)
        cs += __bfloat162float(sX[st][r * kXLd + tid]);
    }
#pragma unroll
    for (int ks = 0; ks < kXChunk; ks += 16) {
      uint32_t a[4];
      load_a_t(a, sX[st], kXLd, ks, warp * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bb[4];
        load_b_kn(bb, sY[st], kXLd, n2 * 16, ks, lane);
        mma(acc[2 * n2], a, bb[0], bb[1]);
        mma(acc[2 * n2 + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the stage is free for chunk c + 2
  }
  float* o = out + blockIdx.z * split_stride;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + warp * 16 + g + 8 * (e >> 1);
      const int nn = n0 + n * 8 + 2 * t + (e & 1);
      if (m < M && nn < N) o[(size_t)m * N + nn] = acc[n][e];
    }
  }
  if (blockIdx.y == 0 && tid < 64 && m0 + tid < M)
    col[blockIdx.z * split_stride + m0 + tid] = cs;
}

// Pointer slots of the bf16 route's argument array (the wrapper fills the
// same order).
enum SlotBf16 {
  sQc, sKc, sQr, sKr, sV, sG, sCosQ, sSinQ, sCosK, sSinK,
  sW1, sB1, sW2, sB2,
  sDqc, sDqr, sDkc, sDkr, sDv, sTabOut, sWGrad,
  sTabPart, sSsum, sA, sDm, sDh1, sM, sDssum, sStats, sWPart, sPrep,
  sSlots
};

template <int NC>
cudaError_t launch_rows(const BArgs& a, int B, cudaStream_t st) {
  const size_t smem = RowsSmem(a.S, a.Dc + a.Dr, a.Dv, a.use_mask != 0).bytes;
  auto kern = bwd_rows_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((a.S + tcore::kRowsCta - 1) / tcore::kRowsCta, B),
         tcore::kThreads4, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run_bf16(void* const* p, int B, int H, int S, int Dc, int Dr,
                     int Dv, float scale, int use_mask, int splits,
                     cudaStream_t st, int* launched) {
  typedef tcore::bf16 bf16;
  auto in = [&](int slot) { return static_cast<const bf16*>(p[slot]); };
  auto f32 = [&](int slot) { return static_cast<float*>(p[slot]); };
  auto b16 = [&](int slot) { return static_cast<bf16*>(p[slot]); };
  BArgs a;
  a.qc = in(sQc); a.kc = in(sKc); a.qr = in(sQr); a.kr = in(sKr);
  a.v = in(sV); a.g = in(sG);
  a.cos_q = f32(sCosQ); a.sin_q = f32(sSinQ);
  a.cos_k = f32(sCosK); a.sin_k = f32(sSinK);
  a.w1 = in(sW1); a.w2 = in(sW2); a.b1 = f32(sB1); a.b2 = f32(sB2);
  a.dqc = b16(sDqc); a.dqr = b16(sDqr);
  a.dkc = f32(sDkc); a.dkr = f32(sDkr); a.dv = f32(sDv);
  a.tab_part = f32(sTabPart);
  a.ssum = b16(sSsum); a.a = b16(sA); a.dm = b16(sDm); a.dh1 = b16(sDh1);
  a.m = f32(sM); a.dssum = f32(sDssum); a.stats = f32(sStats);
  a.H = H; a.S = S; a.Dc = Dc; a.Dr = Dr; a.Dv = Dv; a.use_mask = use_mask;
  a.scale = scale;
  const int DP = tcore::pad16(Dc + Dr), DVP = tcore::pad16(Dv);
  const size_t rows_all = (size_t)B * H * S;
  bf16* prep = b16(sPrep);
  a.qp = prep;
  a.kp = a.qp + rows_all * DP;
  a.vp = a.kp + rows_all * DP;
  a.gp = a.vp + rows_all * DVP;
  tcore::PrepJobs jobs = {{
      {a.qc, a.qr, a.cos_q, a.sin_q, prep, Dc, Dr, DP},
      {a.kc, a.kr, a.cos_k, a.sin_k, prep + rows_all * DP, Dc, Dr, DP},
      {a.v, nullptr, nullptr, nullptr, prep + 2 * rows_all * DP, Dv, 0, DVP},
      {a.g, nullptr, nullptr, nullptr,
       prep + 2 * rows_all * DP + rows_all * DVP, Dv, 0, DVP}}};
  cudaError_t err = tcore::launch_prep(jobs, 4, (int)rows_all, S, st);
  if (err != cudaSuccess) return err;
  ++*launched;
#define CASE(N)                          \
  case N:                                \
    err = launch_rows<N>(a, B, st);      \
    break;
  switch ((S + 31) / 32) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
  if (err != cudaSuccess) return err;
  ++*launched;
  {
    const size_t smem = KeysSmem(S, Dc + Dr, Dv, use_mask != 0).bytes;
    err = cudaFuncSetAttribute(bwd_keys_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    bwd_keys_kernel<<<dim3((S + tcore::kRowsCta - 1) / tcore::kRowsCta, B),
                      tcore::kThreads4, smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
  }
  if (Dr > 0) {
    const size_t n = (size_t)4 * S * Dr;
    reduce_leading_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        a.tab_part, f32(sTabOut), B, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
  }
  if (use_mask) {
    // Flat layout of the weight grads as in the fp32 route.
    const int S2 = 2 * S, R = B * S;
    const int SP = tcore::pad16(S), H2P = tcore::pad16(S2);
    const size_t total = (size_t)2 * S2 * S + S2 + S;
    const int rows = (R + splits - 1) / splits;
    float* part = f32(sWPart);
    const size_t o_dw1 = 0, o_db1 = (size_t)S2 * S, o_dw2 = o_db1 + S2,
                 o_db2 = o_dw2 + (size_t)S * S2;
    auto tiles = [](int n) { return (unsigned)((n + 63) / 64); };
    xty_mma_kernel<<<dim3(tiles(S2), tiles(S), splits), tcore::kThreads4, 0,
                     st>>>(a.dh1, H2P, a.ssum, SP, R, S2, S, rows,
                           part + o_dw1, part + o_db1, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    xty_mma_kernel<<<dim3(tiles(S), tiles(S2), splits), tcore::kThreads4, 0,
                     st>>>(a.dm, SP, a.a, H2P, R, S, S2, rows, part + o_dw2,
                           part + o_db2, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    reduce_leading_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, f32(sWGrad), splits, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

// The fp32 route on the CUDA cores. Returns a cudaError_t (0 on success).
// `ptrs` holds kSlots device pointers
// in the order of enum Slot; a slot may be null where its tensor does not
// exist (content halves when Dc == 0, rope halves and tables when Dr == 0,
// everything of the mask MLP when use_mask == 0). Inputs as in
// rope_attention_fwd plus g (B,H,S,Dv) in the compute type, w1 (2S,S), w2
// (S,2S) and their transposes in fp32. Outputs: dqc/dqr in the compute type;
// dkc, dkr, dv, the tables (4,S,Dr) and the flat weight grads in fp32. The
// scratch buffers are described at struct Args; the weight-grad partial
// buffer holds `splits` copies of the flat weight grads. When Dr == 0 the dkc
// and dk_full slots hold the same buffer. All contiguous.
extern "C" int rope_attention_bwd_f32(void* const* ptrs, int B, int H,
                                      int S, int Dc, int Dr, int Dv,
                                      float scale, int use_mask, int splits,
                                      void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > 256 || Dc < 0 || Dr < 0 || Dr % 2 ||
      Dc + Dr < 1 || Dc + Dr > 64 || Dv < 1 || Dv > kMaxDv || splits < 1 ||
      (Dr == 0 && ptrs[kDkc] != ptrs[kDkFull]))
    return (int)cudaErrorInvalidValue;
  return (int)run<float>(ptrs, B, H, S, Dc, Dr, Dv, scale, use_mask, splits,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 route on the tensor cores. Returns a cudaError_t. `ptrs` holds
// sSlots device pointers in the order of enum SlotBf16; a slot may be null
// where its tensor does not exist (as for the fp32 route). Inputs as in
// rope_attention_fwd_bf16 plus g (B,H,S,Dv) bf16; w1/w2 are the bf16
// zero-padded weights, b1 padded. Outputs: dqc/dqr bf16; dkc, dkr, dv, the
// tables (4,S,Dr) and the flat weight grads fp32. Scratch (all written
// before read): tab_part (B,4,S,Dr); ssum and dm (B*S, pad16(S)) bf16;
// a and dh1 (B*S, pad16(2S)) bf16; m and dssum (B*S, pad16(S)) fp32;
// stats (B,H,S,3) fp32; the weight-grad partials (splits, flat size);
// prep, B*H*S*(2*pad16(D) + 2*pad16(Dv)) bf16 for the prologue's padded q,
// k, v and g rows. Sets *launched to the number of kernels it launched: the
// prologue, the rows and keys kernels, the table-grad reduction (Dr > 0),
// and the two weight-grad products and their reduction (with the mask).
extern "C" int rope_attention_bwd_bf16(void* const* ptrs, int B, int H,
                                       int S, int Dc, int Dr, int Dv,
                                       float scale, int use_mask, int splits,
                                       void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || H < 1 || S < 1 || S > 256 || Dc < 0 || Dr < 0 || Dc % 2 ||
      Dr % 2 || Dc + Dr < 1 || Dc + Dr > 64 || Dv < 1 || Dv > 64 || Dv % 2 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  return (int)run_bf16(ptrs, B, H, S, Dc, Dr, Dv, scale, use_mask, splits,
                       static_cast<cudaStream_t>(stream), launched);
}

// The rows and keys kernels' dynamic shared memory (bytes) at a shape, as
// the launch sizes them.
extern "C" void rope_attention_bwd_bf16_layout(int S, int D, int Dv,
                                               int use_mask, long long* rows,
                                               long long* keys) {
  *rows = (long long)RowsSmem(S, D, Dv, use_mask != 0).bytes;
  *keys = (long long)KeysSmem(S, D, Dv, use_mask != 0).bytes;
}
