// Pieces shared by the bf16 tensor-core kernels of the fused rope attention
// (forward: axial_attention.cu; backward: axial_attention_bwd.cu): the CTA
// shape, the shared-memory layouts, the head-summed score product and the
// mask MLP's forward, streamed over the hidden units.
//
// CTA shape: 4 warps, each owning 16 query rows and the whole key axis
// (S <= 256 keys, 8-key column tiles kept in registers: NT = 4 * NC tiles,
// NC = ceil(S / 32) a template parameter). Keys are padded to SP, a
// multiple of 16, with zero rows, and masked out of every softmax.
//
// Mask weights arrive in bf16 (rounded once per launch by the wrapper),
// zero-padded: W1 as (H2P, SP) [hidden][key], W2 as (SP, H2P) [key][hidden],
// b1 as fp32 (H2P), with H2P = pad16(2S). The MLP walks the hidden units in
// chunks of kHC = 16; each chunk's W1 rows and W2 columns are copied with
// cp.async into one of two stages while the previous chunk computes.
#pragma once

#include <math.h>

#include "mma_common.cuh"

namespace tcore {

constexpr int kWarps4 = 4;
constexpr int kThreads4 = kWarps4 * 32;
constexpr int kRowsCta = 16 * kWarps4;  // query (or key) rows per CTA
constexpr int kHC = 16;                 // hidden units per MLP chunk
constexpr int kLdW2 = kHC + 8;          // row stride of a W2 chunk

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu_exact(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// Element counts of one MLP weight stage: W1 chunk [16][ldx] + W2 chunk
// [SP][kLdW2].
__host__ __device__ inline size_t w_stage_elems(int SP) {
  return (size_t)kHC * (SP + 8) + (size_t)SP * kLdW2;
}

// Shared memory of one SM on the H100, and what the system reserves per CTA.
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerCta = 1024;

// Shared memory of the forward CTA (bytes, every offset 16-byte aligned):
//   M   fp32 [64][SP+8]   the mask m (with the mask; the bf16 ssum tile
//                         [64][SP+8] lives here while the MLP runs, and
//                         before that the second K stage of pass 1)
//   U   the K tile [SP][ldkv] bf16 (or, larger, the two MLP weight stages)
//   V   the V tile, a second stage beside K where two CTAs of that size
//       still fit on an SM (kv_stages 2); otherwise V is U (kv_stages 1)
// The warps read their q_h rows as A fragments straight from the padded
// rows the prologue wrote.
struct FwdSmem {
  size_t m, u, v, bytes;
  int kv_stages;
  __host__ __device__ FwdSmem(int S, int D, int Dv, bool mask) {
    const int SP = pad16(S);
    const int ldkv = ld_bf16(D) > ld_bf16(Dv) ? ld_bf16(D) : ld_bf16(Dv);
    const size_t tile = (size_t)SP * ldkv * 2;
    const size_t w = mask ? 2 * w_stage_elems(SP) * 2 : 0;
    m = 0;
    u = mask ? (size_t)kRowsCta * (SP + 8) * 4 : 0;
    const size_t two = 2 * tile > w ? 2 * tile : w;
    if (2 * (u + two + kSmemPerCta) <= kSmemPerSm) {
      kv_stages = 2;
      v = u + tile;
      bytes = u + two;
    } else {
      kv_stages = 1;
      v = u;
      bytes = u + (tile > w ? tile : w);
    }
  }
};

// Start the cp.async copies of MLP chunk `c` (hidden units 16c..16c+15)
// into stage `st` of `ws`.
__device__ __forceinline__ void load_w_chunk(bf16* ws, int st, int c,
                                             const bf16* w1, const bf16* w2,
                                             int SP, int H2P, int tid) {
  bf16* w1c = ws + st * w_stage_elems(SP);
  bf16* w2c = w1c + kHC * (SP + 8);
  copy_tile(w1c, SP + 8, w1 + (size_t)c * kHC * SP, SP, kHC, kHC, 0, SP, tid,
            kThreads4);
  copy_tile(w2c, kLdW2, w2, H2P, SP, SP, c * kHC, kHC, tid, kThreads4);
  cp_commit();
}

// acc[j] += q k_j^T for the warp's 16 rows: qf holds the warp's A fragments
// (nd k-steps of 16 over the padded head dim), K is [SP][ldk] bf16.
template <int NT>
__device__ __forceinline__ void qk_rows(float (&acc)[NT][4],
                                        const uint32_t (&qf)[4][4],
                                        const bf16* K, int ldk, int nd,
                                        int nk16, int lane) {
#pragma unroll
  for (int j2 = 0; j2 < NT / 2; ++j2) {
    if (j2 < nk16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < nd) {
          uint32_t b[4];
          load_b_nk(b, K, ldk, j2 * 16, kk * 16, lane);
          mma(acc[2 * j2], qf[kk], b[0], b[1]);
          mma(acc[2 * j2 + 1], qf[kk], b[2], b[3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_tiles(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// One MLP hidden chunk's h1 = X W1c^T (16 rows x 16 hidden, two C tiles),
// X the warp's [16][SP+8] bf16 rows.
__device__ __forceinline__ void h1_chunk(float (&hc)[2][4], const bf16* Xw,
                                         const bf16* w1c, int SP, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hc[nt][e] = 0.f;
  for (int kk = 0; kk < SP; kk += 16) {
    uint32_t a[4], b[4];
    load_a(a, Xw, SP + 8, kk, lane);
    load_b_nk(b, w1c, SP + 8, 0, kk, lane);
    mma(hc[0], a, b[0], b[1]);
    mma(hc[1], a, b[2], b[3]);
  }
}

// The mask MLP's forward for the warp's 16 rows of X (bf16 ssum, [16][SP+8]
// rows of the CTA's tile): macc += rnd(gelu(X W1^T + b1)) W2^T, without b2.
// `a_out` (optional, row stride H2P) receives the rounded GELU output of the
// rows below `live` (the backward's weight-grad input). Every thread of the
// CTA calls it: the weight stages are shared. Ends with a __syncthreads().
template <int NT>
__device__ __forceinline__ void mask_mlp_fwd(
    float (&macc)[NT][4], const bf16* X, bf16* ws, const bf16* w1,
    const bf16* w2, const float* b1, int SP, int H2P, int nk16, bf16* a_out,
    int live, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Xw = X + warp * 16 * (SP + 8);
  const int nch = H2P / kHC;
  load_w_chunk(ws, 0, 0, w1, w2, SP, H2P, tid);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_w_chunk(ws, (c + 1) & 1, c + 1, w1, w2, SP, H2P, tid);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* w1c = ws + (c & 1) * w_stage_elems(SP);
    const bf16* w2c = w1c + kHC * (SP + 8);
    float hc[2][4];
    h1_chunk(hc, Xw, w1c, SP, lane);
    float av[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = c * kHC + nt * 8 + 2 * t + (e & 1);
        av[nt][e] = bround(gelu_exact(hc[nt][e] + b1[j]));
      }
    uint32_t a[4];
    c_to_a(a, av[0], av[1]);
    if (a_out != nullptr) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = warp * 16 + g + 8 * hf;
          if (r < live)
            *reinterpret_cast<uint32_t*>(
                a_out + (size_t)r * H2P + c * kHC + nt * 8 + 2 * t) =
                a[nt * 2 + hf];
        }
    }
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      if (j2 < nk16) {
        uint32_t b[4];
        load_b_nk(b, w2c, kLdW2, j2 * 16, 0, lane);
        mma(macc[2 * j2], a, b[0], b[1]);
        mma(macc[2 * j2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage is free for chunk c + 2
  }
}

// Round the warp's accumulator tiles to bf16 and store them as the warp's
// 16 rows of a [64][SP+8] bf16 tile (and, optionally, the rows below `live`
// to global memory with row stride gld).
template <int NT>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[NT][4],
                                                bf16* tile, int ld,
                                                bf16* gout, int gld,
                                                int live, int nk16,
                                                int lane, int warp) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j / 2 < nk16) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 16 + g + 8 * hf;
        const uint32_t v = pack(acc[j][2 * hf], acc[j][2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(tile + r * ld + j * 8 + 2 * t) = v;
        if (gout != nullptr && r < live)
          *reinterpret_cast<uint32_t*>(gout + (size_t)r * gld + j * 8 +
                                       2 * t) = v;
      }
    }
  }
}

// One tensor of the prologue: rows (B*H*S) of [content | rotated rope]
// (or plain rows when r is null and Dr == 0) into dst (B*H*S, width) bf16,
// zero-padded to `width` columns.
struct PrepJob {
  const bf16 *c, *r;
  const float *cs, *sn;
  bf16* dst;
  int Dc, Dr, width;
};
struct PrepJobs {
  PrepJob job[4];
};

// The prologue of every bf16 launch: q, k (rotated, rounded like the plain
// version), v and g (copied) into zero-padded rows whose length is a
// multiple of 16 elements, so every later tile load is a 16-byte cp.async
// and nothing is rotated twice. Grid (ceil(rows * width / 2 / 256), jobs).
__global__ void __launch_bounds__(256) rope_prep_kernel(const PrepJobs jobs,
                                                        int rows, int S) {
  const PrepJob J = jobs.job[blockIdx.y];
  const int pairs = J.width / 2;
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (size_t)rows * pairs) return;
  const size_t row = idx / pairs;
  const int d = (int)(idx - row * pairs) * 2;
  const int s = (int)(row % S);
  const int D = J.Dc + J.Dr;
  __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
  if (d < D) {
    if (d < J.Dc) {
      v = *reinterpret_cast<const __nv_bfloat162*>(J.c + row * J.Dc + d);
    } else {
      const bf16* rr = J.r + row * J.Dr;
      v = __floats2bfloat162_rn(rot_elem(rr, J.cs, J.sn, s, d - J.Dc, J.Dr),
                                rot_elem(rr, J.cs, J.sn, s, d - J.Dc + 1,
                                         J.Dr));
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(J.dst + row * J.width + d) = v;
}

inline cudaError_t launch_prep(const PrepJobs& jobs, int n_jobs, int rows,
                               int S, cudaStream_t st) {
  int widest = 0;
  for (int i = 0; i < n_jobs; ++i)
    widest = jobs.job[i].width > widest ? jobs.job[i].width : widest;
  const size_t items = (size_t)rows * (widest / 2);
  rope_prep_kernel<<<dim3((unsigned)((items + 255) / 256), n_jobs), 256, 0,
                     st>>>(jobs, rows, S);
  return cudaGetLastError();
}

// The warp's A fragments of 16 padded rows (row stride `width`, rows at or
// past `live` zero), read straight from global memory.
__device__ __forceinline__ void global_frags(uint32_t (&f)[4][4],
                                             const bf16* rows, int width,
                                             int live, int nk, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1);
        const int c = kk * 16 + 2 * t + 8 * (e >> 1);
        f[kk][e] = r < live ? *reinterpret_cast<const uint32_t*>(
                                  rows + (size_t)r * width + c)
                            : 0u;
      }
    }
  }
}

}  // namespace tcore
