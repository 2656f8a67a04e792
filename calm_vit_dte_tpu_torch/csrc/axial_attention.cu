// Fused axial attention with in-kernel RoPE and the learned additive mask,
// forward only, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernel built by
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_rope_fused (forward
//   pallas_call), body _make_rope_kernels.fwd_kernel -> _fwd_body.
//
// Computes, for each batch element b, head h and query row q:
//   q = [qc | rope(qr)], k = [kc | rope(kr)]      rope(x) = x*cos + [-x2,x1]*sin
//   ssum[q, :] = sum_h q_h . k_h^T                (head-summed scores)
//   m[q, :]    = gelu(ssum[q, :] W1^T + b1) W2^T + b2   (mask MLP over keys)
//   p          = softmax(scale * q_h . k_h^T + m)  in fp32
//   out_h[q]   = p . v_h
// with the bf16 roundings of _fwd_body/_mask_fwd: ssum, W1, W2, the GELU
// output and p are rounded to the compute type before their products,
// every product accumulates in fp32, and the output is stored in the
// compute type. GELU is exact (erff).
//
// What bounds it on the H100: at the flagship's widest shape (B=128, H=12,
// S=224, D=Dv=56, bf16) the work is 2*B*H*S^2*(D+Dv) + 4*B*S^2*2S = 28.8
// GFLOP (29 us at 989 TFLOP/s on the tensor cores) against 154 MB of q, k,
// v and output (46 us at 3.35 TB/s): by the roofline the shape is
// memory-bound. Neither kernel below is near that bound: the CUDA-core
// kernel does all its products as fp32 FMAs, and both keep one CTA of 8
// warps per SM (shared memory, and registers for the WMMA one), so they are
// bound by issue latency through a long chain of load / product / barrier
// phases per head (PERF.md has the measurements).
//
// Two kernels compute the same function:
//   * the CUDA-core kernel (fp32, and bf16 at any S), below;
//   * the WMMA tensor-core kernel (namespace tc, bf16, S % 16 == 0), which
//     the wrapper picks for S >= 176, where it measured faster.
//
// CUDA-core kernel design:
//   * one CTA per (query tile of 32 rows, batch element); 8 warps, each
//     owning 4 query rows, lanes spanning the keys (key j = lane + 32c), so
//     row reductions (softmax max/sum) are warp shuffles;
//   * the mask MLP contracts over the whole key axis, so each CTA sees all
//     S <= 256 keys and needs no online softmax;
//   * pass 1 loops over the heads, rotating q/k while loading them into
//     shared memory (fp32, odd row stride so lanes reading different key
//     rows hit different banks) and accumulating ssum in registers;
//   * the mask MLP streams W1^T / W2^T from global memory through L1/L2
//     (448x224 fp32 at S=224 would not fit shared memory beside the
//     tiles); lanes read consecutive hidden/key columns, so the reads are
//     coalesced, and the 8 warps of a CTA read the same lines;
//   * pass 2 loops over the heads again: recompute the scores, add m, fp32
//     softmax, store p in shared memory, load v_h into the buffer k_h used,
//     and multiply;
//   * any D = Dc + Dr (Dr even, Dr may be 0) and Dv <= 64: loops run over
//     the real D, so callers never pad. Rows and keys past S are zero-filled
//     in shared memory and masked out of the softmax.

#include "attention_common.cuh"

namespace {

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rope_attention_fwd_kernel(
    const T* __restrict__ qc, const T* __restrict__ kc,
    const T* __restrict__ qr, const T* __restrict__ kr,
    const T* __restrict__ v, const float* __restrict__ cos_q,
    const float* __restrict__ sin_q, const float* __restrict__ cos_k,
    const float* __restrict__ sin_k, const float* __restrict__ w1t,
    const float* __restrict__ b1, const float* __restrict__ w2t,
    const float* __restrict__ b2, T* __restrict__ out, int H, int S, int Dc,
    int Dr, int Dv, float scale, int use_mask) {
  extern __shared__ float smem[];
  constexpr int SP = NC * 32;  // key count padded to whole lanes
  const int D = Dc + Dr;
  const int ld = D | 1;
  const int ldkv = ld > Dv ? ld : Dv;
  float* sQ = smem;               // kTq x ld       q tile of one head
  float* sKV = sQ + kTq * ld;     // SP x ldkv      k_h (stride ld), then v_h
  float* sM = sKV + SP * ldkv;    // kTq x SP       ssum, then the mask m
  float* sP = sM + kTq * SP;      // kTq x 2SP      mask hidden a, then p

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTq;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const size_t bh0 = (size_t)b * H;
  auto head = [&](const T* base, int h, int dim) -> const T* {
    return base ? base + (bh0 + h) * S * dim : nullptr;
  };

  if (use_mask) {
    // Pass 1: head-summed scores, in registers.
    float acc[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    for (int h = 0; h < H; ++h) {
      load_rows<T>(sQ, ld, kTq, q0, S, head(qc, h, Dc), head(qr, h, Dr),
                   cos_q, sin_q, Dc, Dr, D);
      load_rows<T>(sKV, ld, SP, 0, S, head(kc, h, Dc), head(kr, h, Dr),
                   cos_k, sin_k, Dc, Dr, D);
      __syncthreads();
      qk<NC>(acc, sQ, sKV, ld, D, r0, lane);
      __syncthreads();
    }
    // Each warp runs the mask MLP on its own 4 rows.
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        sM[(r0 + i) * SP + lane + 32 * c] = rnd<T>(acc[i][c]);
    __syncwarp();

    const int S2 = 2 * S;
    float hacc[kRows][2 * NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) hacc[i][c] = 0.f;
    for (int k = 0; k < S; ++k) {
      float sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = sM[(r0 + i) * SP + k];
      const float* wrow = w1t + (size_t)k * S2;
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) {
        const int j = lane + 32 * c;
        const float w = j < S2 ? rnd<T>(__ldg(wrow + j)) : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) hacc[i][c] = fmaf(sv[i], w, hacc[i][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) {
      const int j = lane + 32 * c;
      if (j < S2) {
        const float bj = __ldg(b1 + j);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          sP[(r0 + i) * 2 * SP + j] = rnd<T>(gelu(hacc[i][c] + bj));
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
      const float* wrow = w2t + (size_t)j * S;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int k = lane + 32 * c;
        const float w = k < S ? rnd<T>(__ldg(wrow + k)) : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) macc[i][c] = fmaf(av[i], w, macc[i][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = lane + 32 * c;
      const float bk = k < S ? __ldg(b2 + k) : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) sM[(r0 + i) * SP + k] = macc[i][c] + bk;
    }
  }

  // Pass 2: per head, scores + mask -> fp32 softmax -> p . v.
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head is done with sQ, sKV and sP
    load_rows<T>(sQ, ld, kTq, q0, S, head(qc, h, Dc), head(qr, h, Dr), cos_q,
                 sin_q, Dc, Dr, D);
    load_rows<T>(sKV, ld, SP, 0, S, head(kc, h, Dc), head(kr, h, Dr), cos_k,
                 sin_k, Dc, Dr, D);
    __syncthreads();
    float acc[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    qk<NC>(acc, sQ, sKV, ld, D, r0, lane);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
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
      for (int c = 0; c < NC; ++c)
        sP[(r0 + i) * SP + lane + 32 * c] = rnd<T>(acc[i][c] / sum);
    }
    __syncthreads();  // every warp is done reading k_h

    const T* vh = v + (bh0 + h) * S * Dv;
    for (int idx = threadIdx.x; idx < S * Dv; idx += kThreads)
      sKV[idx] = to_f(vh[idx]);
    __syncthreads();

    float o[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) o[i][0] = o[i][1] = 0.f;
    const bool has0 = lane < Dv;
    const bool has1 = lane + 32 < Dv;
    for (int k = 0; k < S; ++k) {
      const float v0 = has0 ? sKV[k * Dv + lane] : 0.f;
      const float v1 = has1 ? sKV[k * Dv + lane + 32] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pv = sP[(r0 + i) * SP + k];
        o[i][0] = fmaf(pv, v0, o[i][0]);
        o[i][1] = fmaf(pv, v1, o[i][1]);
      }
    }
    T* oh = out + (bh0 + h) * S * Dv;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q = q0 + r0 + i;
      if (q < S) {
        if (has0) oh[(size_t)q * Dv + lane] = from_f<T>(o[i][0]);
        if (has1) oh[(size_t)q * Dv + lane + 32] = from_f<T>(o[i][1]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* qc, const void* kc, const void* qr,
                   const void* kr, const void* v, const float* cos_q,
                   const float* sin_q, const float* cos_k,
                   const float* sin_k, const float* w1t, const float* b1,
                   const float* w2t, const float* b2, void* out, int B, int H,
                   int S, int Dc, int Dr, int Dv, float scale, int use_mask,
                   cudaStream_t stream) {
  constexpr int SP = NC * 32;
  const int ld = (Dc + Dr) | 1;
  const int ldkv = ld > Dv ? ld : Dv;
  const size_t smem =
      sizeof(float) * ((size_t)kTq * ld + (size_t)SP * ldkv +
                       (size_t)kTq * SP + (size_t)kTq * 2 * SP);
  auto kern = rope_attention_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTq - 1) / kTq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(kc),
      static_cast<const T*>(qr), static_cast<const T*>(kr),
      static_cast<const T*>(v), cos_q, sin_q, cos_k, sin_k, w1t, b1, w2t, b2,
      static_cast<T*>(out), H, S, Dc, Dr, Dv, scale, use_mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nc, const void* qc, const void* kc, const void* qr,
                     const void* kr, const void* v, const float* cos_q,
                     const float* sin_q, const float* cos_k,
                     const float* sin_k, const float* w1t, const float* b1,
                     const float* w2t, const float* b2, void* out, int B,
                     int H, int S, int Dc, int Dr, int Dv, float scale,
                     int use_mask, cudaStream_t st) {
#define CASE(N)                                                              \
  case N:                                                                    \
    return launch<T, N>(qc, kc, qr, kr, v, cos_q, sin_q, cos_k, sin_k, w1t,  \
                        b1, w2t, b2, out, B, H, S, Dc, Dr, Dv, scale,        \
                        use_mask, st);
  switch (nc) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (S % 16 == 0, D <= 64, Dv <= 64): the same
// function, with its four products -- q k^T, ssum W1^T, a W2^T, p v -- as
// WMMA 16x16x16 bf16 tiles accumulating in fp32 (mma.sync). Rounding points
// are the CUDA-core kernel's: q/k after rotation, ssum, the weights, the GELU
// output and p are bf16; every sum is fp32.
//
// One CTA of 8 warps owns 64 query rows (4 row tiles) and all S keys; the
// (64 x S) score and mask tiles are dealt to the warps round-robin (at most 8
// each for S <= 256). The mask m stays in the warps' accumulator fragments
// from the MLP through pass 2, where it is added to each head's scores in
// registers. The MLP runs over the 2S hidden units in chunks of 32: h1 chunk
// (64 x 32) -> exact GELU -> bf16 chunk in shared memory -> accumulated into
// m. W1^T / W2^T (bf16, prepared by the wrapper) are read from global
// memory / L2 by the fragment loads. Shared memory: q tile, k_h (then v_h),
// an fp32 staging tile and a bf16 ssum/p tile, ~127 KB at S=224.
namespace tc {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
constexpr int kTq = 64;          // query rows per CTA
constexpr int kRowTiles = kTq / 16;
constexpr int kMaxTiles = 8;     // score tiles per warp: 4 * (256/16) / 8
constexpr int kChunk = 32;       // hidden units per mask-MLP step
constexpr int kPadB = 8;         // bf16 row padding against bank conflicts
constexpr int kPadF = 4;         // fp32 row padding

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBt;  // X^T of a row-major X
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Layout {
  int dp, dvp, ldq, ldkv, ldf, ldp;
  __host__ __device__ Layout(int D, int Dv, int S) {
    dp = (D + 15) & ~15;
    dvp = (Dv + 15) & ~15;
    ldq = (dp > kChunk ? dp : kChunk) + kPadB;
    ldkv = (dp > dvp ? dp : dvp) + kPadB;
    ldf = (S > 64 ? S : 64) + kPadF;
    ldp = S + kPadB;
  }
  // Every region size is a multiple of 32 bytes, so each WMMA tile pointer
  // stays 256-bit aligned.
  __host__ __device__ size_t bytes(int S) const {
    return 2 * (size_t)kTq * ldq + 2 * (size_t)S * ldkv +
           4 * (size_t)kTq * ldf + 2 * (size_t)kTq * ldp;
  }
};

// acc[i] += q k^T for the warp's tiles t = warp + 8i (row tile t % 4, key
// tile t / 4) over dp columns.
__device__ __forceinline__ void qk_tiles(FragC (&acc)[kMaxTiles],
                                         const bf16* Qs, int ldq,
                                         const bf16* Ks, int ldk, int dp,
                                         int warp, int ntiles) {
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int t = warp + kWarps * i;
    if (t < ntiles) {
      const int rt = t % kRowTiles, ct = t / kRowTiles;
      for (int kk = 0; kk < dp; kk += 16) {
        FragA a;
        FragBt bt;
        wmma::load_matrix_sync(a, Qs + rt * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(bt, Ks + ct * 16 * ldk + kk, ldk);
        wmma::mma_sync(acc[i], a, bt, acc[i]);
      }
    }
  }
}

__device__ __forceinline__ void store_tiles(float* F, int ldf,
                                            FragC (&acc)[kMaxTiles],
                                            int warp, int ntiles) {
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int t = warp + kWarps * i;
    if (t < ntiles)
      wmma::store_matrix_sync(F + (t % kRowTiles) * 16 * ldf +
                                  (t / kRowTiles) * 16,
                              acc[i], ldf, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void zero(FragC (&acc)[kMaxTiles]) {
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) wmma::fill_fragment(acc[i], 0.f);
}

__global__ void __launch_bounds__(kThreads) rope_attention_fwd_tc_kernel(
    const bf16* __restrict__ qc, const bf16* __restrict__ kc,
    const bf16* __restrict__ qr, const bf16* __restrict__ kr,
    const bf16* __restrict__ v, const float* __restrict__ cos_q,
    const float* __restrict__ sin_q, const float* __restrict__ cos_k,
    const float* __restrict__ sin_k, const bf16* __restrict__ w1t,
    const float* __restrict__ b1, const bf16* __restrict__ w2t,
    const float* __restrict__ b2, bf16* __restrict__ out, int H, int S,
    int Dc, int Dr, int Dv, float scale, int use_mask) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = Dc + Dr;
  const Layout L(D, Dv, S);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // kTq x ldq: q, a chunk
  bf16* KVs = Qs + kTq * L.ldq;                   // S x ldkv: k_h, then v_h
  float* F = reinterpret_cast<float*>(KVs + S * L.ldkv);  // kTq x ldf
  bf16* Pb = reinterpret_cast<bf16*>(F + kTq * L.ldf);    // kTq x ldp

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = kRowTiles * (S / 16);
  const size_t bh0 = (size_t)b * H;
  auto head = [&](const bf16* base, int h, int dim) -> const bf16* {
    return base ? base + (bh0 + h) * S * dim : nullptr;
  };

  FragC macc[kMaxTiles];  // the mask m (without b2), kept in registers
  if (!use_mask) zero(macc);
  if (use_mask) {
    FragC acc[kMaxTiles];
    zero(acc);
    for (int h = 0; h < H; ++h) {
      __syncthreads();
      load_rows<bf16>(Qs, L.ldq, kTq, q0, S, head(qc, h, Dc),
                      head(qr, h, Dr), cos_q, sin_q, Dc, Dr, L.dp);
      load_rows<bf16>(KVs, L.ldkv, S, 0, S, head(kc, h, Dc),
                      head(kr, h, Dr), cos_k, sin_k, Dc, Dr, L.dp);
      __syncthreads();
      qk_tiles(acc, Qs, L.ldq, KVs, L.ldkv, L.dp, warp, ntiles);
    }
    store_tiles(F, L.ldf, acc, warp, ntiles);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTq * S; idx += kThreads) {
      const int i = idx / S, k = idx - i * S;
      Pb[i * L.ldp + k] = __float2bfloat16(F[i * L.ldf + k]);  // ssum
    }
    __syncthreads();

    const int S2 = 2 * S;
    const int lda = kChunk + kPadB;
    bf16* As = Qs;
    zero(macc);
    for (int j0 = 0; j0 < S2; j0 += kChunk) {
      {  // h1 chunk: 4 x 2 tiles, one per warp
        const int rt = warp % kRowTiles, ct = warp / kRowTiles;
        FragC hacc;
        wmma::fill_fragment(hacc, 0.f);
        for (int kk = 0; kk < S; kk += 16) {
          FragA a;
          FragB bw;
          wmma::load_matrix_sync(a, Pb + rt * 16 * L.ldp + kk, L.ldp);
          wmma::load_matrix_sync(bw, w1t + (size_t)kk * S2 + j0 + ct * 16,
                                 S2);
          wmma::mma_sync(hacc, a, bw, hacc);
        }
        wmma::store_matrix_sync(F + rt * 16 * L.ldf + ct * 16, hacc, L.ldf,
                                wmma::mem_row_major);
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTq * kChunk; idx += kThreads) {
        const int i = idx / kChunk, j = idx - i * kChunk;
        As[i * lda + j] =
            __float2bfloat16(gelu(F[i * L.ldf + j] + __ldg(b1 + j0 + j)));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        const int t = warp + kWarps * i;
        if (t < ntiles) {
          const int rt = t % kRowTiles, ct = t / kRowTiles;
#pragma unroll
          for (int kk = 0; kk < kChunk; kk += 16) {
            FragA a;
            FragB bw;
            wmma::load_matrix_sync(a, As + rt * 16 * lda + kk, lda);
            wmma::load_matrix_sync(bw, w2t + (size_t)(j0 + kk) * S + ct * 16,
                                   S);
            wmma::mma_sync(macc[i], a, bw, macc[i]);
          }
        }
      }
    }
  }

  const int vt = L.dvp / 16;
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    load_rows<bf16>(Qs, L.ldq, kTq, q0, S, head(qc, h, Dc), head(qr, h, Dr),
                    cos_q, sin_q, Dc, Dr, L.dp);
    load_rows<bf16>(KVs, L.ldkv, S, 0, S, head(kc, h, Dc), head(kr, h, Dr),
                    cos_k, sin_k, Dc, Dr, L.dp);
    __syncthreads();
    {
      FragC acc[kMaxTiles];
      zero(acc);
      qk_tiles(acc, Qs, L.ldq, KVs, L.ldkv, L.dp, warp, ntiles);
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
        for (int e = 0; e < acc[i].num_elements; ++e)
          acc[i].x[e] = acc[i].x[e] * scale + macc[i].x[e];
      store_tiles(F, L.ldf, acc, warp, ntiles);
    }
    __syncthreads();

    // v_h into the buffer k_h used; softmax of each row into Pb.
    const bf16* vh = v + (bh0 + h) * S * Dv;
    for (int idx = threadIdx.x; idx < S * L.dvp; idx += kThreads) {
      const int i = idx / L.dvp, d = idx - i * L.dvp;
      KVs[i * L.ldkv + d] = d < Dv ? vh[(size_t)i * Dv + d]
                                   : __float2bfloat16(0.f);
    }
    for (int r = warp; r < kTq; r += kWarps) {
      float x[8];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = lane + 32 * c;
        x[c] = -INFINITY;
        if (k < S) x[c] = F[r * L.ldf + k] + (use_mask ? __ldg(b2 + k) : 0.f);
        mx = fmaxf(mx, x[c]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        x[c] = lane + 32 * c < S ? expf(x[c] - mx) : 0.f;
        sum += x[c];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = lane + 32 * c;
        if (k < S) Pb[r * L.ldp + k] = __float2bfloat16(x[c] / sum);
      }
    }
    __syncthreads();

    for (int t = warp; t < kRowTiles * vt; t += kWarps) {
      const int rt = t % kRowTiles, ct = t / kRowTiles;
      FragC o;
      wmma::fill_fragment(o, 0.f);
      for (int kk = 0; kk < S; kk += 16) {
        FragA a;
        FragB bv;
        wmma::load_matrix_sync(a, Pb + rt * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(bv, KVs + kk * L.ldkv + ct * 16, L.ldkv);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(F + rt * 16 * L.ldf + ct * 16, o, L.ldf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    bf16* oh = out + (bh0 + h) * S * Dv;
    for (int idx = threadIdx.x; idx < kTq * Dv; idx += kThreads) {
      const int i = idx / Dv, d = idx - i * Dv;
      if (q0 + i < S)
        oh[(size_t)(q0 + i) * Dv + d] = __float2bfloat16(F[i * L.ldf + d]);
    }
  }
}

}  // namespace tc

}  // namespace

// Returns a cudaError_t (0 on success). Shapes: qc/kc (B,H,S,Dc) or null
// when Dc == 0; qr/kr (B,H,S,Dr) or null when Dr == 0; v/out (B,H,S,Dv);
// tables (S,Dr) fp32; w1t (S,2S), b1 (2S), w2t (2S,S), b2 (S) fp32, unused
// when use_mask == 0. All contiguous.
extern "C" int rope_attention_fwd(
    int is_bf16, const void* qc, const void* kc, const void* qr,
    const void* kr, const void* v, const float* cos_q, const float* sin_q,
    const float* cos_k, const float* sin_k, const float* w1t, const float* b1,
    const float* w2t, const float* b2, void* out, int B, int H, int S, int Dc,
    int Dr, int Dv, float scale, int use_mask, void* stream) {
  const int nc = (S + 31) / 32;
  if (B < 1 || H < 1 || S < 1 || nc > 8 || Dc < 0 || Dr < 0 || Dr % 2 ||
      Dc + Dr < 1 || Dv < 1 || Dv > kMaxDv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(nc, qc, kc, qr, kr, v, cos_q, sin_q,
                                        cos_k, sin_k, w1t, b1, w2t, b2, out,
                                        B, H, S, Dc, Dr, Dv, scale, use_mask,
                                        st);
  return (int)dispatch<float>(nc, qc, kc, qr, kr, v, cos_q, sin_q, cos_k,
                              sin_k, w1t, b1, w2t, b2, out, B, H, S, Dc, Dr,
                              Dv, scale, use_mask, st);
}

// The tensor-core path: bf16 only, S % 16 == 0, S <= 256, D and Dv <= 64.
// w1t (S,2S) and w2t (2S,S) are bf16 here. Returns a cudaError_t.
extern "C" int rope_attention_fwd_tc(
    const void* qc, const void* kc, const void* qr, const void* kr,
    const void* v, const float* cos_q, const float* sin_q,
    const float* cos_k, const float* sin_k, const void* w1t, const float* b1,
    const void* w2t, const float* b2, void* out, int B, int H, int S, int Dc,
    int Dr, int Dv, float scale, int use_mask, void* stream) {
  const int D = Dc + Dr;
  if (B < 1 || H < 1 || S < 16 || S % 16 || S > 256 || Dc < 0 || Dr < 0 ||
      Dr % 2 || D < 1 || D > 64 || Dv < 1 || Dv > kMaxDv)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  const size_t smem = tc::Layout(D, Dv, S).bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      tc::rope_attention_fwd_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + tc::kTq - 1) / tc::kTq, B);
  tc::rope_attention_fwd_tc_kernel<<<grid, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qc), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(qr), static_cast<const bf16*>(kr),
      static_cast<const bf16*>(v), cos_q, sin_q, cos_k, sin_k,
      static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t), b2,
      static_cast<bf16*>(out), H, S, Dc, Dr, Dv, scale, use_mask);
  return (int)cudaGetLastError();
}
