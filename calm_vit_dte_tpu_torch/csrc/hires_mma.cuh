// Tensor-core building blocks of the bf16 route of the long-sequence
// attention kernels (forward: hires_attention.cu, backward:
// hires_attention_bwd.cu), written for Hopper (sm_90a) on mma.sync.m16n8k16
// (bf16 in, fp32 accumulate; mma_common.cuh):
//   * the strided product (hires_common.cuh's Gemm) on the tensor cores:
//     ssum with the heads as the outer contraction, the mask MLP forward and
//     backward with their epilogues, the weight grads split over the rows;
//   * the chunk ring of the attention kernels: [64 rows][kChunkCols
//     columns] bf16 tiles streamed through kRingStages cp.async stages, and
//     the products a warp forms from them.
// The bf16 route takes S, D and Dv that are multiples of 8 (every row of
// every operand then starts on 16 bytes, so every copy is a 16-byte
// cp.async); tiles are zero-padded past the matrix edges, which is exact.
#pragma once

#include "hires_common.cuh"
#include "mma_common.cuh"

namespace {

using tcore::bf16;

// ---------------------------------------------------------------------------
// The strided product on the tensor cores. One CTA of 8 warps owns a 128 x
// 128 tile of C; warp w owns rows 64 (w % 2) and columns 32 (w / 2) of it:
// 4 x 4 mma tiles, 64 fp32 accumulators a thread. The contraction steps by
// kGemmBK through kGemmStages cp.async stages (two copies in flight while
// one stage computes). An operand whose contraction axis is unit-stride is
// staged [row][k] and read with ldmatrix; one whose row axis is unit-stride
// (the weight grads' X^T) is staged [k][row] and read with ldmatrix.trans.
// The epilogue runs from the accumulators, two columns per store.
constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64;
constexpr int kGemmStages = 3;
constexpr int kGemmThreads = 256;
// bf16 elements of one operand's stage: [128][BK + 8] or [BK][128 + 8].
constexpr int kGemmOpElems = kGemmBM * (kGemmBK + 8) > kGemmBK * (kGemmBM + 8)
                                 ? kGemmBM * (kGemmBK + 8)
                                 : kGemmBK * (kGemmBM + 8);
// 16-byte copies of one operand's stage, and per thread.
constexpr int kGemmCopies = kGemmBM * kGemmBK / 8;
constexpr int kGemmCopiesPerThread = kGemmCopies / kGemmThreads;
constexpr size_t kGemmSmem = (size_t)kGemmStages * 2 * kGemmOpElems * 2;
// The weight grads contract over all B*S rows: each output tile's rows are
// split into kWgSplits fixed ranges whose partial products are summed in
// order by sum_partials_kernel (at S = 448 the 2S x S output has only 28
// tiles of 128 x 128; split, 224 CTAs per product). Both routes split, on
// the tensor cores (bf16) or on the CUDA cores (gemm_kernel, fp32).
constexpr int kWgSplits = 8;

// Two adjacent outputs (columns n, n + 1 of row m) through the epilogue;
// N is even, so both are in range when n is.
__device__ __forceinline__ void store_pair(const Gemm& gm, int z, int m,
                                           int n, float x0, float x1) {
  if (m >= gm.M || n >= gm.N) return;
  const long long at = z * gm.sCz + (long long)m * gm.ldc + n;
  if (gm.bias) {
    const float2 bb = *reinterpret_cast<const float2*>(gm.bias + n);
    if (gm.epilogue != kDgeluMul) x0 += bb.x, x1 += bb.y;
  }
  switch (gm.epilogue) {
    case kStoreF32:
      *reinterpret_cast<float2*>(static_cast<float*>(gm.C) + at) =
          make_float2(x0, x1);
      break;
    case kStoreT:
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(gm.C) + at) =
          tcore::pack(x0, x1);
      break;
    case kGelu:
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(gm.C) + at) =
          tcore::pack(gelu(x0), gelu(x1));
      if (gm.C2)
        *reinterpret_cast<float2*>(gm.C2 + at) = make_float2(dgelu(x0),
                                                             dgelu(x1));
      break;
    default: {  // kDgeluMul
      const float2 gp = *reinterpret_cast<const float2*>(gm.C2 + at);
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(gm.C) + at) =
          tcore::pack(x0 * gp.x, x1 * gp.y);
    }
  }
}

// kAKM: A is staged [k][m] (its m axis is unit-stride); kBKN: B is staged
// [k][n] (its n axis is unit-stride).
template <bool kAKM, bool kBKN>
__global__ void __launch_bounds__(kGemmThreads) gemm_tc_kernel(const Gemm gm) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char gsm[];
  constexpr int ldA = kAKM ? kGemmBM + 8 : kGemmBK + 8;
  constexpr int ldB = kBKN ? kGemmBN + 8 : kGemmBK + 8;
  bf16* stages = reinterpret_cast<bf16*>(gsm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int z = blockIdx.z;
  const bf16* A = static_cast<const bf16*>(gm.A) + z * gm.sAz;
  const bf16* Bm = static_cast<const bf16*>(gm.B) + z * gm.sBz;
  // With Ktot, blockIdx.z is a split of the contraction: rows [z K, z K + K).
  const int K = gm.Ktot ? max(0, min(gm.K, gm.Ktot - z * gm.K)) : gm.K;
  const long long lda = kAKM ? gm.sAk : gm.sAm;
  const long long ldb = kBKN ? gm.sBk : gm.sBn;
  const int nk = (K + kGemmBK - 1) / kGemmBK;
  const int steps = nk * gm.KO;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Step s: outer index s / nk, contraction columns [k0, k0 + kGemmBK).
  auto load = [&](int s) {
    if (s < steps) {
      const int o = s / nk, k0 = (s - o * nk) * kGemmBK;
      bf16* sA = stages + (s % kGemmStages) * 2 * kGemmOpElems;
      bf16* sB = sA + kGemmOpElems;
      const bf16* Ao = A + o * gm.sAo;
      const bf16* Bo = Bm + o * gm.sBo;
      constexpr int kPerRowK = kGemmBK / 8, kPerRowMN = kGemmBM / 8;
#pragma unroll
      for (int it = 0; it < kGemmCopiesPerThread; ++it) {
        const int idx = tid + it * kGemmThreads;
        int r, c, mm, kk;
        if (kAKM)
          r = idx / kPerRowMN, c = (idx % kPerRowMN) * 8, kk = k0 + r,
          mm = m0 + c;
        else
          r = idx / kPerRowK, c = (idx % kPerRowK) * 8, mm = m0 + r,
          kk = k0 + c;
        bf16* d = sA + r * ldA + c;
        if (mm < gm.M && kk < K)
          cp_async16(d, Ao + (kAKM ? kk * lda + mm : mm * lda + kk));
        else
          *reinterpret_cast<uint4*>(d) = zero;
        int nn;
        if (kBKN)
          r = idx / kPerRowMN, c = (idx % kPerRowMN) * 8, kk = k0 + r,
          nn = n0 + c;
        else
          r = idx / kPerRowK, c = (idx % kPerRowK) * 8, nn = n0 + r,
          kk = k0 + c;
        d = sB + r * ldB + c;
        if (nn < gm.N && kk < K)
          cp_async16(d, Bo + (kBKN ? kk * ldb + nn : nn * ldb + kk));
        else
          *reinterpret_cast<uint4*>(d) = zero;
      }
    }
    cp_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<kGemmStages - 2>();
    __syncthreads();  // step s has landed; step s - 1's stage is free
    load(s + kGemmStages - 1);
    const bf16* sA = stages + (s % kGemmStages) * 2 * kGemmOpElems;
    const bf16* sB = sA + kGemmOpElems;
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kAKM) load_a_t(a[i], sA, ldA, kk, wm + i * 16, lane);
        else load_a(a[i], sA + (wm + i * 16) * ldA, ldA, kk, lane);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        if (kBKN) load_b_kn(b, sB, ldB, wn + p * 16, kk, lane);
        else load_b_nk(b, sB, ldB, wn + p * 16, kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma(acc[i][2 * p], a[i], b[0], b[1]);
          mma(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_pair(gm, z, m0 + wm + i * 16 + g + 8 * hf,
                   n0 + wn + j * 8 + 2 * t, acc[i][j][2 * hf],
                   acc[i][j][2 * hf + 1]);
}

template <bool kAKM, bool kBKN>
cudaError_t launch_gemm_tc(const Gemm& g, int Z, cudaStream_t st,
                           Report& rep) {
  auto kern = gemm_tc_kernel<kAKM, kBKN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + kGemmBN - 1) / kGemmBN, (g.M + kGemmBM - 1) / kGemmBM,
                  Z);
  kern<<<grid, kGemmThreads, kGemmSmem, st>>>(g);
  return rep.done(kGemmSmem);
}

// The strided product in the compute type: bf16 on the tensor cores where
// the call's operands are `aligned` (Family; the staging of each operand
// picked by which of its strides is 1), every other call on the CUDA cores
// (gemm_kernel, hires_common.cuh).
template <typename T>
cudaError_t gemm(const Gemm& g, int Z, bool aligned, cudaStream_t st,
                 Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (aligned) {
      const bool akm = g.sAm == 1, bkn = g.sBn == 1;
      if (akm && bkn) return launch_gemm_tc<true, true>(g, Z, st, rep);
      if (akm) return launch_gemm_tc<true, false>(g, Z, st, rep);
      if (bkn) return launch_gemm_tc<false, true>(g, Z, st, rep);
      return launch_gemm_tc<false, false>(g, Z, st, rep);
    }
  }
  return gemm_cuda_cores<T>(g, Z, st, rep);
}

// out_j[i] = sum_{z < splits} part_j[z * n + i] in order of z, for the two
// jobs j = blockIdx.y; a thread takes four consecutive i, as a float4 where
// n is a multiple of 4 (every partial row on 16 bytes), else one by one.
__global__ void sum_partials_kernel(const float* __restrict__ part0,
                                    float* __restrict__ out0,
                                    const float* __restrict__ part1,
                                    float* __restrict__ out1, long long n,
                                    int splits) {
  const float* part = blockIdx.y ? part1 : part0;
  float* out = blockIdx.y ? out1 : out0;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (n % 4) {
    for (long long e = i; e < i + 4 && e < n; ++e) {
      float s = part[e];
      for (int z = 1; z < splits; ++z) s += part[z * n + e];
      out[e] = s;
    }
    return;
  }
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + z * n + i);
    s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
  }
  *reinterpret_cast<float4*>(out + i) = s;
}

// ---------------------------------------------------------------------------
// The chunk ring of the bf16 attention kernels. A CTA of 4 warps owns 64
// rows (each warp 16); the operands it streams (key rows of k, v, and of q,
// g in the dm/ssum kernel) arrive as [64 rows][kChunkCols columns] bf16
// chunks (row stride kChunkLd) through kRingStages cp.async stages: chunk
// i + kRingStages - 1 is copied while chunk i computes. A chunk's
// contraction steps past the padded width (pad16 of D or Dv) are skipped,
// so at D = 208 the last chunk costs one k-step of 16, not a full chunk.
constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kAttnRows = 16 * kAttnWarps;   // rows of a CTA's tile, keys
                                             // of a key tile
constexpr int kChunkCols = 64;               // columns of a chunk
constexpr int kChunkSteps = kChunkCols / 16; // its k-steps (or n-pairs)
constexpr int kChunkN = kChunkCols / 8;      // its 8-column mma tiles
constexpr int kChunkLd = kChunkCols + 8;
constexpr int kMaxChunks = 256 / kChunkCols;  // chunks of the widest D, Dv
constexpr int kChunkElems = kAttnRows * kChunkLd;
constexpr int kRingStages = 4;

__host__ __device__ inline int chunks_of(int width) {
  return (width + kChunkCols - 1) / kChunkCols;
}

// The wide kernels split an output `width` columns wide over ns CTAs
// (ns at least slices_of(width)): slice z owns columns [z c, z c + c) with
// c = split_cols(width, ns), a multiple of 16 and at most kSlice; the last
// slice keeps what remains, which may be nothing.
__host__ __device__ inline int split_cols(int width, int ns) {
  return tcore::pad16((width + ns - 1) / ns);
}

// k-steps of 16 in chunk c of a `width`-wide operand (padded to 16).
__device__ __forceinline__ int chunk_steps(int width, int c) {
  return min(kChunkSteps, tcore::pad16(width) / 16 - kChunkSteps * c);
}

// Rows [0, 64) x columns [c0, c0 + cols) of a row-major bf16 matrix (row
// stride `ld`, a multiple of 8) into dst (row stride dld), by the NT
// threads of the CTA; rows at or past `live` and columns at or past `width`
// become zeros. No commit.
template <int NT = kAttnThreads>
__device__ __forceinline__ void copy_rows(bf16* dst, int dld, const bf16* src,
                                          int ld, int live, int c0, int width,
                                          int cols) {
  for (int idx = threadIdx.x; idx < kAttnRows * (cols / 8); idx += NT) {
    const int r = idx / (cols / 8), c = (idx - r * (cols / 8)) * 8;
    bf16* d = dst + r * dld + c;
    if (r < live && c0 + c < width)
      tcore::cp_async16(d, src + (size_t)r * ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// Chunk c (columns [c kChunkCols, (c + 1) kChunkCols)) of the 64 rows of a
// row-major matrix of `width` columns, into a ring stage.
template <int NT = kAttnThreads>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src,
                                           int width, int live, int c) {
  copy_rows<NT>(dst, kChunkLd, src, width, live, c * kChunkCols, width,
                kChunkCols);
}

// The resident [64][pad16(width) + 8] tile of a CTA's own rows.
template <int NT = kAttnThreads>
__device__ __forceinline__ void copy_resident(bf16* dst, const bf16* src,
                                              int width, int live) {
  const int wp = tcore::pad16(width);
  copy_rows<NT>(dst, wp + 8, src, width, live, 0, width, wp);
}

// acc[n] += X[16 warp rows][cols c kChunkCols + 16 kk] . Ch[key n*8..][16 kk]^T
// over the chunk's k-steps: X a tile of rows (row stride ldx), Ch a chunk
// of 64 key rows stored [key][column].
__device__ __forceinline__ void rows_by_chunk(float (&acc)[8][4],
                                              const bf16* X, int ldx, int c,
                                              const bf16* Ch, int steps,
                                              int lane, int warp) {
  using namespace tcore;
#pragma unroll
  for (int kk = 0; kk < kChunkSteps; ++kk) {
    if (kk < steps) {
      uint32_t a[4];
      load_a(a, X + warp * 16 * ldx, ldx, c * kChunkCols + kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        load_b_nk(b, Ch, kChunkLd, n2 * 16, kk * 16, lane);
        mma(acc[2 * n2], a, b[0], b[1]);
        mma(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[u kChunkN + n] += P[16 warp rows][64 keys] . Ch[64 keys][cols n*8..]
// for the n-tiles inside the chunk's padded width: P as the A fragments of
// the four 16-key steps (pa), Ch a chunk stored [key][column].
template <int NA>
__device__ __forceinline__ void probs_by_chunk(float (&acc)[NA][4], int u,
                                               const uint32_t (&pa)[4][4],
                                               const bf16* Ch, int steps,
                                               int lane) {
  using namespace tcore;
#pragma unroll
  for (int n2 = 0; n2 < kChunkSteps; ++n2) {
    if (n2 < steps) {
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t b[4];
        load_b_kn(b, Ch, kChunkLd, n2 * 16, kb * 16, lane);
        mma(acc[u * kChunkN + 2 * n2], pa[kb], b[0], b[1]);
        mma(acc[u * kChunkN + 2 * n2 + 1], pa[kb], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

}  // namespace
