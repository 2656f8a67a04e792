// Building blocks of the long-sequence attention kernels (forward:
// hires_attention.cu, backward: hires_attention_bwd.cu), written for Hopper
// (sm_90a) in plain CUDA C++:
//   * a batched, strided matrix product with fused epilogues (the mask MLP,
//     the head-summed scores, the weight grads): every product the Pallas
//     bodies hand to the MXU inside the kernel runs here, not in a library;
//   * the register-tile products over 64-row tiles in shared memory that the
//     attention kernels are built from, and their row reductions.
// Every product reads the compute type T (float or bf16) and accumulates in
// fp32 as fp32 FMAs: the fp32 route. The bf16 route's products run on the
// tensor cores (hires_mma.cuh). Nothing is
// atomic, so every result is the same from run to run.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;    // rows and columns of a product tile
constexpr int kDepth = 16;   // contraction step staged in shared memory
constexpr int kLdP = kTile + 1;

__device__ __forceinline__ float dgelu(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// ---------------------------------------------------------------------------
// C[z] = epilogue( sum_{o < KO} sum_{k < K} A(z, o, m, k) B(z, o, k, n) )
// with A(z, o, m, k) = A[z*sAz + o*sAo + m*sAm + k*sAk] and B likewise, so a
// transpose is a choice of strides and a sum over heads is the outer
// contraction index o. One CTA of 256 threads owns a 64 x 64 tile of C and
// runs the whole contraction in order; each thread owns 4 x 4 outputs at
// rows ty + 16i, columns tx + 16j.
enum Epilogue {
  kStoreF32 = 0,   // C (fp32) = acc + bias[n]
  kStoreT = 1,     // C (T) = round(acc + bias[n])
  kGelu = 2,       // h = acc + bias[n]: C (T) = round(gelu(h)); C2 = gelu'(h)
  kDgeluMul = 3,   // C (T) = round(acc * C2)
};

struct Gemm {
  const void* A;
  const void* B;
  void* C;
  float* C2;          // kGelu (may be null) and kDgeluMul
  const float* bias;  // may be null
  int M, N, K, KO, epilogue;
  long long sAz, sAo, sAm, sAk, sBz, sBo, sBk, sBn, sCz, ldc;
  // 0, or (bf16 only) the whole contraction length: blockIdx.z then splits
  // it into ranges of K (sAz, sBz the offsets of one range, sCz of its
  // partial output).
  int Ktot;
};

// What one entry-point call launched: its kernels, and the largest dynamic
// shared memory a CTA of them asked for. done() checks each launch.
struct Report {
  int launched = 0;
  size_t smem = 0;
  cudaError_t done(size_t bytes) {
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) {
      ++launched;
      if (bytes > smem) smem = bytes;
    }
    return err;
  }
};

// What the card makes of one kernel launched with `threads` a CTA and
// `dyn` bytes of dynamic shared memory: out[0..3] = registers a thread,
// local (spill) bytes a thread, static + dynamic shared memory a CTA, CTAs
// resident per SM.
inline cudaError_t occupancy(const void* fn, int threads, size_t dyn,
                             int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      dyn);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes + dyn);
  out[3] = ctas;
  return cudaSuccess;
}

// One output element through the epilogue (bounds-checked).
template <typename T>
__device__ __forceinline__ void store_c(const Gemm& g, int m, int n,
                                        float acc) {
  if (m >= g.M || n >= g.N) return;
  const long long at = blockIdx.z * g.sCz + m * g.ldc + n;
  const float x = acc + (g.bias ? g.bias[n] : 0.f);
  switch (g.epilogue) {
    case kStoreF32:
      static_cast<float*>(g.C)[at] = x;
      break;
    case kStoreT:
      static_cast<T*>(g.C)[at] = from_f<T>(x);
      break;
    case kGelu:
      static_cast<T*>(g.C)[at] = from_f<T>(gelu(x));
      if (g.C2) g.C2[at] = dgelu(x);
      break;
    default:  // kDgeluMul
      static_cast<T*>(g.C)[at] = from_f<T>(acc * g.C2[at]);
  }
}

// CUDA-core FMAs (the fp32 route).
template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm g) {
  __shared__ float sA[kDepth][kTile + 4];
  __shared__ float sB[kDepth][kTile + 4];
  const T* A = static_cast<const T*>(g.A) + blockIdx.z * g.sAz;
  const T* Bm = static_cast<const T*>(g.B) + blockIdx.z * g.sBz;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool a_k_fast = g.sAk == 1, b_n_fast = g.sBn == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int o = 0; o < g.KO; ++o) {
    const T* Ao = A + o * g.sAo;
    const T* Bo = Bm + o * g.sBo;
    for (int k0 = 0; k0 < g.K; k0 += kDepth) {
      for (int idx = threadIdx.x; idx < kDepth * kTile; idx += kThreads) {
        // Walk the unit-stride axis fastest, so that loads coalesce.
        const int ka = a_k_fast ? idx % kDepth : idx / kTile;
        const int ma = a_k_fast ? idx / kDepth : idx % kTile;
        const int m = m0 + ma, k = k0 + ka;
        sA[ka][ma] = m < g.M && k < g.K
                         ? to_f(Ao[m * g.sAm + k * g.sAk]) : 0.f;
        const int kb = b_n_fast ? idx / kTile : idx % kDepth;
        const int nb = b_n_fast ? idx % kTile : idx / kDepth;
        const int n = n0 + nb, kk = k0 + kb;
        sB[kb][nb] = n < g.N && kk < g.K
                         ? to_f(Bo[kk * g.sBk + n * g.sBn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_c<T>(g, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// Column sums of a row-major (R x N) X in the compute type, in two ordered
// stages: colsum_kernel sums rows [z * rows, (z + 1) * rows) of each column
// into part[z][n] (one thread per column), sum_splits_kernel adds the splits
// in order.
constexpr int kColSplits = 64;

template <typename T>
__global__ void colsum_kernel(const T* __restrict__ X, long long R, int N,
                              long long rows, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long r1 = min(R, (blockIdx.y + 1) * rows);
  float s = 0.f;
  for (long long r = blockIdx.y * rows; r < r1; ++r) s += to_f(X[r * N + n]);
  part[(long long)blockIdx.y * N + n] = s;
}

__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  int N, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * N + n];
  out[n] = s;
}

// out (N) = column sums of X (R x N); part holds kColSplits * N floats.
template <typename T>
cudaError_t colsum(const T* X, long long R, int N, float* part, float* out,
                   cudaStream_t st, Report& rep) {
  const long long rows = (R + kColSplits - 1) / kColSplits;
  const unsigned blocks = (unsigned)((N + 127) / 128);
  colsum_kernel<T><<<dim3(blocks, kColSplits), 128, 0, st>>>(X, R, N, rows,
                                                             part);
  cudaError_t err = rep.done(0);
  if (err != cudaSuccess) return err;
  sum_splits_kernel<<<blocks, 128, 0, st>>>(part, kColSplits, N, out);
  return rep.done(0);
}

// ---------------------------------------------------------------------------
// Register tiles of the attention kernels: 256 threads as 16 x 16 (tx =
// threadIdx % 16, ty = threadIdx / 16); a thread owns rows ty + 16i (i < 4)
// of a 64-row tile and columns tx + 16j (j < CJ). The 16 threads that share
// rows are one half-warp, so row reductions are shuffles over lane bits 0-3.

// acc[i][j] += sum_{k < K} A[r_i][k] * B[c_j][k]  (both row-major over k;
// odd strides keep the 16 rows a half-warp reads on different banks).
template <int CJ>
__device__ __forceinline__ void mm_nt(float (&acc)[4][CJ], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float a[4], b[CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < 64} P[r_i][k] * X[k][c_j] for columns c_j < ncols.
template <int CJ>
__device__ __forceinline__ void mm_nn(float (&acc)[4][CJ], const float* P,
                                      int ldp, const float* X, int ldx,
                                      int ncols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < kTile; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * ldp + k];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < ncols) {
        const float x = X[k * ldx + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int CJ>
__device__ __forceinline__ void zero(float (&acc)[4][CJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// Output columns per thread for head dims up to `d`: 16 * CJ >= d.
inline int cols_per_thread(int d) { return d <= 64 ? 4 : d <= 128 ? 8 : 16; }

// ---------------------------------------------------------------------------
// No head dim is bounded on the CUDA-core kernels: a CTA's register tile
// holds at most kSlice output columns (CJ = 16 a thread), so wider outputs
// are split over the grid (blockIdx.z: columns [z kSlice, (z + 1) kSlice)),
// and every contraction over D or Dv streams through shared memory kChunk
// columns at a time, in the order of a whole-row product (the same sums).
constexpr int kSlice = 256;
constexpr int kChunk = 64;
constexpr int kLdC = kChunk + 1;

inline int slices_of(int width) { return (width + kSlice - 1) / kSlice; }

// Columns of the widest slice of a `width`-wide output, and the row
// stride of a [64][slice] tile of it (odd).
__host__ __device__ inline int slice_width(int width) {
  return width < kSlice ? width : kSlice;
}
__host__ __device__ inline int slice_ld(int width) {
  return slice_width(width) | 1;
}

// The most dynamic shared memory a CTA may have on the H100.
constexpr int kMaxCtaSmem = 232448;
// The widest D of the bf16 forward on the tensor cores: its CTA keeps 64
// rows of q resident ([64][pad16(D) + 8] bf16) beside a 36,864-byte chunk
// ring, which fit in kMaxCtaSmem up to D = 1520 (hires_attention.cu
// asserts it). Dv has no limit there: o's columns are split over the grid.
constexpr int kTcFwdMaxD = 1520;
// The widest D and Dv of the bf16 dq pass on the tensor cores: past kSlice
// its wide CTA keeps 64 rows of q and of g resident ([64][pad16(D) + 8]
// and [64][pad16(Dv) + 8] bf16) beside a 27,648-byte chunk ring and a
// 32,768-byte exchange of p and dp, which fit in kMaxCtaSmem up to D = Dv
// = 544 (hires_attention_bwd.cu asserts it).
constexpr int kTcDqMaxD = 544;

// The kernels of a call, pass by pass. bf16 calls whose S, D and Dv are
// multiples of 8 (rows of 16 bytes) run their strided products and the
// dm/ssum pass on the tensor cores (aligned); of their attention passes,
// the forward runs there with D <= kTcFwdMaxD (tc_fwd), the dq pass with
// D, Dv <= kTcDqMaxD (tc_dq), and the dk/dv pass at every D and Dv (tc_dkv:
// its CTA streams k and v through its ring, so its shared memory does not
// grow with them). Past kSlice all three run their wide kernels, which
// split o, dq, dk and dv over warps or the grid. Every other pass, fp32 or
// bf16, runs the CUDA-core kernels, which read the compute type and
// accumulate in fp32.
struct Family {
  bool aligned, tc_fwd, tc_dq, tc_dkv;
};
inline Family family_of(int is_bf16, int S, int D, int Dv) {
  const bool aligned = is_bf16 && !(S % 8 || D % 8 || Dv % 8);
  return {aligned, aligned && D <= kTcFwdMaxD,
          aligned && D <= kTcDqMaxD && Dv <= kTcDqMaxD, aligned};
}

// Rows [row0, row0 + 64) x columns [c0, c0 + cols) of a row-major matrix
// with row stride src_ld into dst (row stride ld, fp32); rows past n_rows
// become zeros.
template <typename T>
__device__ void load_cols(float* dst, int ld, const T* __restrict__ src,
                          int src_ld, int row0, int n_rows, int c0,
                          int cols) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * ld + c] = row0 + r < n_rows
                          ? to_f(src[(size_t)(row0 + r) * src_ld + c0 + c])
                          : 0.f;
  }
}

// acc[i][j] += sum_{k < width} A[a0 + r_i][k] * B[b0 + c_j][k] for two
// row-major (n x width) matrices, the contraction staged kChunk columns at
// a time in sA and sB ([64][kLdC] each). Begins with a barrier, so the
// caller's last reads of sA, sB and of any tile it refills after the call
// are done before the first copy.
template <typename T>
__device__ void scores_chunked(float (&acc)[4][4], float* sA, float* sB,
                               const T* __restrict__ A, int a0,
                               const T* __restrict__ B, int b0, int n,
                               int width) {
  for (int c0 = 0; c0 < width; c0 += kChunk) {
    const int w = min(kChunk, width - c0);
    __syncthreads();
    load_cols<T>(sA, kLdC, A, width, a0, n, c0, w);
    load_cols<T>(sB, kLdC, B, width, b0, n, c0, w);
    __syncthreads();
    mm_nt<4>(acc, sA, kLdC, sB, kLdC, w);
  }
}

}  // namespace
