// Building blocks of the long-sequence attention kernels (forward:
// hires_attention.cu, backward: hires_attention_bwd.cu), written for Hopper
// (sm_90a) in plain CUDA C++:
//   * a batched, strided matrix product with fused epilogues (the mask MLP,
//     the head-summed scores, the weight grads): every product the Pallas
//     bodies hand to the MXU inside the kernel runs here, not in a library;
//   * the CUDA-core product core (a ring of fp32 stages in shared memory,
//     cp.async or register staging, float4 fragments, register tiles of at
//     least 4 x 8 a thread) that the strided product and the CUDA-core
//     forward, dm/ssum, dq and dk/dv kernels are built from, its attention
//     tiles and the row reductions.
// Every product reads the compute type T (float or bf16) and accumulates in
// fp32 as fp32 FMAs: the fp32 route. The bf16 route's products run on the
// tensor cores (hires_mma.cuh). Nothing is
// atomic, so every result is the same from run to run.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kTile = 64;    // rows and columns of a product tile
constexpr int kSMs = 132;    // the H100 SXM's streaming multiprocessors

__device__ __forceinline__ float dgelu(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// ---------------------------------------------------------------------------
// C[z] = epilogue( sum_{o < KO} sum_{k < K} A(z, o, m, k) B(z, o, k, n) )
// with A(z, o, m, k) = A[z*sAz + o*sAo + m*sAm + k*sAk] and B likewise, so a
// transpose is a choice of strides and a sum over heads is the outer
// contraction index o. Of each operand, the contraction axis or the row
// axis is unit-stride. The CUDA-core kernel (gemm_kernel, below) and the
// tensor-core one (gemm_tc_kernel, hires_mma.cuh) each give one CTA a tile
// of C and run its whole contraction in order.
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
  // 0, or the whole contraction length: blockIdx.z then splits it into
  // ranges of K (sAz, sBz the offsets of one range, sCz of its partial
  // output; the last ranges may be shorter, or empty).
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

// ---------------------------------------------------------------------------
// The CUDA-core product core (fp32 FMAs): the strided product below and the
// CUDA-core attention kernels (hires_attention.cu, hires_attention_bwd.cu)
// are built on it. Operand blocks are staged in fp32 shared memory one chunk
// at a time through a ring of kRing stages, the copy of chunk i + 2 in flight
// while chunk i is multiplied:
//   * kAsync (T = float, every row of every block starting on 16 bytes): one
//     16-byte cp.async per four elements, zeros stored past the live edge;
//   * otherwise (bf16, or fp32 rows off the multiple of 4) through
//     registers: chunk i + 2 is loaded and converted to fp32 while chunk i
//     is multiplied, and stored into its stage at the next step.
// Products read their fragments as float4 (16-byte) shared loads, and a
// thread owns at least 4 x 8 outputs, so one load feeds at least 8 FMAs.
// Every sum runs over the contraction in order, with no atomics.
constexpr int kRing = 3;

// Rows [0, nr) x columns [0, nc) of a row-major matrix of T whose element
// (r, c) is src[r * ld + c], into fp32 shared memory at dst (row stride
// lds); rows at or past live_r and columns at or past live_c become zeros.
// nc, lds and (kAsync) ld and live_c are multiples of 4.
template <typename T>
struct Block {
  const T* src;
  long long ld;
  int nr, nc, live_r, live_c;
  float* dst;
  int lds;
};

template <int kNT>
__device__ __forceinline__ void copy_async(const Block<float>& b) {
  const int units = b.nc >> 2;
  for (int idx = threadIdx.x; idx < b.nr * units; idx += kNT) {
    const int r = idx / units, c = (idx - r * units) << 2;
    float* d = b.dst + r * b.lds + c;
    if (r < b.live_r && c < b.live_c)
      tcore::cp_async16(d, b.src + r * b.ld + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The register path: element e = threadIdx.x + u kNT of the pair (a's
// first, then b's) goes to v[u].
template <typename T, int kNT, int kPf>
__device__ __forceinline__ void load_regs(float (&v)[kPf], const Block<T>& a,
                                          const Block<T>& b) {
  const int na = a.nr * a.nc, n = na + b.nr * b.nc;
#pragma unroll
  for (int u = 0; u < kPf; ++u) {
    const int e = threadIdx.x + u * kNT;
    float x = 0.f;
    if (e < na) {
      const int r = e / a.nc, c = e - r * a.nc;
      if (r < a.live_r && c < a.live_c) x = to_f(a.src[r * a.ld + c]);
    } else if (e < n) {
      const int f = e - na, r = f / b.nc, c = f - r * b.nc;
      if (r < b.live_r && c < b.live_c) x = to_f(b.src[r * b.ld + c]);
    }
    v[u] = x;
  }
}

template <typename T, int kNT, int kPf>
__device__ __forceinline__ void store_regs(const float (&v)[kPf],
                                           const Block<T>& a,
                                           const Block<T>& b) {
  const int na = a.nr * a.nc, n = na + b.nr * b.nc;
#pragma unroll
  for (int u = 0; u < kPf; ++u) {
    const int e = threadIdx.x + u * kNT;
    if (e < na) {
      const int r = e / a.nc;
      a.dst[r * a.lds + e - r * a.nc] = v[u];
    } else if (e < n) {
      const int f = e - na, r = f / b.nc;
      b.dst[r * b.lds + f - r * b.nc] = v[u];
    }
  }
}

// The register path four columns at a time (kUnits): unit w = threadIdx.x
// + u kNT of the pair (a's units first) is four consecutive columns of one
// row, loaded as one 8-byte (bf16) or 16-byte (fp32) vector where all four
// are live and the address is aligned, else element by element, and stored
// as one float4: one index computation per four elements. v holds kPf / 4
// units; nc and lds are multiples of 4.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int live) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (live >= 4 && at % (4 * sizeof(T)) == 0) {
    if constexpr (std::is_same<T, float>::value) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(x.x << 16),
                         __uint_as_float(x.x & 0xffff0000u),
                         __uint_as_float(x.y << 16),
                         __uint_as_float(x.y & 0xffff0000u));
    }
  }
  return make_float4(live > 0 ? to_f(p[0]) : 0.f, live > 1 ? to_f(p[1]) : 0.f,
                     live > 2 ? to_f(p[2]) : 0.f, live > 3 ? to_f(p[3]) : 0.f);
}

template <typename T, int kNT, int kPf>
__device__ __forceinline__ void load_units(float (&v)[kPf], const Block<T>& a,
                                           const Block<T>& b) {
  const int qa = a.nc >> 2, qb = b.nc >> 2;
  const int ua = a.nr * qa, n = ua + b.nr * qb;
#pragma unroll
  for (int u = 0; u < kPf / 4; ++u) {
    const int w = threadIdx.x + u * kNT;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w < n) {
      const bool in_a = w < ua;
      const int f = in_a ? w : w - ua, q = in_a ? qa : qb;
      const int r = f / q, c = (f - r * q) << 2;
      if (r < (in_a ? a.live_r : b.live_r))
        x = load4((in_a ? a.src : b.src) + r * (in_a ? a.ld : b.ld) + c,
                  (in_a ? a.live_c : b.live_c) - c);
    }
    v[4 * u] = x.x, v[4 * u + 1] = x.y, v[4 * u + 2] = x.z,
    v[4 * u + 3] = x.w;
  }
}

template <typename T, int kNT, int kPf>
__device__ __forceinline__ void store_units(const float (&v)[kPf],
                                            const Block<T>& a,
                                            const Block<T>& b) {
  const int qa = a.nc >> 2, qb = b.nc >> 2;
  const int ua = a.nr * qa, n = ua + b.nr * qb;
#pragma unroll
  for (int u = 0; u < kPf / 4; ++u) {
    const int w = threadIdx.x + u * kNT;
    if (w < n) {
      const bool in_a = w < ua;
      const int f = in_a ? w : w - ua, q = in_a ? qa : qb;
      const int r = f / q, c = (f - r * q) << 2;
      *reinterpret_cast<float4*>((in_a ? a.dst : b.dst) +
                                 r * (in_a ? a.lds : b.lds) + c) =
          make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
    }
  }
}

// The ring of kRing stages of `stage` floats at `base`, over n chunks;
// plan(at, stage, a, b) names chunk at's one or two blocks (b left empty:
// one) at its stage. Construction begins chunks 0 and 1; each next() waits
// for chunk i (a barrier: every thread is done with chunk i - 1), starts
// chunk i + 2 and returns chunk i's stage. kNT threads call every step; kPf
// bounds a thread's elements of one chunk on the register path, which with
// kUnits moves four columns at a time (load_units: kPf a multiple of 4).
template <typename T, bool kAsync, int kNT, int kPf, typename Plan,
          bool kUnits = false>
struct Ring {
  static_assert(!kAsync || std::is_same<T, float>::value,
                "cp.async copies fp32 rows");
  const Plan& plan;
  float* base;
  int stage, n, i;
  float v[kAsync ? 1 : kPf];

  __device__ Ring(const Plan& p, float* b, int st, int count)
      : plan(p), base(b), stage(st), n(count), i(0) {
    issue(0);
    if constexpr (!kAsync) put(0);
    issue(1);
  }
  __device__ float* at(int c) const { return base + (c % kRing) * stage; }
  __device__ void issue(int c) {
    if (c < n) {
      Block<T> a{}, b{};
      plan(c, at(c), a, b);
      if constexpr (kAsync) {
        copy_async<kNT>(a);
        if (b.nr) copy_async<kNT>(b);
      } else if constexpr (kUnits) {
        load_units<T, kNT, kPf>(v, a, b);
      } else {
        load_regs<T, kNT, kPf>(v, a, b);
      }
    }
    if constexpr (kAsync) tcore::cp_commit();
  }
  __device__ void put(int c) {
    if (c < n) {
      Block<T> a{}, b{};
      plan(c, at(c), a, b);
      if constexpr (kUnits)
        store_units<T, kNT, kPf>(v, a, b);
      else
        store_regs<T, kNT, kPf>(v, a, b);
    }
  }
  __device__ const float* next() {
    if constexpr (kAsync) {
      tcore::cp_wait<kRing - 2>();
      __syncthreads();
    } else {
      __syncthreads();
      put(i + 1);
    }
    issue(i + 2);
    return at(i++);
  }
  __device__ void finish() {
    if constexpr (kAsync) tcore::cp_wait<0>();
  }
};

// Whether the cp.async path can stage a block of T read at p with the
// given strides (elements) and unit-stride extent: fp32, 16-byte aligned.
template <typename T>
bool rows16(const void* p, long long s0, long long s1, long long s2,
            long long extent) {
  return std::is_same<T, float>::value &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0 && s2 % 4 == 0 && extent % 4 == 0;
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// CUDA-core FMAs (the fp32 route, and bf16 off the multiple of 8). One CTA
// of KS * BM * BM / 64 threads owns a BM x BM tile of C (BM = 128, or 64;
// see gemm_cc_staged) and runs the whole contraction in order, BK = KS * BM
// / 8 deep a chunk. The threads form KS groups of BM * BM / 64 (KS = 1, or
// 4 where even 64 x 64 tiles leave SMs short of two CTAs: more warps to
// hide the ring's latency and a quarter of the chunks); group q takes
// columns [q BM / 8, (q + 1) BM / 8) of each chunk, and at the end groups
// 1..KS-1 hand their sums to group 0 through shared memory, which adds
// them in order (a fixed order: the same bits on every run). In each group a thread owns 8 x 8 outputs: rows
// ty * 4 + (i % 4) + (i / 4) BM / 2, columns tx * 4 + (j % 4) + (j / 4) BM / 2
// or, where B's contraction axis is unit-stride (kBK), tx + (BM / 8) j. An
// operand whose contraction axis is unit-stride (kAK, kBK) is staged as it
// lies ([row][k], row stride BK + 4: consecutive rows on different banks)
// and read as float4 along k; the other is staged [k][row] (row stride BM +
// 4) and read as float4 along its rows. So no staging transposes, and with
// kVec every copy is a 16-byte cp.async.
template <int BM, int KS = 1>
__host__ __device__ constexpr int gemm_op_floats() {
  return (KS * BM / 8) * (BM + 4) > BM * (KS * BM / 8 + 4)
             ? (KS * BM / 8) * (BM + 4)
             : BM * (KS * BM / 8 + 4);
}
template <int BM, int KS = 1>
constexpr size_t gemm_smem() {
  // The ring, which the groups' hand-over of their sums reuses.
  return sizeof(float) * (kRing * 2 * gemm_op_floats<BM, KS>() >
                                  (KS - 1) * BM * BM
                              ? kRing * 2 * gemm_op_floats<BM, KS>()
                              : (KS - 1) * BM * BM);
}

template <typename T, bool kAK, bool kBK, bool kVec, int BM, int KS>
__global__ void __launch_bounds__(KS * BM * BM / 64)
    gemm_kernel(const Gemm g) {
  constexpr int kGT = BM * BM / 64, kNT = KS * kGT, kGK = BM / 8;
  constexpr int BK = KS * kGK, kHalf = BM / 2;
  constexpr int ldk = BK + 4, ldr = BM + 4;
  constexpr int kOp = gemm_op_floats<BM, KS>();
  extern __shared__ __align__(16) float smem[];
  const T* A = static_cast<const T*>(g.A) + blockIdx.z * g.sAz;
  const T* Bm = static_cast<const T*>(g.B) + blockIdx.z * g.sBz;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BM;
  const int grp = threadIdx.x / kGT, lt = threadIdx.x - grp * kGT;
  const int tx = lt % (BM / 8), ty = lt / (BM / 8);
  // With Ktot, blockIdx.z is a split of the contraction: rows [z K, z K + K).
  const int K =
      g.Ktot ? max(0, min(g.K, g.Ktot - (int)blockIdx.z * g.K)) : g.K;
  const int nk = (K + BK - 1) / BK;

  // Chunk c: head o = c / nk, contraction columns [k0, k0 + BK).
  auto plan = [&](int c, float* st, Block<T>& a, Block<T>& b) {
    const int o = c / nk, k0 = (c - o * nk) * BK;
    const T* Ao = A + o * g.sAo;
    const T* Bo = Bm + o * g.sBo;
    if (kAK)
      a = {Ao + m0 * g.sAm + k0, g.sAm, BM, BK, g.M - m0, K - k0, st, ldk};
    else
      a = {Ao + k0 * g.sAk + m0, g.sAk, BK, BM, K - k0, g.M - m0, st, ldr};
    if (kBK)
      b = {Bo + n0 * g.sBn + k0, g.sBn, BM, BK, g.N - n0, K - k0, st + kOp,
           ldk};
    else
      b = {Bo + k0 * g.sBk + n0, g.sBk, BK, BM, K - k0, g.N - n0, st + kOp,
           ldr};
  };
  Ring<T, kVec, kNT, 2 * BM * BK / kNT, decltype(plan)> ring(
      plan, smem, 2 * kOp, g.KO * nk);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < g.KO * nk; ++c) {
    const float* sA = ring.next();
    const float* sB = sA + kOp;
#pragma unroll
    for (int kq = 0; kq < kGK; kq += 4) {
      const int k = grp * kGK + kq;
      float a[8][4], b[4][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 4 + (i & 3) + (i >> 2) * kHalf;
        if (kAK) {
          const float4 x = *reinterpret_cast<const float4*>(sA + r * ldk + k);
          a[i][0] = x.x, a[i][1] = x.y, a[i][2] = x.z, a[i][3] = x.w;
        } else if ((i & 3) == 0) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 x =
                *reinterpret_cast<const float4*>(sA + (k + kk) * ldr + r);
            a[i][kk] = x.x, a[i + 1][kk] = x.y, a[i + 2][kk] = x.z,
            a[i + 3][kk] = x.w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kBK) {
          const int n = tx + (BM / 8) * j;
          const float4 x = *reinterpret_cast<const float4*>(sB + n * ldk + k);
          b[0][j] = x.x, b[1][j] = x.y, b[2][j] = x.z, b[3][j] = x.w;
        } else if ((j & 3) == 0) {
          const int n = tx * 4 + (j >> 2) * kHalf;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 x =
                *reinterpret_cast<const float4*>(sB + (k + kk) * ldr + n);
            b[kk][j] = x.x, b[kk][j + 1] = x.y, b[kk][j + 2] = x.z,
            b[kk][j + 3] = x.w;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
  }
  ring.finish();
  if constexpr (KS > 1) {
    // Groups 1..KS-1 hand their sums over (element e of thread lt at
    // [(q - 1) 64 + e][lt]); group 0 adds them in order.
    __syncthreads();  // every group is done with the ring
    if (grp > 0) {
      float* out = smem + (size_t)(grp - 1) * 64 * kGT + lt;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) out[(i * 8 + j) * kGT] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int q = 1; q < KS; ++q) {
      const float* in = smem + (size_t)(q - 1) * 64 * kGT + lt;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += in[(i * 8 + j) * kGT];
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 4 + (i & 3) + (i >> 2) * kHalf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (kBK ? tx + (BM / 8) * j
                              : tx * 4 + (j & 3) + (j >> 2) * kHalf);
      store_c<T>(g, m, n, acc[i][j]);
    }
  }
}

template <typename T, bool kAK, bool kBK, bool kVec, int BM, int KS>
cudaError_t launch_gemm_cc(const Gemm& g, int Z, cudaStream_t st,
                           Report& rep) {
  auto kern = gemm_kernel<T, kAK, kBK, kVec, BM, KS>;
  constexpr size_t smem = gemm_smem<BM, KS>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BM - 1) / BM, (g.M + BM - 1) / BM, Z);
  kern<<<grid, KS * BM * BM / 64, smem, st>>>(g);
  return rep.done(smem);
}

template <typename T, bool kAK, bool kBK>
cudaError_t gemm_cc_staged(const Gemm& g, int Z, bool vec, cudaStream_t st,
                           Report& rep) {
  // With cp.async staging (the fp32 route), the largest tile that still
  // gives every SM two CTAs: 128 x 128, else 64 x 64; where even 64 x 64
  // tiles do not (the rope route's products at S <= 256), 64 x 64 tiles
  // with four groups of threads splitting each chunk. On the register path
  // (bf16 off the multiple of 8, fp32 off the multiple of 4) 64 x 64 with
  // one group, which keeps the library's build short.
  if constexpr (std::is_same<T, float>::value) {
    auto tiles = [&](int bm) {
      return (long long)((g.N + bm - 1) / bm) * ((g.M + bm - 1) / bm) * Z;
    };
    if (vec && tiles(128) >= 2 * kSMs)
      return launch_gemm_cc<T, kAK, kBK, true, 128, 1>(g, Z, st, rep);
    if (vec && tiles(64) >= 2 * kSMs)
      return launch_gemm_cc<T, kAK, kBK, true, 64, 1>(g, Z, st, rep);
    if (vec) return launch_gemm_cc<T, kAK, kBK, true, 64, 4>(g, Z, st, rep);
  }
  return launch_gemm_cc<T, kAK, kBK, false, 64, 1>(g, Z, st, rep);
}

// The strided product on the CUDA cores (gemm_kernel), staged as each
// operand's strides ask: an operand with neither stride 1 is not taken.
template <typename T>
cudaError_t gemm_cuda_cores(const Gemm& g, int Z, cudaStream_t st,
                            Report& rep) {
  const bool ak = g.sAk == 1, bk = g.sBk == 1;
  if ((!ak && g.sAm != 1) || (!bk && g.sBn != 1))
    return cudaErrorInvalidValue;
  // The contraction's extents (K and, split, Ktot - z K) are multiples of 4
  // where K and Ktot are.
  const int kext = g.Ktot % 4 ? g.Ktot : g.K;
  const bool vec =
      rows16<T>(g.A, g.sAz, g.sAo, ak ? g.sAm : g.sAk, ak ? kext : g.M) &&
      rows16<T>(g.B, g.sBz, g.sBo, bk ? g.sBn : g.sBk, bk ? kext : g.N);
  if (ak && bk) return gemm_cc_staged<T, true, true>(g, Z, vec, st, rep);
  if (ak) return gemm_cc_staged<T, true, false>(g, Z, vec, st, rep);
  if (bk) return gemm_cc_staged<T, false, true>(g, Z, vec, st, rep);
  return gemm_cc_staged<T, false, false>(g, Z, vec, st, rep);
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

// Row reductions of the attention kernels' register tiles: the 16 threads
// that share a tile's rows are one half-warp (lane bits 0-3).
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

// ---------------------------------------------------------------------------
// No head dim is bounded on the CUDA-core kernels: every contraction over D
// or Dv streams through shared memory, and an output wider than one CTA's
// register tile is split over the grid (the attention and dq kernels past
// kOutSlice columns, the dk/dv kernel past kSlice columns of dk or dv;
// each CTA recomputing the scores for its slice).
constexpr int kSlice = 256;

inline int slices_of(int width) { return (width + kSlice - 1) / kSlice; }

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

// ---------------------------------------------------------------------------
// The CUDA-core attention kernels' tiles, on the product core above: 256
// threads as 16 x 16 (tx = threadIdx % 16, ty = threadIdx / 16); a thread
// owns rows ty * 4 + i (i < 4) of a CTA's 64 query rows, so the 16 threads
// that share rows are one half-warp and row reductions are shuffles over
// lane bits 0-3 (row_max16, row_sum16). A score tile is 64 queries x 128
// keys, a thread's 4 x 8 at keys tx + 16 j; an output tile is the 64 rows
// x up to kOutSlice columns, a thread's 4 x 4 NV at columns tx * 4 + 64 u +
// e. The scores of a key tile are formed once, whatever the output's width
// up to kOutSlice: they cross to the output's threads through a [64][kLdS]
// tile in shared memory. Past kOutSlice output columns the grid splits the
// output (each CTA recomputing the scores).
constexpr int kSQ = 64;                // query rows of a CTA
constexpr int kSK = 128;               // keys of a score tile
constexpr int kKC = 32;                // contraction columns of a score chunk
constexpr int kLdK = kKC + 4;          // its row stride: 5 bank groups apart
constexpr int kScoreChunk = (kSQ + kSK) * kLdK;   // floats of a score chunk
constexpr int kVK = 16;                // keys (rows) of an output chunk
constexpr int kLdS = kSK + 4;          // row stride of the score tile
constexpr int kOutSlice = 512;         // output columns of one CTA
constexpr int kMaxNV = kOutSlice / 64;

// Columns of an output tile NV (2-8) and its chunk's row stride.
__host__ __device__ constexpr int out_ld(int nv) { return 64 * nv + 4; }
// Floats of one ring stage: a score chunk or an output chunk.
__host__ __device__ constexpr int cc_stage(int nv) {
  return kScoreChunk > kVK * out_ld(nv) ? kScoreChunk : kVK * out_ld(nv);
}
// Dynamic shared memory of a CUDA-core attention CTA: the score tile and the
// ring (132,864 bytes at NV = 8, 116,736 at NV <= 6).
__host__ __device__ constexpr size_t cc_smem(int nv) {
  return sizeof(float) * ((size_t)kSQ * kLdS + (size_t)kRing * cc_stage(nv));
}
static_assert(cc_smem(kMaxNV) <= kMaxCtaSmem, "the CTA fits");
// NV of an output `width` columns wide (at most kOutSlice a CTA).
inline int nv_of(int width) {
  return ((width < kOutSlice ? width : kOutSlice) + 63) / 64;
}
inline int out_slices(int width) {
  return (width + kOutSlice - 1) / kOutSlice;
}

// f(std::integral_constant<int, NV>{}) for the NV that serves nv_of's nv:
// each of 1-8 with cp.async staging (the fp32 route; NV 1, up to 64
// columns, is the fp32 rope route's, whose D and Dv are at most 64: a
// wider NV would form dead columns), 2, 4 or 8 on the register path (bf16
// off the multiple of 8, fp32 rows off the multiple of 4), which keeps the
// libraries' build short.
template <bool kAsync, typename F>
cudaError_t with_nv(int nv, F&& f) {
  static_assert(kMaxNV == 8, "one case per NV");
  using std::integral_constant;
  if constexpr (kAsync) {
    switch (nv) {
      case 1: return f(integral_constant<int, 1>{});
      case 2: return f(integral_constant<int, 2>{});
      case 3: return f(integral_constant<int, 3>{});
      case 4: return f(integral_constant<int, 4>{});
      case 5: return f(integral_constant<int, 5>{});
      case 6: return f(integral_constant<int, 6>{});
      case 7: return f(integral_constant<int, 7>{});
      default: break;
    }
  } else {
    if (nv <= 2) return f(integral_constant<int, 2>{});
    if (nv <= 4) return f(integral_constant<int, 4>{});
  }
  return f(integral_constant<int, 8>{});
}

// One 4-deep step of score_chunk: s[i][j] += sum_{k0 <= k < k0 + 4} A[ty *
// 4 + i][k] * B[tx + 16 j][k], rows ld floats apart.
template <int ld>
__device__ __forceinline__ void score_step(float (&s)[4][8], const float* A,
                                           const float* B, int k0) {
  float4 a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = *reinterpret_cast<const float4*>(A + i * ld + k0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 b = *reinterpret_cast<const float4*>(B + 16 * j * ld + k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
      s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
      s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
      s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
    }
  }
}

// s[i][j] += sum_{k < KC} A[ty * 4 + i][k] * B[tx + 16 j][k] for the score
// chunk at st: A (64 rows) then B (128 rows), row-major, row stride KC + 4
// (kLdK for the default KC = kKC). kRolled keeps the steps in a loop, so
// that no step's fragments are loaded ahead: fewer registers live (the
// dk/dv kernel at two CTAs an SM).
template <int KC = kKC, bool kRolled = false>
__device__ __forceinline__ void score_chunk(float (&s)[4][8],
                                            const float* st) {
  constexpr int ld = KC + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* A = st + ty * 4 * ld;
  const float* B = st + (kSQ + tx) * ld;
  if constexpr (kRolled) {
#pragma unroll 1
    for (int k = 0; k < KC; k += 4) score_step<ld>(s, A, B, k);
  } else {
#pragma unroll
    for (int k = 0; k < KC; k += 4) score_step<ld>(s, A, B, k);
  }
}

// acc[i][4 u + e] += sum_{k < kVK} P[ty * 4 + i][k0 + k] X[k][tx * 4 + 64 u
// + e]: P the [64][kLdS] score tile, X an output chunk ([kVK][out_ld(NV)]).
template <int NV>
__device__ __forceinline__ void out_chunk(float (&acc)[4][4 * NV],
                                          const float* P, int k0,
                                          const float* X) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* Pr = P + ty * 4 * kLdS + k0;
  const float* Xc = X + tx * 4;
#pragma unroll
  for (int k = 0; k < kVK; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(Pr + i * kLdS + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(
            Xc + (k + e) * out_ld(NV) + 64 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = lane_of(p[i], e);
          acc[i][4 * u] = fmaf(pe, x.x, acc[i][4 * u]);
          acc[i][4 * u + 1] = fmaf(pe, x.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(pe, x.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(pe, x.w, acc[i][4 * u + 3]);
        }
      }
    }
  }
}

// Chunk `at` of a key tile's sequence in a CUDA-core attention kernel:
// which key tile, and which chunk of it. Every tile but the last has `per`
// chunks (its score chunks and kSK / kVK output chunks); the last has
// fewer output chunks where S ends inside it.
__device__ __forceinline__ void tile_of(int at, int per, int n_tiles,
                                        int& t, int& c) {
  t = min(at / per, n_tiles - 1);
  c = at - t * per;
}
__device__ __forceinline__ int out_chunks(int S, int t) {
  return (min(kSK, S - t * kSK) + kVK - 1) / kVK;
}

}  // namespace
