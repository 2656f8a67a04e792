// Long-sequence fused attention with the learned additive mask, forward,
// written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernels
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_hires_fused, forward
//     pallas_call (:1069, body _fwd_res_kernel): o and the residuals m, lse;
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_fwd_only (:1221, body
//     _fwd_kernel -> _fwd_body): o alone (the serving and eval forward).
// One entry point, hires_attention_fwd, runs both; the template flag
// kResiduals of the attention kernel says whether it writes lse (m is an
// output with residuals and scratch without).
//
// Computes, on rotated q, k (B,H,S,D) and v (B,H,S,Dv) in the compute type:
//   ssum[b]  = sum_h q_h k_h^T                        (B,S,S), rounded
//   a        = round(gelu(ssum W1^T + b1))            (B,S,2S)
//   m        = a W2^T + b2                             (B,S,S) fp32
//   lse[b,h] = logsumexp(scale * q_h k_h^T + m)        (B,H,S) fp32
//   o_h      = round(exp(scale * q_h k_h^T + m - lse)) v_h, stored rounded
// with the bf16 rounding points of _mask_fwd and _fwd_res_kernel; every
// product accumulates in fp32. Without the mask (kernel 4, use_mask 0) the
// first three steps are skipped and m is 0.
//
// What bounds it on the H100: at S=1024, D=Dv=256, B=8, H=12 in bf16 the
// work is 2*B*H*S^2*(D+Dv) + 4*B*S^2*2S = 171.8 GFLOP (0.174 ms at 989
// TFLOP/s) against 0.24 GB of q, k, v, o, m (0.073 ms at 3.35 TB/s): every
// hires shape is bound by operations. In this first version only the
// strided product's bf16 path (ssum and the mask MLP) runs on the tensor
// cores; the attention kernel does its products as fp32 FMAs on the CUDA
// cores (67 TFLOP/s at most), so it cannot come near that bound (PERF.md).
//
// Design. The S <= 256 kernel (axial_attention.cu) keeps all keys of a query
// tile in one CTA; at S = 1024, D = 256 one head's keys are 512 KB in bf16,
// so nothing here holds a whole key axis:
//   * the head-summed scores and the mask MLP are three launches of the
//     strided product of hires_common.cuh: ssum with the heads as an outer
//     contraction index, h1 = ssum W1^T over all B*S rows with the GELU and
//     b1 fused into its epilogue (the hidden axis never needs chunking: a
//     64 x 64 output tile sees the whole key axis through its contraction),
//     and m = a W2^T + b2;
//   * the attention kernel: one CTA per (64 query rows, batch element and
//     head) streams 64-key tiles of k and v through shared memory twice:
//     pass 1 keeps each row's running max and sum of exp (exact per row), so
//     lse is known before any p is formed; pass 2 recomputes the scores, forms
//     p = exp(logit - lse), rounds it like the Pallas body and accumulates
//     p v in registers. No score tile reaches device memory.

#include "hires_common.cuh"

namespace {

template <typename T, int CJ, bool kResiduals>
__global__ void __launch_bounds__(kThreads) hires_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ m, T* __restrict__ o, float* __restrict__ lse,
    int H, int S, int D, int Dv, float scale) {
  extern __shared__ float smem[];
  const int ldq = D | 1;
  const int ldkv = (D > Dv ? D : Dv) | 1;
  float* sQ = smem;                  // 64 x ldq    q tile
  float* sKV = sQ + kTile * ldq;     // 64 x ldkv   k tile, then v tile
  float* sP = sKV + kTile * ldkv;    // 64 x kLdP   p, rounded

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head = (size_t)bh * S;
  load_tile<T>(sQ, ldq, q + head * D, q0, S, D);

  // m[b, q, t] for this thread's rows (0 where there is no mask).
  auto mask = [&](int i, int t) -> float {
    const int r = q0 + ty + 16 * i;
    return m && r < S ? m[((size_t)b * S + r) * S + t] : 0.f;
  };

  // Pass 1: row max and sum of exp over all keys.
  float mx[4], se[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = -INFINITY, se[i] = 0.f;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();
    load_tile<T>(sKV, ldkv, k + head * D, t0, S, D);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm_nt<4>(s, sQ, ldq, sKV, ldkv, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        s[i][j] = t < S ? s[i][j] * scale + mask(i, t) : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float nmx = fmaxf(mx[i], row_max16(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - nmx);
      se[i] = se[i] * expf(mx[i] - nmx) + row_sum16(tsum);
      mx[i] = nmx;
    }
  }
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = mx[i] + logf(se[i]);
    const int r = q0 + ty + 16 * i;
    if (kResiduals && tx == 0 && r < S) lse[head + r] = l[i];
  }

  // Pass 2: p = exp(logit - lse), rounded, times v.
  float acc[4][CJ];
  zero(acc);
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();  // the previous tile is done with sKV and sP
    load_tile<T>(sKV, ldkv, k + head * D, t0, S, D);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm_nt<4>(s, sQ, ldq, sKV, ldkv, D);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        const float p =
            t < S ? expf(s[i][j] * scale + mask(i, t) - l[i]) : 0.f;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = rnd<T>(p);
      }
    __syncthreads();  // every warp is done with k
    load_tile<T>(sKV, ldkv, v + head * Dv, t0, S, Dv);
    __syncthreads();
    mm_nn<CJ>(acc, sP, kLdP, sKV, ldkv, Dv);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv) o[(head + r) * Dv + c] = from_f<T>(acc[i][j]);
    }
  }
}

size_t attention_smem(int D, int Dv) {
  const int ldkv = (D > Dv ? D : Dv) | 1;
  return sizeof(float) *
         ((size_t)kTile * (D | 1) + (size_t)kTile * ldkv + kTile * kLdP);
}

template <typename T, int CJ, bool kResiduals>
cudaError_t launch_attention(const T* q, const T* k, const T* v,
                             const float* m, T* o, float* lse, int B, int H,
                             int S, int D, int Dv, float scale,
                             cudaStream_t st) {
  auto kern = hires_attention_kernel<T, CJ, kResiduals>;
  const size_t smem = attention_smem(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, smem, st>>>(q, k, v, m, o, lse, H, S, D, Dv, scale);
  return cudaGetLastError();
}

template <typename T, bool kResiduals>
cudaError_t attention(int cj, const T* q, const T* k, const T* v,
                      const float* m, T* o, float* lse, int B, int H, int S,
                      int D, int Dv, float scale, cudaStream_t st) {
  switch (cj) {
    case 4:
      return launch_attention<T, 4, kResiduals>(q, k, v, m, o, lse, B, H, S,
                                                D, Dv, scale, st);
    case 8:
      return launch_attention<T, 8, kResiduals>(q, k, v, m, o, lse, B, H, S,
                                                D, Dv, scale, st);
    default:
      return launch_attention<T, 16, kResiduals>(q, k, v, m, o, lse, B, H,
                                                 S, D, Dv, scale, st);
  }
}

template <typename T>
cudaError_t run(int residuals, int use_mask, const void* q, const void* k,
                const void* v, const void* w1t, const float* b1,
                const void* w2t, const float* b2, void* ssum, void* a,
                float* m, void* o, float* lse, int B, int H, int S, int D,
                int Dv, float scale, cudaStream_t st) {
  cudaError_t err;
  if (use_mask) {
    const long long S2 = 2LL * S, R = (long long)B * S;
    Gemm g = {};
    // ssum[b] = sum_h q_h k_h^T, rounded to T.
    g.A = q; g.B = k; g.C = ssum; g.epilogue = kStoreT;
    g.M = S; g.N = S; g.K = D; g.KO = H;
    g.sAz = (long long)H * S * D; g.sAo = (long long)S * D; g.sAm = D;
    g.sAk = 1;
    g.sBz = g.sAz; g.sBo = g.sAo; g.sBk = 1; g.sBn = D;
    g.sCz = (long long)S * S; g.ldc = S;
    if ((err = gemm<T>(g, B, st)) != cudaSuccess) return err;
    // a = round(gelu(ssum W1^T + b1)) over all B*S rows.
    g = Gemm{};
    g.A = ssum; g.B = w1t; g.C = a; g.bias = b1; g.epilogue = kGelu;
    g.M = (int)R; g.N = (int)S2; g.K = S; g.KO = 1;
    g.sAm = S; g.sAk = 1; g.sBk = S2; g.sBn = 1; g.ldc = S2;
    if ((err = gemm<T>(g, 1, st)) != cudaSuccess) return err;
    // m = a W2^T + b2, fp32.
    g = Gemm{};
    g.A = a; g.B = w2t; g.C = m; g.bias = b2; g.epilogue = kStoreF32;
    g.M = (int)R; g.N = S; g.K = (int)S2; g.KO = 1;
    g.sAm = S2; g.sAk = 1; g.sBk = S; g.sBn = 1; g.ldc = S;
    if ((err = gemm<T>(g, 1, st)) != cudaSuccess) return err;
  }
  const int cj = cols_per_thread(Dv);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* mm = use_mask ? m : nullptr;
  if (residuals)
    return attention<T, true>(cj, qt, kt, vt, mm, static_cast<T*>(o), lse, B,
                              H, S, D, Dv, scale, st);
  return attention<T, false>(cj, qt, kt, vt, mm, static_cast<T*>(o), nullptr,
                             B, H, S, D, Dv, scale, st);
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v and o (B,H,S,Dv)
// in the compute type; w1t (S,2S) and w2t (2S,S) in the compute type, b1
// (2S) and b2 (S) fp32; scratch ssum (B,S,S) and a (B,S,2S) in the compute
// type; m (B,S,S) fp32 (an output when residuals is 1); lse (B,H,S) fp32,
// written when residuals is 1. With use_mask 0 the weights, ssum, a and m
// may be null (and residuals must be 0). All contiguous.
extern "C" int hires_attention_fwd(
    int is_bf16, int residuals, int use_mask, const void* q, const void* k,
    const void* v, const void* w1t, const float* b1, const void* w2t,
    const float* b2, void* ssum, void* a, float* m, void* o, float* lse,
    int B, int H, int S, int D, int Dv, float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > 256 || Dv < 1 || Dv > 256 ||
      (residuals && (!use_mask || !lse)) ||
      (use_mask && (!w1t || !b1 || !w2t || !b2 || !ssum || !a || !m)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(residuals, use_mask, q, k, v, w1t, b1, w2t,
                                   b2, ssum, a, m, o, lse, B, H, S, D, Dv,
                                   scale, st);
  return (int)run<float>(residuals, use_mask, q, k, v, w1t, b1, w2t, b2, ssum,
                         a, m, o, lse, B, H, S, D, Dv, scale, st);
}
