// Long-sequence fused attention with the learned additive mask, forward,
// written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernels
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_hires_fused, forward
//     pallas_call (:1069, body _fwd_res_kernel): o and the residuals m, lse;
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_fwd_only (:1221, body
//     _fwd_kernel -> _fwd_body): o alone (the serving and eval forward).
// One entry point, hires_attention_fwd, runs both; the template flag
// kResiduals of the attention kernels says whether they write lse (m is an
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
// hires shape is bound by operations, so every bf16 product runs on the
// tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate). The fp32
// route (the card-vs-CPU parity checks) keeps the CUDA-core kernels.
//
// Design. The S <= 256 kernel (axial_attention.cu) keeps all keys of a query
// tile in one CTA; at S = 1024, D = 256 one head's keys are 512 KB in bf16,
// so nothing here holds a whole key axis:
//   * the head-summed scores and the mask MLP are three launches of the
//     strided product (bf16: gemm_tc_kernel, hires_mma.cuh, 128 x 128 tiles
//     through three cp.async stages; fp32: gemm_kernel): ssum with the heads
//     as an outer contraction index, h1 = ssum W1^T over all B*S rows with
//     the GELU and b1 applied to the accumulators (the hidden axis never
//     needs chunking: an output tile sees the whole key axis through its
//     contraction), and m = a W2^T + b2;
//   * the bf16 attention kernel (hires_attention_bf16_kernel): one CTA of 4
//     warps per (64 query rows, head, batch element), grid (H, ceil(S/64),
//     B) with the heads fastest, so the H CTAs that read the same rows of m
//     run together and all but the first find them in L2. The CTA's q rows
//     stay in shared memory (bf16, [64][pad16(D) + 8]); per 64-key tile the
//     k chunks and then the v chunks stream through the chunk ring of
//     hires_mma.cuh ([64 keys][kChunkCols columns], four cp.async stages,
//     three copies in flight). One pass with an online softmax: the scores
//     of a key tile get scale and m, each row's running max and sum of exp
//     move, o is rescaled by exp(old max - new max), and p = exp(logit -
//     running max) is rounded to bf16 as the score accumulators are packed
//     into the A fragments of P V (no trip through shared memory); o is
//     divided by the row's sum at the end and lse = max + log(sum). The
//     Pallas body makes two passes and rounds p = exp(logit - lse); here p
//     is rounded before its normalisation, a bf16 rounding of the same
//     relative size, so the kernel holds the bf16 check (at most twice the
//     plain bf16 version's error against fp32) at every hires shape:
//     tests/test_torch_gpu.py and chip_smoke.py phase 8 check it at the
//     four stages of hires-cls-1024, S = 520, D = 120, and without the
//     mask (PERF.md §6 has the ratios). One pass does 2 tile products per
//     key tile, where two passes did 3. Exponentials run on the SFU
//     (__expf). m is read from device memory (L2) as float2 pairs of each
//     thread's scores;
//   * registers: a warp owns 16 rows and all of Dv, 16 x 256 fp32 at Dv =
//     256 (128 a thread), beside one 64-key score tile (32); the templates
//     NV = ceil(Dv / 64) size the accumulators (PERF.md §6 has ptxas's
//     count). Columns past pad16(D) or pad16(Dv) are skipped k-steps, not
//     zero products;
//   * the fp32 route's attention kernel (hires_attention_kernel): 64-key
//     tiles of k and v through fp32 shared memory, every product an fp32 FMA
//     on the CUDA cores.
// The bf16 route takes S, D and Dv that are multiples of 8 (16-byte rows);
// the wrapper raises for any other shape.

#include "hires_mma.cuh"

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


// Dynamic shared memory of the bf16 attention CTA: the resident q tile and
// the chunk ring (70,656 bytes at D = 256).
size_t attention_bf16_smem(int D) {
  return sizeof(bf16) * ((size_t)kAttnRows * (tcore::pad16(D) + 8) +
                         (size_t)kRingStages * kChunkElems);
}

template <int NV, bool kResiduals>
__global__ void __launch_bounds__(kAttnThreads) hires_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ m,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int S, int D,
    int Dv, float scale) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = pad16(D) + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sQ + kAttnRows * ldq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, q0 = blockIdx.y * kAttnRows;
  const size_t bh = (size_t)b * H + blockIdx.x;
  const bf16* kh = k + bh * S * D;
  const bf16* vh = v + bh * S * Dv;
  const int nkt = (S + kAttnRows - 1) / kAttnRows;
  const int nkc = chunks_of(D), nvc = chunks_of(Dv);
  int rows[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) rows[hf] = q0 + warp * 16 + g + 8 * hf;

  // Logits of key tile j in place: scale * s + m, -inf past S.
  auto logits = [&](float (&sc)[8][4], int j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = j * kAttnRows + n * 8 + 2 * t;  // key + 1 < S iff key < S
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2 mv = make_float2(0.f, 0.f);
        if (m && key < S && rows[hf] < S)
          mv = *reinterpret_cast<const float2*>(
              m + ((size_t)b * S + rows[hf]) * S + key);
        sc[n][2 * hf] = key < S ? sc[n][2 * hf] * scale + mv.x : -INFINITY;
        sc[n][2 * hf + 1] =
            key < S ? sc[n][2 * hf + 1] * scale + mv.y : -INFINITY;
      }
    }
  };
  // The ring: chunk i goes to stage i % kRingStages. Per key tile j, its
  // k chunks (the scores), then its v chunks (o += round(p) v, p from the
  // score registers). next() waits for chunk i, starts chunk i + 3 and
  // returns chunk i's stage.
  const int per = nkc + nvc, n_chunks = nkt * per;
  auto prefetch = [&](int at) {
    if (at < n_chunks) {
      const int j = at / per, c = at - j * per;
      bf16* dst = ring + (at % kRingStages) * kChunkElems;
      if (c < nkc)
        copy_chunk(dst, kh + (size_t)j * kAttnRows * D, D,
                   S - j * kAttnRows, c);
      else
        copy_chunk(dst, vh + (size_t)j * kAttnRows * Dv, Dv,
                   S - j * kAttnRows, c - nkc);
    }
    cp_commit();
  };
  copy_resident(sQ, q + (bh * S + q0) * D, D, S - q0);  // joins chunk 0
#pragma unroll
  for (int at = 0; at < kRingStages - 1; ++at) prefetch(at);
  int i = 0;
  auto next = [&]() -> const bf16* {
    cp_wait<kRingStages - 2>();
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is free
    prefetch(i + kRingStages - 1);
    return ring + (i++ % kRingStages) * kChunkElems;
  };

  // Online softmax per row (rows g and g + 8 of the warp): the running max
  // mx, this thread's share of the running sum of exp, and o, rescaled by
  // exp(old max - new max) whenever a key tile moves the max.
  float mx[2] = {-INFINITY, -INFINITY}, se[2] = {0.f, 0.f};
  float acc[NV * kChunkN][4];
#pragma unroll
  for (int n = 0; n < NV * kChunkN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[8][4];
  for (int j = 0; j < nkt; ++j) {
    zero8(s);
    for (int c = 0; c < nkc; ++c)
      rows_by_chunk(s, sQ, ldq, c, next(), chunk_steps(D, c), lane, warp);
    logits(s, j);
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float tmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        tmax = fmaxf(tmax, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
      const float nmx = fmaxf(mx[hf], quad_max(tmax));
      alpha[hf] = __expf(mx[hf] - nmx);   // 0 at the first tile
      mx[hf] = nmx;
      se[hf] *= alpha[hf];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mx[e >> 1]);
        se[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NV * kChunkN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) c_to_a(pa[kb], s[2 * kb], s[2 * kb + 1]);
#pragma unroll
    for (int u = 0; u < NV; ++u)
      if (u < nvc) probs_by_chunk(acc, u, pa, next(), chunk_steps(Dv, u), lane);
  }
  cp_wait<0>();
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float sum = quad_sum(se[hf]);
    inv[hf] = 1.f / sum;
    if (kResiduals && t == 0 && rows[hf] < S)
      lse[bh * S + rows[hf]] = mx[hf] + logf(sum);
  }

  bf16* oh = o + bh * S * Dv;
#pragma unroll
  for (int n = 0; n < NV * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < Dv) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < S)
          *reinterpret_cast<uint32_t*>(oh + (size_t)rows[hf] * Dv + d) =
              pack(acc[n][2 * hf] * inv[hf], acc[n][2 * hf + 1] * inv[hf]);
    }
  }
}

template <int NV, bool kResiduals>
cudaError_t launch_attention_bf16(const bf16* q, const bf16* k,
                                  const bf16* v, const float* m, bf16* o,
                                  float* lse, int B, int H, int S, int D,
                                  int Dv, float scale, cudaStream_t st,
                                  Report& rep) {
  auto kern = hires_attention_bf16_kernel<NV, kResiduals>;
  const size_t smem = attention_bf16_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kAttnRows - 1) / kAttnRows, B);
  kern<<<grid, kAttnThreads, smem, st>>>(q, k, v, m, o, lse, H, S, D, Dv,
                                         scale);
  return rep.done(smem);
}

template <bool kResiduals>
cudaError_t attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                           const float* m, bf16* o, float* lse, int B, int H,
                           int S, int D, int Dv, float scale,
                           cudaStream_t st, Report& rep) {
  static_assert(kMaxChunks == 4, "one case per chunk count");
  switch (chunks_of(Dv)) {
    case 1:
      return launch_attention_bf16<1, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
    case 2:
      return launch_attention_bf16<2, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
    case 3:
      return launch_attention_bf16<3, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
    default:
      return launch_attention_bf16<4, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
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
                             cudaStream_t st, Report& rep) {
  auto kern = hires_attention_kernel<T, CJ, kResiduals>;
  const size_t smem = attention_smem(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, smem, st>>>(q, k, v, m, o, lse, H, S, D, Dv, scale);
  return rep.done(smem);
}

template <typename T, bool kResiduals>
cudaError_t attention(const T* q, const T* k, const T* v, const float* m,
                      T* o, float* lse, int B, int H, int S, int D, int Dv,
                      float scale, cudaStream_t st, Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    return attention_bf16<kResiduals>(q, k, v, m, o, lse, B, H, S, D, Dv,
                                      scale, st, rep);
  } else {
    switch (cols_per_thread(Dv)) {
      case 4:
        return launch_attention<T, 4, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
      case 8:
        return launch_attention<T, 8, kResiduals>(q, k, v, m, o, lse, B, H,
                                                  S, D, Dv, scale, st, rep);
      default:
        return launch_attention<T, 16, kResiduals>(q, k, v, m, o, lse, B, H,
                                                   S, D, Dv, scale, st, rep);
    }
  }
}

template <typename T>
cudaError_t run(int residuals, int use_mask, const void* q, const void* k,
                const void* v, const void* w1t, const float* b1,
                const void* w2t, const float* b2, void* ssum, void* a,
                float* m, void* o, float* lse, int B, int H, int S, int D,
                int Dv, float scale, cudaStream_t st, Report& rep) {
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
    if ((err = gemm<T>(g, B, st, rep)) != cudaSuccess) return err;
    // a = round(gelu(ssum W1^T + b1)) over all B*S rows.
    g = Gemm{};
    g.A = ssum; g.B = w1t; g.C = a; g.bias = b1; g.epilogue = kGelu;
    g.M = (int)R; g.N = (int)S2; g.K = S; g.KO = 1;
    g.sAm = S; g.sAk = 1; g.sBk = S2; g.sBn = 1; g.ldc = S2;
    if ((err = gemm<T>(g, 1, st, rep)) != cudaSuccess) return err;
    // m = a W2^T + b2, fp32.
    g = Gemm{};
    g.A = a; g.B = w2t; g.C = m; g.bias = b2; g.epilogue = kStoreF32;
    g.M = (int)R; g.N = S; g.K = (int)S2; g.KO = 1;
    g.sAm = S2; g.sAk = 1; g.sBk = S; g.sBn = 1; g.ldc = S;
    if ((err = gemm<T>(g, 1, st, rep)) != cudaSuccess) return err;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* mm = use_mask ? m : nullptr;
  if (residuals)
    return attention<T, true>(qt, kt, vt, mm, static_cast<T*>(o), lse, B, H,
                              S, D, Dv, scale, st, rep);
  return attention<T, false>(qt, kt, vt, mm, static_cast<T*>(o), nullptr, B,
                             H, S, D, Dv, scale, st, rep);
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v and o (B,H,S,Dv)
// in the compute type; w1t (S,2S) and w2t (2S,S) in the compute type, b1
// (2S) and b2 (S) fp32; scratch ssum (B,S,S) and a (B,S,2S) in the compute
// type; m (B,S,S) fp32 (an output when residuals is 1); lse (B,H,S) fp32,
// written when residuals is 1. With use_mask 0 the weights, ssum, a and m
// may be null (and residuals must be 0). All contiguous. bf16 takes S, D
// and Dv that are multiples of 8. Sets *launched to the number of kernels
// the call launched and *smem to the largest dynamic shared memory (bytes)
// one of their CTAs asked for.
extern "C" int hires_attention_fwd(
    int is_bf16, int residuals, int use_mask, const void* q, const void* k,
    const void* v, const void* w1t, const float* b1, const void* w2t,
    const float* b2, void* ssum, void* a, float* m, void* o, float* lse,
    int B, int H, int S, int D, int Dv, float scale, void* stream,
    int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > 256 || Dv < 1 || Dv > 256 ||
      (is_bf16 && (S % 8 || D % 8 || Dv % 8)) ||
      (residuals && (!use_mask || !lse)) ||
      (use_mask && (!w1t || !b1 || !w2t || !b2 || !ssum || !a || !m)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run<bf16>(residuals, use_mask, q, k, v, w1t, b1, w2t, b2,
                          ssum, a, m, o, lse, B, H, S, D, Dv, scale, st, rep)
              : run<float>(residuals, use_mask, q, k, v, w1t, b1, w2t, b2,
                           ssum, a, m, o, lse, B, H, S, D, Dv, scale, st,
                           rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}
