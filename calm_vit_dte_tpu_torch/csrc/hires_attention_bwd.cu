// Backward of the long-sequence fused attention (learned additive mask),
// written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernels built by
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_hires_fused:
//     the query-tiled pass (dq pallas_call :1087, body _hires_dq_kernel):
//       hires_attention_dq + hires_weight_grads here;
//     the key-tiled pass (dkv pallas_call :1125, body _hires_dkv_kernel):
//       hires_attention_dkv here.
//
// With g = dL/do (B,H,S,Dv) in the compute type, the forward's residuals m
// (B,Sq,Sk) and lse (B,H,S), and delta = rowsum(g * o) (B,H,S), all fp32:
//   p_h  = exp(scale * q_h k_h^T + m - lse_h)        recomputed per tile
//   dl_h = p_h * (g_h v_h^T - delta_h)
//   dm   = round(sum_h dl_h);  ssum = round(sum_h q_h k_h^T)
//   h1   = ssum W1^T + b1;  a = round(gelu(h1))
//   dh1  = round((dm W2) * gelu'(h1));  dssum = dh1 W1      (fp32 residual)
//   dW2  = dm^T a;  db2 = colsum(dm);  dW1 = dh1^T ssum;  db1 = colsum(dh1)
//   ds_h = round(scale * dl_h + dssum)
//   dq_h = ds_h k_h;  dk_h = ds_h^T q_h;  dv_h = round(p_h)^T g_h
// rounded like _hires_dq_kernel and _hires_dkv_kernel: the weights, ssum,
// a, dm, dh1, p and ds are in the compute type before their products, every
// product accumulates in fp32, dq, dk, dv are stored in the compute type and
// dssum and the weight grads in fp32.
//
// What bounds it on the H100: about three times the forward's operations
// (514 GFLOP at S=1024, D=256, B=8 in bf16, 0.52 ms at 989 TFLOP/s) against
// under 0.5 GB of traffic: bound by operations. As in the forward, the
// strided product's bf16 path (the mask MLP backward and the weight grads)
// runs on the tensor cores, and the attention kernels' products are fp32
// FMAs on the CUDA cores.
//
// Design (no atomics anywhere, so results are the same from run to run):
//   * The heads couple through dm and ssum, which the mask MLP's backward
//     needs whole before dq can be formed. hires_dm_ssum_kernel owns one
//     64 x 64 (query, key) tile of one batch element and loops over the
//     heads, summing dl_h and q_h k_h^T in registers; dm and ssum go to
//     device memory in the compute type (the TPU grid's per-tile values).
//   * The mask MLP's products run over all B*S rows with the strided product
//     of hires_common.cuh: h1 (GELU and gelu' in the epilogue), da = dm W2
//     (times gelu', rounded, in the epilogue), dssum = dh1 W1.
//   * The weight grads are sums over all B*S query rows. The TPU grid carried
//     them from step to step; here hires_weight_grads forms dW1 = dh1^T ssum
//     and dW2 = dm^T a with the same strided product, one CTA per 64 x 64
//     output tile running its whole contraction over the rows in order, and
//     the bias grads as two-stage ordered column sums.
//   * dq: one CTA per (64 query rows, batch element and head) streams the
//     key tiles (v, then k, through one buffer): dp, p, dl, ds in registers,
//     ds through shared memory into dq += ds k. dssum and m are read in
//     (query, key) order, coalesced.
//   * dk, dv: one CTA per (64 keys, batch element and head) streams the query
//     tiles: scores and dp transposed (key rows), dv += round(p)^T g and
//     dk += ds^T q from shared memory. m and dssum are read transposed by
//     their indexing, so no transposed copy is made.

#include "hires_common.cuh"

namespace {

struct Residuals {
  const float *m, *lse, *delta;
  int H, S;
  float scale;
};

// p and dl of one score-tile element: s = q . k, dp = g . v.
__device__ __forceinline__ void softmax_grad(float s, float dp, float m,
                                             float lse, float delta,
                                             float scale, float& p,
                                             float& dl) {
  p = expf(s * scale + m - lse);
  dl = p * (dp - delta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hires_dm_ssum_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R, int D, int Dv,
    T* __restrict__ dm, T* __restrict__ ssum) {
  extern __shared__ float smem[];
  const int H = R.H, S = R.S;
  const int ld = (D > Dv ? D : Dv) | 1;
  float* sA = smem;               // 64 x ld   q_h rows, then g_h rows
  float* sB = sA + kTile * ld;    // 64 x ld   k_h rows, then v_h rows
  const int t0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc_dm[4][4], acc_ss[4][4];
  zero(acc_dm);
  zero(acc_ss);
  float mv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + ty + 16 * i, t = t0 + tx + 16 * j;
      mv[i][j] = r < S && t < S ? R.m[((size_t)b * S + r) * S + t] : 0.f;
    }
  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)b * H + h) * S;
    __syncthreads();
    load_tile<T>(sA, ld, q + head * D, q0, S, D);
    load_tile<T>(sB, ld, k + head * D, t0, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm_nt<4>(s, sA, ld, sB, ld, D);
    __syncthreads();
    load_tile<T>(sA, ld, g + head * Dv, q0, S, Dv);
    load_tile<T>(sB, ld, v + head * Dv, t0, S, Dv);
    __syncthreads();
    mm_nt<4>(dp, sA, ld, sB, ld, Dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float l = r < S ? R.lse[head + r] : 0.f;
      const float de = r < S ? R.delta[head + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, dl;
        softmax_grad(s[i][j], dp[i][j], mv[i][j], l, de, R.scale, p, dl);
        acc_dm[i][j] += dl;
        acc_ss[i][j] += s[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t >= S) continue;
      const size_t at = ((size_t)b * S + r) * S + t;
      dm[at] = from_f<T>(acc_dm[i][j]);
      ssum[at] = from_f<T>(acc_ss[i][j]);
    }
  }
}

template <typename T, int CJ>
__global__ void __launch_bounds__(kThreads) hires_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, T* __restrict__ dq) {
  extern __shared__ float smem[];
  const int H = R.H, S = R.S;
  const int ldq = D | 1, ldg = Dv | 1;
  const int ldx = (D > Dv ? D : Dv) | 1;
  float* sQ = smem;                // 64 x ldq   q rows
  float* sG = sQ + kTile * ldq;    // 64 x ldg   g rows
  float* sX = sG + kTile * ldg;    // 64 x ldx   v tile, then k tile
  float* sS = sX + kTile * ldx;    // 64 x kLdP  ds, rounded
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head = (size_t)bh * S;
  load_tile<T>(sQ, ldq, q + head * D, q0, S, D);
  load_tile<T>(sG, ldg, g + head * Dv, q0, S, Dv);
  float l[4], de[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    l[i] = r < S ? R.lse[head + r] : 0.f;
    de[i] = r < S ? R.delta[head + r] : 0.f;
  }
  float acc[4][CJ];
  zero(acc);
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();  // the previous tile is done with sX and sS
    load_tile<T>(sX, ldx, v + head * Dv, t0, S, Dv);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm_nt<4>(dp, sG, ldg, sX, ldx, Dv);
    __syncthreads();
    load_tile<T>(sX, ldx, k + head * D, t0, S, D);
    __syncthreads();
    mm_nt<4>(s, sQ, ldq, sX, ldx, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        float ds = 0.f;
        if (r < S && t < S) {
          const size_t at = ((size_t)b * S + r) * S + t;
          float p, dl;
          softmax_grad(s[i][j], dp[i][j], R.m[at], l[i], de[i], R.scale, p,
                       dl);
          ds = rnd<T>(dl * R.scale + dssum[at]);
        }
        sS[(ty + 16 * i) * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mm_nn<CJ>(acc, sS, kLdP, sX, ldx, D);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dq[(head + r) * D + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int CJ>
__global__ void __launch_bounds__(kThreads) hires_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, T* __restrict__ dk,
    T* __restrict__ dv) {
  extern __shared__ float smem[];
  const int H = R.H, S = R.S;
  const int ldk = D | 1, ldv = Dv | 1;
  const int ldx = (D > Dv ? D : Dv) | 1;
  float* sK = smem;                // 64 x ldk   k rows (this CTA's keys)
  float* sV = sK + kTile * ldk;    // 64 x ldv   v rows
  float* sX = sV + kTile * ldv;    // 64 x ldx   q tile, g tile, q tile
  float* sP = sX + kTile * ldx;    // 64 x kLdP  round(p)^T
  float* sD = sP + kTile * kLdP;   // 64 x kLdP  ds^T
  const int t0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head = (size_t)bh * S;
  load_tile<T>(sK, ldk, k + head * D, t0, S, D);
  load_tile<T>(sV, ldv, v + head * Dv, t0, S, Dv);
  float acc_k[4][CJ], acc_v[4][CJ];
  zero(acc_k);
  zero(acc_v);
  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous tile is done with sX and sP
    load_tile<T>(sX, ldx, q + head * D, q0, S, D);
    __syncthreads();
    // Key rows (ty + 16i) by query columns (tx + 16j).
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm_nt<4>(s, sK, ldk, sX, ldx, D);
    __syncthreads();
    load_tile<T>(sX, ldx, g + head * Dv, q0, S, Dv);
    __syncthreads();
    mm_nt<4>(dp, sV, ldv, sX, ldx, Dv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = q0 + tx + 16 * j;
      const float l = c < S ? R.lse[head + c] : 0.f;
      const float de = c < S ? R.delta[head + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        float p = 0.f, ds = 0.f;
        if (c < S && t < S) {
          const size_t at = ((size_t)b * S + c) * S + t;
          float dl;
          softmax_grad(s[i][j], dp[i][j], R.m[at], l, de, R.scale, p, dl);
          ds = rnd<T>(dl * R.scale + dssum[at]);
        }
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = rnd<T>(p);
        sD[(ty + 16 * i) * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mm_nn<CJ>(acc_v, sP, kLdP, sX, ldx, Dv);   // dv += round(p)^T g
    __syncthreads();  // every warp is done with g
    load_tile<T>(sX, ldx, q + head * D, q0, S, D);
    __syncthreads();
    mm_nn<CJ>(acc_k, sD, kLdP, sX, ldx, D);    // dk += ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dk[(head + t) * D + c] = from_f<T>(acc_k[i][j]);
      if (c < Dv) dv[(head + t) * Dv + c] = from_f<T>(acc_v[i][j]);
    }
  }
}

size_t dm_ssum_smem(int D, int Dv) {
  return sizeof(float) * 2 * kTile * (size_t)((D > Dv ? D : Dv) | 1);
}

// The dq kernel (n_score_tiles 1) and the dk/dv kernel (2): three row
// tiles and the score tiles; 230,656 bytes at D = Dv = 256 for dk/dv.
size_t tiled_smem(int D, int Dv, int n_score_tiles) {
  return sizeof(float) * kTile *
         ((size_t)(D | 1) + (Dv | 1) + ((D > Dv ? D : Dv) | 1) +
          (size_t)n_score_tiles * kLdP);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int CJ>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* g,
                      const Residuals& R, const float* dssum, int B, int D,
                      int Dv, T* dq, cudaStream_t st) {
  auto kern = hires_dq_kernel<T, CJ>;
  const size_t smem = tiled_smem(D, Dv, 1);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((R.S + kTile - 1) / kTile, B * R.H), kThreads, smem, st>>>(
      q, k, v, g, R, dssum, D, Dv, dq);
  return cudaGetLastError();
}

template <typename T, int CJ>
cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* g,
                       const Residuals& R, const float* dssum, int B, int D,
                       int Dv, T* dk, T* dv, cudaStream_t st) {
  auto kern = hires_dkv_kernel<T, CJ>;
  const size_t smem = tiled_smem(D, Dv, 2);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((R.S + kTile - 1) / kTile, B * R.H), kThreads, smem, st>>>(
      q, k, v, g, R, dssum, D, Dv, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* g, const Residuals& R, const void* w1t,
                   const float* b1, const void* w1, const void* w2, void* dq,
                   float* dssum, void* ssum, void* dm, void* a, float* gp,
                   void* dh1, int B, int D, int Dv, cudaStream_t st) {
  const int S = R.S;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  const size_t smem0 = dm_ssum_smem(D, Dv);
  cudaError_t err = allow_smem(hires_dm_ssum_kernel<T>, smem0);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)((S + kTile - 1) / kTile);
  hires_dm_ssum_kernel<T><<<dim3(tiles, tiles, B), kThreads, smem0, st>>>(
      qt, kt, vt, gt, R, D, Dv, static_cast<T*>(dm), static_cast<T*>(ssum));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long S2 = 2LL * S, rows = (long long)B * S;
  Gemm gm = {};
  // a = round(gelu(h1)), gp = gelu'(h1), h1 = ssum W1^T + b1.
  gm.A = ssum; gm.B = w1t; gm.C = a; gm.C2 = gp; gm.bias = b1;
  gm.epilogue = kGelu; gm.M = (int)rows; gm.N = (int)S2; gm.K = S; gm.KO = 1;
  gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, st)) != cudaSuccess) return err;
  // dh1 = round((dm W2) * gp); W2 is (S, 2S) row-major.
  gm = Gemm{};
  gm.A = dm; gm.B = w2; gm.C = dh1; gm.C2 = gp; gm.epilogue = kDgeluMul;
  gm.M = (int)rows; gm.N = (int)S2; gm.K = S; gm.KO = 1;
  gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, st)) != cudaSuccess) return err;
  // dssum = dh1 W1, fp32; W1 is (2S, S) row-major.
  gm = Gemm{};
  gm.A = dh1; gm.B = w1; gm.C = dssum; gm.epilogue = kStoreF32;
  gm.M = (int)rows; gm.N = S; gm.K = (int)S2; gm.KO = 1;
  gm.sAm = S2; gm.sAk = 1; gm.sBk = S; gm.sBn = 1; gm.ldc = S;
  if ((err = gemm<T>(gm, 1, st)) != cudaSuccess) return err;

  T* dqt = static_cast<T*>(dq);
  switch (cols_per_thread(D)) {
    case 4: return launch_dq<T, 4>(qt, kt, vt, gt, R, dssum, B, D, Dv, dqt, st);
    case 8: return launch_dq<T, 8>(qt, kt, vt, gt, R, dssum, B, D, Dv, dqt, st);
    default:
      return launch_dq<T, 16>(qt, kt, vt, gt, R, dssum, B, D, Dv, dqt, st);
  }
}

template <typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* g, const Residuals& R, const float* dssum,
                    void* dk, void* dv, int B, int D, int Dv,
                    cudaStream_t st) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  switch (cols_per_thread(D > Dv ? D : Dv)) {
    case 4:
      return launch_dkv<T, 4>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                              st);
    case 8:
      return launch_dkv<T, 8>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                              st);
    default:
      return launch_dkv<T, 16>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                               st);
  }
}

template <typename T>
cudaError_t run_weight_grads(const void* ssum, const void* dm, const void* a,
                             const void* dh1, float* dw1, float* db1,
                             float* dw2, float* db2, float* part,
                             long long rows, int S, cudaStream_t st) {
  const long long S2 = 2LL * S;
  Gemm gm = {};
  // dW1 (2S, S) = dh1^T ssum over the rows.
  gm.A = dh1; gm.B = ssum; gm.C = dw1; gm.epilogue = kStoreF32;
  gm.M = (int)S2; gm.N = S; gm.K = (int)rows; gm.KO = 1;
  gm.sAm = 1; gm.sAk = S2; gm.sBk = S; gm.sBn = 1; gm.ldc = S;
  cudaError_t err = gemm<T>(gm, 1, st);
  if (err != cudaSuccess) return err;
  // dW2 (S, 2S) = dm^T a over the rows.
  gm = Gemm{};
  gm.A = dm; gm.B = a; gm.C = dw2; gm.epilogue = kStoreF32;
  gm.M = S; gm.N = (int)S2; gm.K = (int)rows; gm.KO = 1;
  gm.sAm = 1; gm.sAk = S; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, st)) != cudaSuccess) return err;
  if ((err = colsum<T>(static_cast<const T*>(dh1), rows, (int)S2, part, db1,
                       st)) != cudaSuccess)
    return err;
  return colsum<T>(static_cast<const T*>(dm), rows, S, part + kColSplits * S2,
                   db2, st);
}

bool bad_dims(int B, int H, int S, int D, int Dv) {
  return B < 1 || H < 1 || S < 1 || D < 1 || D > 256 || Dv < 1 || Dv > 256;
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v, g (B,H,S,Dv) in
// the compute type; m (B,S,S), lse and delta (B,H,S) fp32; w1t (S,2S), w1
// (2S,S), w2 (S,2S) in the compute type, b1 (2S) fp32. Outputs: dq
// (B,H,S,D) in the compute type, dssum (B,S,S) fp32, and the per-row factors
// of the weight grads, ssum and dm (B,S,S) and a and dh1 (B,S,2S) in the
// compute type, with gp (B,S,2S) fp32 scratch. All contiguous.
extern "C" int hires_attention_dq(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const void* w1t,
    const float* b1, const void* w1, const void* w2, void* dq, float* dssum,
    void* ssum, void* dm, void* a, float* gp, void* dh1, int B, int H, int S,
    int D, int Dv, float scale, void* stream) {
  if (bad_dims(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run_dq<__nv_bfloat16>(q, k, v, g, R, w1t, b1, w1, w2, dq,
                                      dssum, ssum, dm, a, gp, dh1, B, D, Dv,
                                      st);
  return (int)run_dq<float>(q, k, v, g, R, w1t, b1, w1, w2, dq, dssum, ssum,
                            dm, a, gp, dh1, B, D, Dv, st);
}

// dW1 (2S,S), db1 (2S), dW2 (S,2S), db2 (S), fp32, from the dq pass's ssum,
// dm (rows,S) and a, dh1 (rows,2S) in the compute type; rows = B*S. `part`
// is scratch of kColSplits * 3S floats. Returns a cudaError_t.
extern "C" int hires_weight_grads(int is_bf16, const void* ssum,
                                  const void* dm, const void* a,
                                  const void* dh1, float* dw1, float* db1,
                                  float* dw2, float* db2, float* part,
                                  int rows, int S, void* stream) {
  if (rows < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run_weight_grads<__nv_bfloat16>(ssum, dm, a, dh1, dw1, db1,
                                                dw2, db2, part, rows, S, st);
  return (int)run_weight_grads<float>(ssum, dm, a, dh1, dw1, db1, dw2, db2,
                                      part, rows, S, st);
}

// dk (B,H,S,D) and dv (B,H,S,Dv) in the compute type from q, k, v, g and the
// residuals m, lse, delta and dssum (fp32, as for hires_attention_dq).
// Returns a cudaError_t.
extern "C" int hires_attention_dkv(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const float* dssum,
    void* dk, void* dv, int B, int H, int S, int D, int Dv, float scale,
    void* stream) {
  if (bad_dims(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run_dkv<__nv_bfloat16>(q, k, v, g, R, dssum, dk, dv, B, D, Dv,
                                       st);
  return (int)run_dkv<float>(q, k, v, g, R, dssum, dk, dv, B, D, Dv, st);
}
