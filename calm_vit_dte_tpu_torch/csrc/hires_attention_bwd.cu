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
// under 0.5 GB of traffic: bound by operations. The bf16 route runs every
// product on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate;
// hires_mma.cuh); the fp32 route (the card-vs-CPU parity checks) forms its
// products as fp32 FMAs on the CUDA cores.
//
// Design (no atomics anywhere, so results are the same from run to run):
//   * The heads couple through dm and ssum, which the mask MLP's backward
//     needs whole before dq can be formed. The dm/ssum kernel owns one
//     64 x 64 (query, key) tile of one batch element and loops over the
//     heads, summing dl_h and q_h k_h^T in registers; dm and ssum go to
//     device memory in the compute type (the TPU grid's per-tile values).
//     bf16 (hires_dm_ssum_bf16_kernel): 4 warps of 16 query rows; per head,
//     the (q_h, k_h) and then (g_h, v_h) [64][64] chunk pairs stream through
//     three cp.async stages (two pairs in flight while one computes), and
//     s = q_h k_h^T and dp = g_h v_h^T accumulate on the tensor cores; m
//     stays in registers across the heads.
//   * The mask MLP's products run over all B*S rows with the strided
//     product (bf16: gemm_tc_kernel): h1 (GELU and gelu' applied to the
//     accumulators), da = dm W2 (times gelu', rounded), dssum = dh1 W1.
//   * The weight grads are sums over all B*S query rows. The TPU grid carried
//     them from step to step; here hires_weight_grads forms dW1 = dh1^T ssum
//     and dW2 = dm^T a with the same product. bf16: the rows are split into
//     kWgSplits fixed ranges (grid z), each range's partial product goes to
//     scratch, and sum_partials_kernel adds the partials in order (the 2S x
//     S output at S = 448 has 28 tiles of 128 x 128: 224 CTAs split). fp32:
//     one CTA per 64 x 64 output tile runs the whole contraction in order.
//     The bias grads are two-stage ordered column sums on both routes.
//   * dq, bf16 (hires_dq_bf16_kernel): one CTA of 4 warps per (64 query
//     rows, head, batch element), grid (H, ceil(S/64), B) with the heads
//     fastest, so the H CTAs that read the same rows of m and dssum run
//     together and all but the first find them in L2. q and g rows stay in
//     shared memory; per key tile the v chunks (dp = g v^T), the k chunks
//     (s = q k^T) and the k chunks again (dq += ds k) stream through the
//     chunk ring (four stages). ds = round(scale * dl + dssum) goes from the
//     score accumulators into the A fragments of ds k in registers
//     (c_to_a); k is read as B through ldmatrix.trans. The recompute of
//     q k^T and g v^T in both kernels is kept: the fused Pallas body needs
//     a (rows x S) dm and ssum per CTA, which does not fit in 227 KB at
//     S = 1024. fp32 (hires_dq_kernel): the key tiles (v, then k, through
//     one buffer) in fp32 shared memory, ds through shared memory.
//   * dk, dv, bf16 (hires_dkv_bf16_kernel): one CTA of 8 warps per (64
//     keys, head, batch element), grid (H, ceil(S/64), B) with the heads
//     fastest, so the H CTAs that read the same key columns of m and dssum
//     share them through L2. 16 rows x (D + Dv) fp32 accumulators do not fit
//     one warp's registers at D = Dv = 256, so the work is split by output:
//     warps 0-3 own dv, warps 4-7 dk, over the same 16 keys each. k and v
//     rows stay in shared memory; per query tile the (q, g) chunk pairs
//     stream through the ring twice (three stages). First pass: the dv warps
//     form s^T = k q^T, the dk warps dp^T = v g^T, each on its own half of
//     a pair; the dv warps turn s^T into p^T and hand it to the dk warps
//     through shared memory in fragment order. Second pass: dv += round(p)^T
//     g and dk += ds^T q, the A fragments from the score registers (c_to_a),
//     q and g read as B through ldmatrix.trans. m and dssum are staged per
//     query tile as [64 queries][64 keys] fp32 tiles with 16-byte cp.async
//     (their rows run along the keys) and read transposed from shared memory
//     (row stride 68 floats: no bank conflicts), so no warp load strides by
//     rows of S and no transposed copy is made; they, lse and delta are
//     double-buffered and copied a query tile ahead. 4 units of products,
//     as the fp32 route (no recompute of s^T by the dk warps). ptxas gives
//     162, 208, 249 and 255 registers for NC = 1-4, no spills; the CTA
//     takes 209,920 bytes of shared memory at D = 256 (173,056 at 112),
//     so one CTA of 8 warps an SM. On an H100 (chip_smoke.py) it runs at
//     about 120 TFLOP/s at S = 1024, D = 256, B = 8.
//     fp32 (hires_dkv_kernel): one CTA per (64 keys, batch element and
//     head) streams the query tiles: scores and dp transposed (key rows), dv
//     += round(p)^T g and dk += ds^T q from shared memory; m and dssum read
//     transposed by their indexing.
// The bf16 route takes S, D and Dv that are multiples of 8 (16-byte rows);
// the wrapper and the C entries refuse any other shape.

#include "hires_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.

// The dm/ssum kernel's (q, k) or (g, v) chunk pairs, and the dk/dv
// kernel's (q, g) pairs: kPairStages stages of two [64][64] chunks, 55,296
// bytes (four stages made the dk/dv kernel spill and run 5-8% slower).
constexpr int kPairStages = 3;
constexpr size_t kDmSsumSmem = sizeof(bf16) * kPairStages * 2 * kChunkElems;

__global__ void __launch_bounds__(kAttnThreads) hires_dm_ssum_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const Residuals R,
    int D, int Dv, bf16* __restrict__ dm, bf16* __restrict__ ssum) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int H = R.H, S = R.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * kAttnRows, q0 = blockIdx.y * kAttnRows;
  const int b = blockIdx.z;
  const int nkc = chunks_of(D), nvc = chunks_of(Dv), per = nkc + nvc;
  int rows[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) rows[hf] = q0 + warp * 16 + gr + 8 * hf;

  // Pair `at`: head at / per; its (q, k) chunks, then its (g, v) chunks.
  auto pair = [&](int at) {
    if (at < H * per) {
      const int h = at / per, c = at - h * per;
      const size_t head = ((size_t)b * H + h) * S;
      bf16* dst = ring + (at % kPairStages) * 2 * kChunkElems;
      if (c < nkc) {
        copy_chunk(dst, q + (head + q0) * D, D, S - q0, c);
        copy_chunk(dst + kChunkElems, k + (head + t0) * D, D, S - t0, c);
      } else {
        copy_chunk(dst, g + (head + q0) * Dv, Dv, S - q0, c - nkc);
        copy_chunk(dst + kChunkElems, v + (head + t0) * Dv, Dv, S - t0,
                   c - nkc);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int at = 0; at < kPairStages - 1; ++at) pair(at);

  float mv[8][4], dm_acc[8][4], ss_acc[8][4];
  zero8(dm_acc);
  zero8(ss_acc);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = t0 + n * 8 + 2 * t;   // key + 1 < S iff key < S
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 x = make_float2(0.f, 0.f);
      if (key < S && rows[hf] < S)
        x = *reinterpret_cast<const float2*>(
            R.m + ((size_t)b * S + rows[hf]) * S + key);
      mv[n][2 * hf] = x.x;
      mv[n][2 * hf + 1] = x.y;
    }
  }
  int i = 0;
  for (int h = 0; h < H; ++h) {
    float s[8][4], dp[8][4];
    zero8(s);
    zero8(dp);
    for (int c = 0; c < per; ++c, ++i) {
      cp_wait<kPairStages - 2>();
      __syncthreads();  // pair i has landed; pair i - 1's stage is free
      pair(i + kPairStages - 1);
      const bf16* X = ring + (i % kPairStages) * 2 * kChunkElems;
      if (c < nkc)
        rows_by_chunk(s, X, kChunkLd, 0, X + kChunkElems, chunk_steps(D, c),
                      lane, warp);
      else
        rows_by_chunk(dp, X, kChunkLd, 0, X + kChunkElems,
                      chunk_steps(Dv, c - nkc), lane, warp);
    }
    const size_t head = ((size_t)b * H + h) * S;
    float l[2], de[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] = rows[hf] < S ? R.lse[head + rows[hf]] : 0.f;
      de[hf] = rows[hf] < S ? R.delta[head + rows[hf]] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] * R.scale + mv[n][e] - l[e >> 1]);
        dm_acc[n][e] += p * (dp[n][e] - de[e >> 1]);
        ss_acc[n][e] += s[n][e];
      }
  }
  cp_wait<0>();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = t0 + n * 8 + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (key < S && rows[hf] < S) {
        const size_t at = ((size_t)b * S + rows[hf]) * S + key;
        *reinterpret_cast<uint32_t*>(dm + at) =
            pack(dm_acc[n][2 * hf], dm_acc[n][2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(ssum + at) =
            pack(ss_acc[n][2 * hf], ss_acc[n][2 * hf + 1]);
      }
    }
  }
}

// Dynamic shared memory of the bf16 dq CTA: the resident q and g tiles and
// the chunk ring (104,448 bytes at D = Dv = 256, two CTAs an SM).
size_t dq_bf16_smem(int D, int Dv) {
  return sizeof(bf16) *
         ((size_t)kAttnRows * (tcore::pad16(D) + 8 + tcore::pad16(Dv) + 8) +
          (size_t)kRingStages * kChunkElems);
}

template <int NQ>
__global__ void __launch_bounds__(kAttnThreads) hires_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, bf16* __restrict__ dq) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = R.H, S = R.S;
  const int ldq = pad16(D) + 8, ldg = pad16(Dv) + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + kAttnRows * ldq;
  bf16* ring = sG + kAttnRows * ldg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, q0 = blockIdx.y * kAttnRows;
  const size_t head = ((size_t)b * H + blockIdx.x) * S;
  const bf16* kh = k + head * D;
  const bf16* vh = v + head * Dv;
  const int nkt = (S + kAttnRows - 1) / kAttnRows;
  const int nkc = chunks_of(D), nvc = chunks_of(Dv);
  const int per = nvc + 2 * nkc;
  int rows[2];
  float l[2], de[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rows[hf] = q0 + warp * 16 + gr + 8 * hf;
    l[hf] = rows[hf] < S ? R.lse[head + rows[hf]] : 0.f;
    de[hf] = rows[hf] < S ? R.delta[head + rows[hf]] : 0.f;
  }

  // Chunk `at`: key tile at / per; its v chunks, its k chunks, and its k
  // chunks again.
  auto chunk = [&](int at) {
    if (at < nkt * per) {
      const int j = at / per, c = at - j * per;
      bf16* dst = ring + (at % kRingStages) * kChunkElems;
      if (c < nvc)
        copy_chunk(dst, vh + (size_t)j * kAttnRows * Dv, Dv,
                   S - j * kAttnRows, c);
      else
        copy_chunk(dst, kh + (size_t)j * kAttnRows * D, D,
                   S - j * kAttnRows, (c - nvc) % nkc);
    }
    cp_commit();
  };
  copy_resident(sQ, q + (head + q0) * D, D, S - q0);   // join chunk 0
  copy_resident(sG, g + (head + q0) * Dv, Dv, S - q0);
#pragma unroll
  for (int at = 0; at < kRingStages - 1; ++at) chunk(at);
  int i = 0;
  auto next = [&]() -> const bf16* {
    cp_wait<kRingStages - 2>();
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is free
    chunk(i + kRingStages - 1);
    return ring + (i++ % kRingStages) * kChunkElems;
  };

  float acc[NQ * kChunkN][4];
#pragma unroll
  for (int n = 0; n < NQ * kChunkN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    float dp[8][4], s[8][4];
    zero8(dp);
    for (int c = 0; c < nvc; ++c)
      rows_by_chunk(dp, sG, ldg, c, next(), chunk_steps(Dv, c), lane, warp);
    zero8(s);
    for (int c = 0; c < nkc; ++c)
      rows_by_chunk(s, sQ, ldq, c, next(), chunk_steps(D, c), lane, warp);
    // ds = scale * dl + dssum in s's registers (0 outside the matrix).
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = j * kAttnRows + n * 8 + 2 * t;  // key + 1 < S iff key < S
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2 ds = make_float2(0.f, 0.f);
        if (key < S && rows[hf] < S) {
          const size_t at = ((size_t)b * S + rows[hf]) * S + key;
          const float2 mm = *reinterpret_cast<const float2*>(R.m + at);
          const float2 dd = *reinterpret_cast<const float2*>(dssum + at);
          const float p0 = __expf(s[n][2 * hf] * R.scale + mm.x - l[hf]);
          const float p1 = __expf(s[n][2 * hf + 1] * R.scale + mm.y - l[hf]);
          ds.x = p0 * (dp[n][2 * hf] - de[hf]) * R.scale + dd.x;
          ds.y = p1 * (dp[n][2 * hf + 1] - de[hf]) * R.scale + dd.y;
        }
        s[n][2 * hf] = ds.x;
        s[n][2 * hf + 1] = ds.y;
      }
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) c_to_a(da[kb], s[2 * kb], s[2 * kb + 1]);
#pragma unroll
    for (int u = 0; u < NQ; ++u)
      if (u < nkc)
        probs_by_chunk(acc, u, da, next(), chunk_steps(D, u), lane);
  }
  cp_wait<0>();

  bf16* dqh = dq + head * D;
#pragma unroll
  for (int n = 0; n < NQ * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < D) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < S)
          *reinterpret_cast<uint32_t*>(dqh + (size_t)rows[hf] * D + d) =
              pack(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

// The bf16 dk/dv CTA: 8 warps over 64 keys of one (batch element, head).
// Warps 0-3 own dv, warps 4-7 dk, each warp the same 16 keys in both
// groups. The residual tiles of a query tile, m and dssum [64 queries][64
// keys] fp32 (rows contiguous along the keys, so every copy is a 16-byte
// cp.async), and its lse and delta, are double-buffered; the probabilities
// p^T pass from the dv warps to the dk warps in fragment order.
constexpr int kDkvWarps = 2 * kAttnWarps;
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kResLd = kAttnRows + 4;   // conflict-free transposed reads
constexpr int kResElems = kAttnRows * kResLd;
constexpr int kXchFloats = kAttnWarps * 32 * 32;   // 8 float4 a thread

// Dynamic shared memory of the bf16 dk/dv CTA: the resident k and v tiles,
// the ring of (q, g) chunk pairs, two buffers of m, dssum, lse and delta,
// and the p^T exchange (209,920 bytes at D = Dv = 256, one CTA an SM).
size_t dkv_bf16_smem(int D, int Dv) {
  return sizeof(bf16) *
             ((size_t)kAttnRows * (tcore::pad16(D) + 8 + tcore::pad16(Dv) + 8) +
              (size_t)kPairStages * 2 * kChunkElems) +
         sizeof(float) * ((size_t)4 * kResElems + 4 * kAttnRows + kXchFloats);
}

// Rows [0, 64) x columns [0, 64) of an fp32 matrix with row stride ld
// (a multiple of 4) into a [64][kResLd] tile; rows at or past live_r and
// columns at or past live_c (a multiple of 4) become zeros. No commit.
__device__ __forceinline__ void copy_res_tile(float* dst, const float* src,
                                              int ld, int live_r,
                                              int live_c) {
  for (int idx = threadIdx.x; idx < kAttnRows * kAttnRows / 4;
       idx += kDkvThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float* d = dst + r * kResLd + c;
    if (r < live_r && c < live_c)
      tcore::cp_async16(d, src + (size_t)r * ld + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dk and dv of 64 keys of one (batch element, head); NC = chunks of the
// wider of D and Dv. Per query tile, the (q, g) chunk pairs stream through
// the ring twice: first the dv warps form s^T = k q^T from the q chunks and
// the dk warps dp^T = v g^T from the g chunks (rows_by_chunk, the resident
// k or v rows as A); the dv warps turn s^T into p^T = exp(scale s^T + m^T -
// lse) and hand it over; then the dv warps add round(p)^T g and the dk warps
// ds^T q, ds^T = round(scale p^T (dp^T - delta) + dssum^T), each from the
// A fragments in registers (probs_by_chunk).
template <int NC>
__global__ void __launch_bounds__(kDkvThreads, 1) hires_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = R.H, S = R.S;
  const int ldk = pad16(D) + 8, ldv = pad16(Dv) + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kAttnRows * ldk;
  bf16* ring = sV + kAttnRows * ldv;
  // [buffer][m, dssum][64 queries][kResLd], then [buffer][lse, delta][64].
  float* sRes = reinterpret_cast<float*>(ring + kPairStages * 2 * kChunkElems);
  float* sVec = sRes + 4 * kResElems;
  float4* sXch = reinterpret_cast<float4*>(sVec + 4 * kAttnRows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp & (kAttnWarps - 1);       // keys 16w of the CTA's 64
  const bool owns_dk = warp >= kAttnWarps;
  const int gr = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, t0 = blockIdx.y * kAttnRows;
  const size_t head = ((size_t)b * H + blockIdx.x) * S;
  const bf16* qh = q + head * D;
  const bf16* gh = g + head * Dv;
  const int nkc = chunks_of(D), nvc = chunks_of(Dv);
  const int nqt = (S + kAttnRows - 1) / kAttnRows;
  constexpr int kPerTile = 2 * NC;   // pairs per query tile

  // Pair `at`: query tile at / kPerTile, chunk at % NC of its q and g rows.
  auto pair = [&](int at) {
    if (at < nqt * kPerTile) {
      const int q0 = at / kPerTile * kAttnRows, c = at % NC;
      bf16* dst = ring + (at % kPairStages) * 2 * kChunkElems;
      if (c < nkc)
        copy_chunk<kDkvThreads>(dst, qh + (size_t)q0 * D, D, S - q0, c);
      if (c < nvc)
        copy_chunk<kDkvThreads>(dst + kChunkElems, gh + (size_t)q0 * Dv, Dv,
                                S - q0, c);
    }
    cp_commit();
  };
  // Query tile j's residuals into buffer j % 2 (joins the next commit).
  auto residuals = [&](int j) {
    if (j >= nqt) return;
    const int q0 = j * kAttnRows;
    float* dst = sRes + (j & 1) * 2 * kResElems;
    const size_t at = ((size_t)b * S + q0) * S + t0;
    copy_res_tile(dst, R.m + at, S, S - q0, S - t0);
    copy_res_tile(dst + kResElems, dssum + at, S, S - q0, S - t0);
    const int c = (threadIdx.x & 15) * 4;
    if (threadIdx.x < 32) {
      float* vd = sVec + (j & 1) * 2 * kAttnRows + (threadIdx.x >> 4) *
                                                       kAttnRows + c;
      const float* src = (threadIdx.x < 16 ? R.lse : R.delta) + head + q0 + c;
      if (q0 + c < S) cp_async16(vd, src);
      else *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  copy_resident<kDkvThreads>(sK, k + (head + t0) * D, D, S - t0);
  copy_resident<kDkvThreads>(sV, v + (head + t0) * Dv, Dv, S - t0);
  residuals(0);   // these join pair 0
#pragma unroll
  for (int at = 0; at < kPairStages - 1; ++at) pair(at);
  int i = 0;
  // Pair i has landed and every warp is done with pair i - 1's stage and
  // with the residual buffer of two tiles back: refill both.
  auto next = [&]() -> const bf16* {
    cp_wait<kPairStages - 2>();
    __syncthreads();
    if (i % kPerTile == 0) residuals(i / kPerTile + 1);
    pair(i + kPairStages - 1);
    return ring + (i++ % kPairStages) * 2 * kChunkElems;
  };

  // This warp's operands: phase 1 A rows and the pair half it reads as B,
  // phase 2 the pair half it reads and its width.
  const bf16* rows = owns_dk ? sV : sK;
  const int ldr = owns_dk ? ldv : ldk;
  const int w1 = owns_dk ? Dv : D, w2 = owns_dk ? D : Dv;
  const int half1 = owns_dk ? kChunkElems : 0, half2 = kChunkElems - half1;
  float4* xch = sXch + w * 8 * 32 + lane;
  const int key[2] = {w * 16 + gr, w * 16 + gr + 8};   // of the CTA's 64

  float acc[NC * kChunkN][4];
#pragma unroll
  for (int n = 0; n < NC * kChunkN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < nqt; ++j) {
    const float* res = sRes + (j & 1) * 2 * kResElems;
    const float* vec = sVec + (j & 1) * 2 * kAttnRows;
    float s[8][4];   // keys 16w + gr (+8) x queries 8n + 2t (+1)
    zero8(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bf16* X = next();
      if (c < chunks_of(w1))
        rows_by_chunk(s, rows, ldr, c, X + half1, chunk_steps(w1, c), lane,
                      w);
    }
    uint32_t a[4][4];
    if (!owns_dk) {
      // p^T = exp(scale s^T + m^T - lse), handed to the dk warps.
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = n * 8 + 2 * t + (e & 1);
          s[n][e] = __expf(s[n][e] * R.scale + res[qr * kResLd + key[e >> 1]] -
                           vec[qr]);
        }
        xch[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) c_to_a(a[kb], s[2 * kb], s[2 * kb + 1]);
    }
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const bf16* X = next();   // after the first: p^T is in the exchange
      if (u == 0 && owns_dk) {
        // ds^T = round(scale p^T (dp^T - delta) + dssum^T); s holds dp^T.
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 p4 = xch[n * 32];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = n * 8 + 2 * t + (e & 1);
            s[n][e] = p[e] * (s[n][e] - vec[kAttnRows + qr]) * R.scale +
                      res[kResElems + qr * kResLd + key[e >> 1]];
          }
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) c_to_a(a[kb], s[2 * kb], s[2 * kb + 1]);
      }
      if (u < chunks_of(w2))
        probs_by_chunk(acc, u, a, X + half2, chunk_steps(w2, u), lane);
    }
  }
  cp_wait<0>();

  bf16* out = owns_dk ? dk + head * D : dv + head * Dv;
#pragma unroll
  for (int n = 0; n < NC * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < w2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (t0 + key[hf] < S)
          *reinterpret_cast<uint32_t*>(out + (size_t)(t0 + key[hf]) * w2 + d) =
              pack(acc[n][2 * hf], acc[n][2 * hf + 1]);
      }
    }
  }
}

template <int NC>
cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* g, const Residuals& R,
                            const float* dssum, int B, int D, int Dv,
                            bf16* dk, bf16* dv, cudaStream_t st,
                            Report& rep) {
  auto kern = hires_dkv_bf16_kernel<NC>;
  const size_t smem = dkv_bf16_smem(D, Dv);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(R.H, (R.S + kAttnRows - 1) / kAttnRows, B), kDkvThreads, smem,
         st>>>(q, k, v, g, R, dssum, D, Dv, dk, dv);
  return rep.done(smem);
}

template <int NQ>
cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* g, const Residuals& R,
                           const float* dssum, int B, int D, int Dv, bf16* dq,
                           cudaStream_t st, Report& rep) {
  auto kern = hires_dq_bf16_kernel<NQ>;
  const size_t smem = dq_bf16_smem(D, Dv);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(R.H, (R.S + kAttnRows - 1) / kAttnRows, B), kAttnThreads, smem,
         st>>>(q, k, v, g, R, dssum, D, Dv, dq);
  return rep.done(smem);
}

// dm, ssum (the dm/ssum kernel) and dq on the route of the compute type.
template <typename T>
cudaError_t dm_ssum(const T* q, const T* k, const T* v, const T* g,
                    const Residuals& R, int B, int D, int Dv, T* dm, T* ssum,
                    cudaStream_t st, Report& rep) {
  const unsigned tiles = (unsigned)((R.S + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    cudaError_t err = allow_smem(hires_dm_ssum_bf16_kernel, kDmSsumSmem);
    if (err != cudaSuccess) return err;
    hires_dm_ssum_bf16_kernel<<<dim3(tiles, tiles, B), kAttnThreads,
                                kDmSsumSmem, st>>>(q, k, v, g, R, D, Dv, dm,
                                                   ssum);
    return rep.done(kDmSsumSmem);
  } else {
    const size_t smem = dm_ssum_smem(D, Dv);
    cudaError_t err = allow_smem(hires_dm_ssum_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    hires_dm_ssum_kernel<T><<<dim3(tiles, tiles, B), kThreads, smem, st>>>(
        q, k, v, g, R, D, Dv, dm, ssum);
    return rep.done(smem);
  }
}

template <typename T, int CJ>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* g,
                      const Residuals& R, const float* dssum, int B, int D,
                      int Dv, T* dq, cudaStream_t st, Report& rep) {
  auto kern = hires_dq_kernel<T, CJ>;
  const size_t smem = tiled_smem(D, Dv, 1);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((R.S + kTile - 1) / kTile, B * R.H), kThreads, smem, st>>>(
      q, k, v, g, R, dssum, D, Dv, dq);
  return rep.done(smem);
}

template <typename T>
cudaError_t dq_pass(const T* q, const T* k, const T* v, const T* g,
                    const Residuals& R, const float* dssum, int B, int D,
                    int Dv, T* dq, cudaStream_t st, Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(kMaxChunks == 4, "one case per chunk count");
    switch (chunks_of(D)) {
      case 1:
        return launch_dq_bf16<1>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
      case 2:
        return launch_dq_bf16<2>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
      case 3:
        return launch_dq_bf16<3>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
      default:
        return launch_dq_bf16<4>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
    }
  } else {
    switch (cols_per_thread(D)) {
      case 4:
        return launch_dq<T, 4>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
      case 8:
        return launch_dq<T, 8>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
      default:
        return launch_dq<T, 16>(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
    }
  }
}

template <typename T, int CJ>
cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* g,
                       const Residuals& R, const float* dssum, int B, int D,
                       int Dv, T* dk, T* dv, cudaStream_t st, Report& rep) {
  auto kern = hires_dkv_kernel<T, CJ>;
  const size_t smem = tiled_smem(D, Dv, 2);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((R.S + kTile - 1) / kTile, B * R.H), kThreads, smem, st>>>(
      q, k, v, g, R, dssum, D, Dv, dk, dv);
  return rep.done(smem);
}

template <typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* g, const Residuals& R, const void* w1t,
                   const float* b1, const void* w1, const void* w2, void* dq,
                   float* dssum, void* ssum, void* dm, void* a, float* gp,
                   void* dh1, int B, int D, int Dv, cudaStream_t st,
                   Report& rep) {
  const int S = R.S;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  cudaError_t err = dm_ssum<T>(qt, kt, vt, gt, R, B, D, Dv,
                               static_cast<T*>(dm), static_cast<T*>(ssum), st,
                               rep);
  if (err != cudaSuccess) return err;

  const long long S2 = 2LL * S, rows = (long long)B * S;
  Gemm gm = {};
  // a = round(gelu(h1)), gp = gelu'(h1), h1 = ssum W1^T + b1.
  gm.A = ssum; gm.B = w1t; gm.C = a; gm.C2 = gp; gm.bias = b1;
  gm.epilogue = kGelu; gm.M = (int)rows; gm.N = (int)S2; gm.K = S; gm.KO = 1;
  gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, st, rep)) != cudaSuccess) return err;
  // dh1 = round((dm W2) * gp); W2 is (S, 2S) row-major.
  gm = Gemm{};
  gm.A = dm; gm.B = w2; gm.C = dh1; gm.C2 = gp; gm.epilogue = kDgeluMul;
  gm.M = (int)rows; gm.N = (int)S2; gm.K = S; gm.KO = 1;
  gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, st, rep)) != cudaSuccess) return err;
  // dssum = dh1 W1, fp32; W1 is (2S, S) row-major.
  gm = Gemm{};
  gm.A = dh1; gm.B = w1; gm.C = dssum; gm.epilogue = kStoreF32;
  gm.M = (int)rows; gm.N = S; gm.K = (int)S2; gm.KO = 1;
  gm.sAm = S2; gm.sAk = 1; gm.sBk = S; gm.sBn = 1; gm.ldc = S;
  if ((err = gemm<T>(gm, 1, st, rep)) != cudaSuccess) return err;
  return dq_pass<T>(qt, kt, vt, gt, R, dssum, B, D, Dv, static_cast<T*>(dq),
                    st, rep);
}

template <typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* g, const Residuals& R, const float* dssum,
                    void* dk, void* dv, int B, int D, int Dv,
                    cudaStream_t st, Report& rep) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(kMaxChunks == 4, "one case per chunk count");
    switch (chunks_of(D > Dv ? D : Dv)) {
      case 1:
        return launch_dkv_bf16<1>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt,
                                  dvt, st, rep);
      case 2:
        return launch_dkv_bf16<2>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt,
                                  dvt, st, rep);
      case 3:
        return launch_dkv_bf16<3>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt,
                                  dvt, st, rep);
      default:
        return launch_dkv_bf16<4>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt,
                                  dvt, st, rep);
    }
  } else {
    switch (cols_per_thread(D > Dv ? D : Dv)) {
      case 4:
        return launch_dkv<T, 4>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                                st, rep);
      case 8:
        return launch_dkv<T, 8>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                                st, rep);
      default:
        return launch_dkv<T, 16>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt,
                                 dvt, st, rep);
    }
  }
}

// Floats of the weight grads' scratch: bf16, kWgSplits partials of dW1 and
// of dW2 (2S^2 each); both routes, kColSplits partial column sums of dh1
// and dm.
long long weight_grads_scratch(bool bf16_route, int S) {
  const long long sq2 = 2LL * S * S;
  return (bf16_route ? 2 * kWgSplits * sq2 : 0) + (long long)kColSplits * 3 * S;
}

template <typename T>
cudaError_t run_weight_grads(const void* ssum, const void* dm, const void* a,
                             const void* dh1, float* dw1, float* db1,
                             float* dw2, float* db2, float* part,
                             long long rows, int S, cudaStream_t st,
                             Report& rep) {
  constexpr bool kSplit = std::is_same<T, bf16>::value;
  const long long S2 = 2LL * S, n = S2 * S;
  // With the split, rows [z kc, (z + 1) kc) of split z; its partial product
  // goes to part + z n (dW1) or part + (kWgSplits + z) n (dW2).
  const long long kc = kSplit ? (rows + kWgSplits - 1) / kWgSplits : rows;
  const int Z = kSplit ? kWgSplits : 1;
  Gemm gm = {};
  // dW1 (2S, S) = dh1^T ssum over the rows.
  gm.A = dh1; gm.B = ssum; gm.C = kSplit ? part : dw1;
  gm.epilogue = kStoreF32; gm.M = (int)S2; gm.N = S; gm.K = (int)kc;
  gm.KO = 1; gm.sAm = 1; gm.sAk = S2; gm.sBk = S; gm.sBn = 1; gm.ldc = S;
  if (kSplit) {
    gm.Ktot = (int)rows; gm.sAz = kc * S2; gm.sBz = kc * S; gm.sCz = n;
  }
  cudaError_t err = gemm<T>(gm, Z, st, rep);
  if (err != cudaSuccess) return err;
  // dW2 (S, 2S) = dm^T a over the rows.
  gm = Gemm{};
  gm.A = dm; gm.B = a; gm.C = kSplit ? part + kWgSplits * n : dw2;
  gm.epilogue = kStoreF32; gm.M = S; gm.N = (int)S2; gm.K = (int)kc;
  gm.KO = 1; gm.sAm = 1; gm.sAk = S; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if (kSplit) {
    gm.Ktot = (int)rows; gm.sAz = kc * S; gm.sBz = kc * S2; gm.sCz = n;
  }
  if ((err = gemm<T>(gm, Z, st, rep)) != cudaSuccess) return err;
  if (kSplit) {
    sum_partials_kernel<<<dim3((unsigned)((n / 4 + 255) / 256), 2), 256, 0,
                          st>>>(part, dw1, part + kWgSplits * n, dw2, n,
                                kWgSplits);
    if ((err = rep.done(0)) != cudaSuccess) return err;
    part += 2 * kWgSplits * n;
  }
  if ((err = colsum<T>(static_cast<const T*>(dh1), rows, (int)S2, part, db1,
                       st, rep)) != cudaSuccess)
    return err;
  return colsum<T>(static_cast<const T*>(dm), rows, S, part + kColSplits * S2,
                   db2, st, rep);
}

bool bad_dims(int is_bf16, int B, int H, int S, int D, int Dv) {
  return B < 1 || H < 1 || S < 1 || D < 1 || D > 256 || Dv < 1 || Dv > 256 ||
         (is_bf16 && (S % 8 || D % 8 || Dv % 8));
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v, g (B,H,S,Dv) in
// the compute type; m (B,S,S), lse and delta (B,H,S) fp32; w1t (S,2S), w1
// (2S,S), w2 (S,2S) in the compute type, b1 (2S) fp32. Outputs: dq
// (B,H,S,D) in the compute type, dssum (B,S,S) fp32, and the per-row factors
// of the weight grads, ssum and dm (B,S,S) and a and dh1 (B,S,2S) in the
// compute type, with gp (B,S,2S) fp32 scratch. All contiguous. bf16 takes
// S, D and Dv that are multiples of 8. Sets *launched to the number of
// kernels the call launched and *smem to the largest dynamic shared memory
// (bytes) one of their CTAs asked for.
extern "C" int hires_attention_dq(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const void* w1t,
    const float* b1, const void* w1, const void* w2, void* dq, float* dssum,
    void* ssum, void* dm, void* a, float* gp, void* dh1, int B, int H, int S,
    int D, int Dv, float scale, void* stream, int* launched,
    long long* smem) {
  *launched = 0;
  *smem = 0;
  if (bad_dims(is_bf16, B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_dq<bf16>(q, k, v, g, R, w1t, b1, w1, w2, dq, dssum, ssum,
                             dm, a, gp, dh1, B, D, Dv, st, rep)
              : run_dq<float>(q, k, v, g, R, w1t, b1, w1, w2, dq, dssum,
                              ssum, dm, a, gp, dh1, B, D, Dv, st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// Floats of the scratch `part` that hires_weight_grads needs at S.
extern "C" long long hires_weight_grads_scratch(int is_bf16, int S) {
  return weight_grads_scratch(is_bf16 != 0, S);
}

// dW1 (2S,S), db1 (2S), dW2 (S,2S), db2 (S), fp32, from the dq pass's ssum,
// dm (rows,S) and a, dh1 (rows,2S) in the compute type; rows = B*S. `part`
// is scratch of hires_weight_grads_scratch(is_bf16, S) floats. Returns a
// cudaError_t; sets *launched and *smem as hires_attention_dq does.
extern "C" int hires_weight_grads(int is_bf16, const void* ssum,
                                  const void* dm, const void* a,
                                  const void* dh1, float* dw1, float* db1,
                                  float* dw2, float* db2, float* part,
                                  int rows, int S, void* stream,
                                  int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  if (rows < 1 || S < 1 || (is_bf16 && S % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_weight_grads<bf16>(ssum, dm, a, dh1, dw1, db1, dw2, db2,
                                       part, rows, S, st, rep)
              : run_weight_grads<float>(ssum, dm, a, dh1, dw1, db1, dw2, db2,
                                        part, rows, S, st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// dk (B,H,S,D) and dv (B,H,S,Dv) in the compute type from q, k, v, g and the
// residuals m, lse, delta and dssum (fp32, as for hires_attention_dq). bf16
// takes S, D and Dv that are multiples of 8. Returns a cudaError_t; sets
// *launched and *smem as hires_attention_dq does.
extern "C" int hires_attention_dkv(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const float* dssum,
    void* dk, void* dv, int B, int H, int S, int D, int Dv, float scale,
    void* stream, int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  if (bad_dims(is_bf16, B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_dkv<bf16>(q, k, v, g, R, dssum, dk, dv, B, D, Dv, st, rep)
              : run_dkv<float>(q, k, v, g, R, dssum, dk, dv, B, D, Dv, st,
                               rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}
