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
//     S output at S = 448 has 28 tiles of 128 x 128: 224 CTAs split). fp32
//     splits the same way on gemm_kernel; bf16 off the multiple of 8 runs
//     one CTA per output tile over the whole contraction.
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
//     S = 1024. fp32 (hires_dq_kernel): see the CUDA-core kernels below.
//   * dq past 256 columns of D or Dv, bf16 (hires_dq_wide_bf16_kernel, the
//     dq part of the TPU's dq pass, axial_attention.py:1087): a warp's
//     accumulators for 16 rows x all of D are 256 a thread at D = 512, and
//     the D <= 256 kernel recomputes nothing but would need them. Bound:
//     2 B H S^2 (2D + Dv) operations, 154.6 GFLOP at S = 1024, D = Dv =
//     512, B = 8, H = 6 (0.156 ms at 989 TFLOP/s) against 0.32 GB moved
//     (0.095 ms at 3.35 TB/s): operations. The design splits the work by product and dq
//     by columns inside one CTA of 8 warps over 64 query rows, as the dk/dv
//     CTA splits by output: warps 0-3 form s = q k^T, warps 4-7 dp = g v^T
//     over the same 16 rows each (q and g resident, k and v chunk pairs
//     streamed through a 3-stage ring); p and dp cross between the groups
//     through a 32 KB exchange in fragment order, both groups round the
//     same ds, and each adds ds k over its half of dq's columns (at most
//     256: 128 accumulators a thread), the k chunks of both halves paired
//     in a second pass through the ring. So no score is recomputed up to D
//     = 512 (all of hires-cls-1024's six-head widths), where splitting dq
//     over the grid, as the wide forward splits o, would recompute s and
//     dp per slice (5/3 the products at D = Dv). Past 512 the CTAs split
//     dq's columns further over the grid (blockIdx.x = head * ns + z), each
//     recomputing the scores. q and g resident bound D, Dv to kTcDqMaxD =
//     544 (229,376 bytes a CTA there; 221,184 at 512; one CTA an SM).
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
//   * dk, dv past 256 columns of D or Dv, bf16 (hires_dkv_wide_bf16_kernel):
//     k and v resident would take 275,456 bytes at D = Dv = 512 and 64
//     keys x (D + Dv) fp32 accumulators the whole register file. The wide
//     kernel keeps the 8 warps and two passes above but holds nothing
//     resident save the residual tiles and the p^T exchange: a ring stage
//     carries the q, g, k and v chunks of one 64-column chunk (k and v
//     re-read from L2 per query tile), so its CTA takes 197,632 bytes at
//     every D and Dv, and dk, dv are split over the grid (blockIdx.x = head
//     * ns + slice, ns = ceil(max(D, Dv) / 256) equal slices of each):
//     pass 1 forms the whole s^T and dp^T, pass 2 streams the slice's
//     chunks of q and g. 1.5x the products at D = Dv with two slices; each
//     slice rounds the same p and ds bits, so the slices agree.
//   * The CUDA-core kernels (hires_dm_ssum_kernel, hires_dq_kernel,
//     hires_dkv_kernel) take any D and Dv. They run every fp32 call and
//     every bf16 pass the tensor-core kernels do not take (family_of: the
//     dq pass past D, Dv 544, or S, D, Dv off the multiple of 8), reading
//     bf16 and rounding at the same points; every product is an fp32 FMA.
//     The dm/ssum and dq kernels are built on the product core of
//     hires_common.cuh, as the forward is: the dm/ssum CTA owns a 64 x 128 (query, key) tile and
//     streams each head's (q, k) and (g, v) chunks through a three-stage
//     ring (cp.async where fp32 rows are 16-byte aligned), s and dp in
//     registers (4 x 8 a thread), dl and s summed over the heads in order;
//     the dq CTA owns 64 query rows and all of dq's columns up to kOutSlice
//     = 512, so per 128-key tile it forms dp (parked in a [64][132] score
//     tile) and s once, puts ds in the score tile in dp's place, and adds
//     ds k over the tile's k chunks (16 keys), each thread 4 rows x 4 NQ
//     columns of dq. Past 512 columns dq splits over the grid. The dk/dv
//     kernel keeps 4 x 4 register tiles: every contraction over D or Dv streams
//     through shared memory 64 columns at a time (scores_chunked), and dk
//     and dv wider than 256 columns split over the grid's z axis, each CTA
//     recomputing the scores for its slice.
// The bf16 tensor-core kernels take S, D and Dv that are multiples of 8
// (16-byte rows): the dq kernels D, Dv <= kTcDqMaxD, the dk/dv kernels
// every width; the C entries take any shape.

#include "hires_mma.cuh"
#include "rope_f32.cuh"

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

// dm and ssum of one (64 query, 128 key) tile of one batch element, summed
// over the heads in order: per head h the ring carries the (q_h, k_h) score
// chunks, then the (g_h, v_h) ones; s = q_h k_h^T and dp = g_h v_h^T stay
// in registers, and dl_h = p_h (dp - delta_h) and s add into the sums.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) hires_dm_ssum_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R, int D, int Dv,
    T* __restrict__ dm, T* __restrict__ ssum) {
  extern __shared__ __align__(16) float smem[];
  const int H = R.H, S = R.S;
  const int t0 = blockIdx.x * kSK, q0 = blockIdx.y * kSQ, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nkc = (D + kKC - 1) / kKC, nvc = (Dv + kKC - 1) / kKC;
  const int per = nkc + nvc;
  auto plan = [&](int at, float* st, Block<T>& a, Block<T>& bb) {
    const int h = at / per, c = at - h * per;
    const size_t head = ((size_t)b * H + h) * S;
    const bool qk = c < nkc;
    const int w = qk ? D : Dv, d0 = (qk ? c : c - nkc) * kKC;
    const T* x = qk ? q : g;
    const T* y = qk ? k : v;
    a = {x + (head + q0) * w + d0, w, kSQ, kKC, S - q0, w - d0, st, kLdK};
    bb = {y + (head + t0) * w + d0, w, kSK, kKC, S - t0, w - d0,
          st + kSQ * kLdK, kLdK};
  };
  Ring<T, kAsync, kThreads, kScoreChunk / kThreads, decltype(plan)> ring(
      plan, smem, kScoreChunk, H * per);

  float acc_dm[4][8], acc_ss[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_dm[i][j] = 0.f, acc_ss[i][j] = 0.f;
  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)b * H + h) * S;
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f, dp[i][j] = 0.f;
    for (int c = 0; c < nkc; ++c) score_chunk(s, ring.next());
    for (int c = 0; c < nvc; ++c) score_chunk(dp, ring.next());
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      const float l = r < S ? R.lse[head + r] : 0.f;
      const float de = r < S ? R.delta[head + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + tx + 16 * j;
        const float mv =
            r < S && t < S ? R.m[((size_t)b * S + r) * S + t] : 0.f;
        float p, dl;
        softmax_grad(s[i][j], dp[i][j], mv, l, de, R.scale, p, dl);
        acc_dm[i][j] += dl;
        acc_ss[i][j] += s[i][j];
      }
    }
  }
  ring.finish();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t >= S) continue;
      const size_t at = ((size_t)b * S + r) * S + t;
      dm[at] = from_f<T>(acc_dm[i][j]);
      ssum[at] = from_f<T>(acc_ss[i][j]);
    }
  }
}

// dq of 64 query rows of one (batch element, head), columns [c0, c0 + W)
// of it (slice z of the grid's split past kOutSlice). Per 128-key tile the
// ring carries the (g, v) score chunks (dp, parked in the score tile), the
// (q, k) ones (s), then the tile's k chunks (kVK keys x the slice's
// columns): ds = round(scale * dl + dssum) replaces dp in the score tile
// and dq += ds k.
template <typename T, int NQ, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) hires_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, int ns,
    T* __restrict__ dq) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                            // [64][kLdS] dp, then ds
  const int H = R.H, S = R.S;
  const int z = blockIdx.x % ns;
  const int b = blockIdx.z, q0 = blockIdx.y * kSQ;
  const size_t bh = (size_t)b * H + blockIdx.x / ns, head = bh * S;
  const int c0 = z * kOutSlice, W = min(kOutSlice, D - c0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qh = q + (head + q0) * D;
  const T* kh = k + head * D;
  const T* gh = g + (head + q0) * Dv;
  const T* vh = v + head * Dv;
  const int nvc = (Dv + kKC - 1) / kKC, nkc = (D + kKC - 1) / kKC;
  const int nkt = (S + kSK - 1) / kSK, per = nvc + nkc + kSK / kVK;
  auto plan = [&](int at, float* st, Block<T>& a, Block<T>& bb) {
    int t, c;
    tile_of(at, per, nkt, t, c);
    const int t0 = t * kSK;
    if (c < nvc + nkc) {
      const bool gv = c < nvc;
      const int w = gv ? Dv : D, d0 = (gv ? c : c - nvc) * kKC;
      a = {(gv ? gh : qh) + d0, w, kSQ, kKC, S - q0, w - d0, st, kLdK};
      bb = {(gv ? vh : kh) + (size_t)t0 * w + d0, w, kSK, kKC, S - t0,
            w - d0, st + kSQ * kLdK, kLdK};
    } else {
      const int r0 = t0 + (c - nvc - nkc) * kVK;
      a = {kh + (size_t)r0 * D + c0, D, kVK, 64 * NQ, S - r0, W, st,
           out_ld(NQ)};
    }
  };
  Ring<T, kAsync, kThreads, cc_stage(NQ) / kThreads, decltype(plan)> ring(
      plan, smem + kSQ * kLdS, cc_stage(NQ),
      (nkt - 1) * per + nvc + nkc + out_chunks(S, nkt - 1));

  float acc[4][4 * NQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int t0 = t * kSK;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nvc; ++c) score_chunk(s, ring.next());
    // dp to this thread's own elements of the score tile (the previous
    // tile's dq chunks are done: the barriers above).
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sS[(ty * 4 + i) * kLdS + tx + 16 * j] = s[i][j];
        s[i][j] = 0.f;
      }
    for (int c = 0; c < nkc; ++c) score_chunk(s, ring.next());
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      // (read here, not held across the tile: the registers go to dq)
      const float l = r < S ? R.lse[head + r] : 0.f;
      const float de = r < S ? R.delta[head + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = t0 + tx + 16 * j;
        float* at_s = sS + (ty * 4 + i) * kLdS + tx + 16 * j;
        float ds = 0.f;
        if (r < S && key < S) {
          const size_t at = ((size_t)b * S + r) * S + key;
          float p, dl;
          softmax_grad(s[i][j], *at_s, R.m[at], l, de, R.scale, p, dl);
          ds = rnd<T>(dl * R.scale + dssum[at]);
        }
        *at_s = ds;
      }
    }
    // (the first dq chunk's barrier: ds is in the score tile)
    const int nqc = out_chunks(S, t);
    for (int c = 0; c < nqc; ++c)
      out_chunk<NQ>(acc, sS, c * kVK, ring.next());
  }
  ring.finish();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    T* drow = dq + (head + r) * D + c0;
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 64 * u + e;
        if (c < W) drow[c] = from_f<T>(acc[i][4 * u + e]);
      }
  }
}

// dk and dv of 64 keys of one (batch element, head), columns [c0, c0 +
// Wk) of dk and [c0, c0 + Wv) of dv (the grid's z slice; either may be
// empty where D and Dv differ).
template <typename T, int CJ>
__global__ void __launch_bounds__(kThreads) hires_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, T* __restrict__ dk,
    T* __restrict__ dv) {
  extern __shared__ float smem[];
  const int H = R.H, S = R.S;
  const int c0 = blockIdx.z * kSlice;
  const int Wk = max(0, min(kSlice, D - c0));
  const int Wv = max(0, min(kSlice, Dv - c0));
  const int ldx = slice_ld(D > Dv ? D : Dv);
  float* sA = smem;                // 64 x kLdC  k or v chunk (this CTA's keys)
  float* sB = sA + kTile * kLdC;   // 64 x kLdC  q or g chunk
  float* sX = sB + kTile * kLdC;   // 64 x ldx   g tile, then q tile: slices
  float* sP = sX + kTile * ldx;    // 64 x kLdP  round(p)^T
  float* sD = sP + kTile * kLdP;   // 64 x kLdP  ds^T
  const int t0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t head = (size_t)bh * S;
  const T* qh = q + head * D;
  const T* kh = k + head * D;
  const T* gh = g + head * Dv;
  const T* vh = v + head * Dv;
  float acc_k[4][CJ], acc_v[4][CJ];
  zero(acc_k);
  zero(acc_v);
  for (int q0 = 0; q0 < S; q0 += kTile) {
    // Key rows (ty + 16i) by query columns (tx + 16j). (The first barrier:
    // the previous tile is done with sX, sP and sD.)
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    scores_chunked<T>(s, sA, sB, kh, t0, qh, q0, S, D);
    scores_chunked<T>(dp, sA, sB, vh, t0, gh, q0, S, Dv);
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
    if (Wv > 0) {
      load_cols<T>(sX, ldx, gh, Dv, q0, S, c0, Wv);
      __syncthreads();
      mm_nn<CJ>(acc_v, sP, kLdP, sX, ldx, Wv);   // dv += round(p)^T g
    }
    if (Wk > 0) {
      __syncthreads();  // every warp is done with g
      load_cols<T>(sX, ldx, qh, D, q0, S, c0, Wk);
      __syncthreads();
      mm_nn<CJ>(acc_k, sD, kLdP, sX, ldx, Wk);   // dk += ds^T q
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Wk) dk[(head + t) * D + c0 + c] = from_f<T>(acc_k[i][j]);
      if (c < Wv) dv[(head + t) * Dv + c0 + c] = from_f<T>(acc_v[i][j]);
    }
  }
}

// Dynamic shared memory of the CUDA-core dk/dv kernel: the two contraction
// chunks, a slice-wide row tile and the score tiles (n_score_tiles 2;
// 132,352 bytes at D or Dv >= 256). The dm/ssum kernel's CTA holds its ring
// (82,944 bytes), the dq kernel's as the forward's (cc_smem,
// hires_common.cuh).
constexpr size_t kDmSsumCcSmem = sizeof(float) * kRing * kScoreChunk;

size_t tiled_smem(int width, int n_score_tiles) {
  return sizeof(float) * kTile *
         ((size_t)2 * kLdC + slice_ld(width) + (size_t)n_score_tiles * kLdP);
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

// The wide bf16 dk/dv CTA (D or Dv past kSlice): the same 8 warps, 64
// keys and two passes per query tile as hires_dkv_bf16_kernel, but with
// nothing resident but the residual tiles and the exchange: a ring stage
// holds the [64][64] chunks of q, g (the query tile's rows) and k, v (the
// CTA's own key rows) of one column chunk, so the CTA's shared memory is
// the same at every D and Dv (kDkvWideSmem). CTA (blockIdx.x = head * ns
// + z) owns columns [z c, z c + c) of dk and of dv (split_cols of each
// over ns = the slices of the wider), at most 256 (128 accumulators a
// thread): pass 1 streams every column chunk of q, k and g, v and forms
// the whole s^T = k q^T and dp^T = v g^T (recomputed by each slice), pass
// 2 streams the slice's chunks of q and g. Each slice rounds the same p and
// ds bits, so the slices agree; no atomics.
constexpr int kQuadElems = 4 * kChunkElems;
constexpr size_t kDkvWideSmem =
    sizeof(bf16) * (size_t)kPairStages * kQuadElems +
    sizeof(float) * ((size_t)4 * kResElems + 4 * kAttnRows + kXchFloats);
static_assert(kDkvWideSmem <= (size_t)kMaxCtaSmem,
              "the wide dk/dv CTA fits at every D and Dv");

template <int NC>
__global__ void __launch_bounds__(kDkvThreads, 1) hires_dkv_wide_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, int ns,
    bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = R.H, S = R.S;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  // [buffer][m, dssum][64 queries][kResLd], then [buffer][lse, delta][64].
  float* sRes = reinterpret_cast<float*>(ring + kPairStages * kQuadElems);
  float* sVec = sRes + 4 * kResElems;
  float4* sXch = reinterpret_cast<float4*>(sVec + 4 * kAttnRows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp & (kAttnWarps - 1);       // keys 16w of the CTA's 64
  const bool owns_dk = warp >= kAttnWarps;
  const int gr = lane >> 2, t = lane & 3;
  const int z = blockIdx.x % ns;
  const int b = blockIdx.z, t0 = blockIdx.y * kAttnRows;
  const size_t head = ((size_t)b * H + blockIdx.x / ns) * S;
  const bf16* qh = q + head * D;
  const bf16* gh = g + head * Dv;
  const bf16* kt = k + (head + t0) * D;    // the CTA's key rows
  const bf16* vt = v + (head + t0) * Dv;
  // This CTA's columns: [ck, ck + wk) of dk, [cv, cv + wv) of dv.
  const int ck = z * split_cols(D, ns), cv = z * split_cols(Dv, ns);
  const int wk = max(0, min(split_cols(D, ns), D - ck));
  const int wv = max(0, min(split_cols(Dv, ns), Dv - cv));
  const int nkc = chunks_of(D), nvc = chunks_of(Dv);
  const int n1 = max(nkc, nvc);   // pass 1's stages of a query tile
  const int per = n1 + NC;        // and pass 2's
  const int nqt = (S + kAttnRows - 1) / kAttnRows;

  // Stage `at`: query tile at / per; in pass 1 column chunk c of q, g, k
  // and v, in pass 2 chunk c - n1 of the slice's columns of q and g.
  auto quad = [&](int at) {
    if (at < nqt * per) {
      const int j = at / per, c = at - j * per, q0 = j * kAttnRows;
      bf16* dst = ring + (at % kPairStages) * kQuadElems;
      const bf16* qs = qh + (size_t)q0 * D;
      const bf16* gs = gh + (size_t)q0 * Dv;
      if (c < n1) {
        if (c < nkc) {
          copy_chunk<kDkvThreads>(dst, qs, D, S - q0, c);
          copy_chunk<kDkvThreads>(dst + 2 * kChunkElems, kt, D, S - t0, c);
        }
        if (c < nvc) {
          copy_chunk<kDkvThreads>(dst + kChunkElems, gs, Dv, S - q0, c);
          copy_chunk<kDkvThreads>(dst + 3 * kChunkElems, vt, Dv, S - t0, c);
        }
      } else {
        const int c1 = (c - n1) * kChunkCols;
        if (c1 < wk)
          copy_rows<kDkvThreads>(dst, kChunkLd, qs, D, S - q0, ck + c1,
                                 ck + wk, kChunkCols);
        if (c1 < wv)
          copy_rows<kDkvThreads>(dst + kChunkElems, kChunkLd, gs, Dv, S - q0,
                                 cv + c1, cv + wv, kChunkCols);
      }
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
  residuals(0);   // these join stage 0
#pragma unroll
  for (int at = 0; at < kPairStages - 1; ++at) quad(at);
  int i = 0;
  // Stage i has landed and every warp is done with stage i - 1 and with
  // the residual buffer of two tiles back: refill both.
  auto next = [&]() -> const bf16* {
    cp_wait<kPairStages - 2>();
    __syncthreads();
    if (i % per == 0) residuals(i / per + 1);
    quad(i + kPairStages - 1);
    return ring + (i++ % kPairStages) * kQuadElems;
  };

  // This warp's operands: pass 1 its A chunk (k or v), the B chunk (q or
  // g) and their width; pass 2 the B chunk and its output's columns.
  const int w1 = owns_dk ? Dv : D;
  const int a1 = owns_dk ? 3 * kChunkElems : 2 * kChunkElems;
  const int b1 = owns_dk ? kChunkElems : 0;
  const int w2 = owns_dk ? wk : wv;
  const int b2 = owns_dk ? 0 : kChunkElems;
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
    for (int c = 0; c < n1; ++c) {
      const bf16* X = next();
      if (c < chunks_of(w1))
        rows_by_chunk(s, X + a1, kChunkLd, 0, X + b1, chunk_steps(w1, c),
                      lane, w);
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
        probs_by_chunk(acc, u, a, X + b2, chunk_steps(w2, u), lane);
    }
  }
  cp_wait<0>();

  const int ld = owns_dk ? D : Dv;
  bf16* out = owns_dk ? dk + head * D + ck : dv + head * Dv + cv;
#pragma unroll
  for (int n = 0; n < NC * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < w2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (t0 + key[hf] < S)
          *reinterpret_cast<uint32_t*>(out + (size_t)(t0 + key[hf]) * ld + d) =
              pack(acc[n][2 * hf], acc[n][2 * hf + 1]);
      }
    }
  }
}

template <int NC>
cudaError_t launch_dkv_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                                 const bf16* g, const Residuals& R,
                                 const float* dssum, int B, int D, int Dv,
                                 int ns, bf16* dk, bf16* dv, cudaStream_t st,
                                 Report& rep) {
  auto kern = hires_dkv_wide_bf16_kernel<NC>;
  cudaError_t err = allow_smem(kern, kDkvWideSmem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ns * R.H, (R.S + kAttnRows - 1) / kAttnRows, B), kDkvThreads,
         kDkvWideSmem, st>>>(q, k, v, g, R, dssum, D, Dv, ns, dk, dv);
  return rep.done(kDkvWideSmem);
}

// dk and dv in ns = slices_of(the wider of D, Dv) slices; NC = the chunks
// of the widest slice of either.
cudaError_t dkv_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* g, const Residuals& R,
                          const float* dssum, int B, int D, int Dv, bf16* dk,
                          bf16* dv, cudaStream_t st, Report& rep) {
  const int ns = slices_of(D > Dv ? D : Dv);
  const int ck = split_cols(D, ns), cv = split_cols(Dv, ns);
  switch (chunks_of(ck > cv ? ck : cv)) {
    case 1:
      return launch_dkv_wide_bf16<1>(q, k, v, g, R, dssum, B, D, Dv, ns, dk,
                                     dv, st, rep);
    case 2:
      return launch_dkv_wide_bf16<2>(q, k, v, g, R, dssum, B, D, Dv, ns, dk,
                                     dv, st, rep);
    case 3:
      return launch_dkv_wide_bf16<3>(q, k, v, g, R, dssum, B, D, Dv, ns, dk,
                                     dv, st, rep);
    default:
      return launch_dkv_wide_bf16<4>(q, k, v, g, R, dssum, B, D, Dv, ns, dk,
                                     dv, st, rep);
  }
}

// The wide bf16 dq CTA (D or Dv past kSlice, both at most kTcDqMaxD): 8
// warps over 64 query rows of one (batch element, head), warps w and w + 4
// on the same 16 rows. The q and g rows stay resident; per key tile, pass
// 1 streams (k, v) chunk pairs through the ring and warps 0-3 form s = q
// k^T, warps 4-7 dp = g v^T; warps 0-3 turn s into p = exp(scale s + m -
// lse); each group hands its tile to the other through shared memory in
// fragment order, and both form the same ds = round(scale p (dp - delta) +
// dssum) for their 16 rows (the same expression on the same fp32 values,
// so the same bits). Pass 2 streams pairs of k chunks, one of each group's
// columns, and each group adds ds k[:, its columns] from the A fragments
// in registers. CTA (blockIdx.x = head * ns + z) owns parts 2z and 2z + 1
// of dq's columns, split_cols(D, 2 ns) each, at most kSlice (NQ chunks,
// 128 accumulators a thread), one a group; ns = 1 to D = 512, where no
// score is recomputed, 2 past it (each CTA recomputes s and dp).
// Dynamic shared memory: the resident q and g tiles, kPairStages chunk
// pairs and the two-way exchange (221,184 bytes at D = Dv = 512, one CTA
// an SM).
constexpr size_t dq_wide_smem(int D, int Dv) {
  return sizeof(bf16) * ((size_t)kAttnRows * (tcore::pad16(D) + 8 +
                                               tcore::pad16(Dv) + 8) +
                         (size_t)kPairStages * 2 * kChunkElems) +
         sizeof(float) * 2 * (size_t)kXchFloats;
}
static_assert(dq_wide_smem(kTcDqMaxD, kTcDqMaxD) <= (size_t)kMaxCtaSmem &&
                  dq_wide_smem(kTcDqMaxD + 16, kTcDqMaxD + 16) >
                      (size_t)kMaxCtaSmem,
              "kTcDqMaxD is the widest D = Dv whose wide dq CTA fits");

template <int NQ>
__global__ void __launch_bounds__(kDkvThreads, 1) hires_dq_wide_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const Residuals R,
    const float* __restrict__ dssum, int D, int Dv, int ns,
    bf16* __restrict__ dq) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = R.H, S = R.S;
  const int ldq = pad16(D) + 8, ldg = pad16(Dv) + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + kAttnRows * ldq;
  bf16* ring = sG + kAttnRows * ldg;
  // [p from warps 0-3, dp from warps 4-7][warp][n][lane], 8 float4 a thread.
  float4* sXch = reinterpret_cast<float4*>(ring + kPairStages * 2 *
                                           kChunkElems);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp & (kAttnWarps - 1);       // rows 16w of the CTA's 64
  const bool dp_warp = warp >= kAttnWarps;
  const int grp = dp_warp ? 1 : 0;
  const int gr = lane >> 2, t = lane & 3;
  const int z = blockIdx.x % ns;
  const int b = blockIdx.z, q0 = blockIdx.y * kAttnRows;
  const size_t head = ((size_t)b * H + blockIdx.x / ns) * S;
  const bf16* kh = k + head * D;
  const bf16* vh = v + head * Dv;
  // The two groups' columns of dq: [ca, ca + wa) and [cb, cb + wb).
  const int cw = split_cols(D, 2 * ns);
  const int ca = 2 * z * cw, cb = ca + cw;
  const int wa = max(0, min(cw, D - ca)), wb = max(0, min(cw, D - cb));
  const int nkc = chunks_of(D), nvc = chunks_of(Dv);
  const int n1 = max(nkc, nvc);   // pass 1's stages of a key tile
  const int per = n1 + NQ;        // and pass 2's
  const int nkt = (S + kAttnRows - 1) / kAttnRows;

  // Stage `at`: key tile at / per; in pass 1 column chunk c of k and of v,
  // in pass 2 chunk c - n1 of each group's columns of k.
  auto pair = [&](int at) {
    if (at < nkt * per) {
      const int j = at / per, c = at - j * per, t0 = j * kAttnRows;
      bf16* dst = ring + (at % kPairStages) * 2 * kChunkElems;
      const bf16* kt = kh + (size_t)t0 * D;
      if (c < n1) {
        if (c < nkc) copy_chunk<kDkvThreads>(dst, kt, D, S - t0, c);
        if (c < nvc)
          copy_chunk<kDkvThreads>(dst + kChunkElems, vh + (size_t)t0 * Dv,
                                  Dv, S - t0, c);
      } else {
        const int c1 = (c - n1) * kChunkCols;
        if (c1 < wa)
          copy_rows<kDkvThreads>(dst, kChunkLd, kt, D, S - t0, ca + c1,
                                 ca + wa, kChunkCols);
        if (c1 < wb)
          copy_rows<kDkvThreads>(dst + kChunkElems, kChunkLd, kt, D, S - t0,
                                 cb + c1, cb + wb, kChunkCols);
      }
    }
    cp_commit();
  };
  copy_resident<kDkvThreads>(sQ, q + (head + q0) * D, D, S - q0);  // join
  copy_resident<kDkvThreads>(sG, g + (head + q0) * Dv, Dv, S - q0);  // pair 0
#pragma unroll
  for (int at = 0; at < kPairStages - 1; ++at) pair(at);
  int i = 0;
  auto next = [&]() -> const bf16* {
    cp_wait<kPairStages - 2>();
    __syncthreads();  // pair i has landed; pair i - 1's stage is free
    pair(i + kPairStages - 1);
    return ring + (i++ % kPairStages) * 2 * kChunkElems;
  };

  int rows[2];
  float l[2], de[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rows[hf] = q0 + w * 16 + gr + 8 * hf;
    l[hf] = rows[hf] < S ? R.lse[head + rows[hf]] : 0.f;
    de[hf] = rows[hf] < S ? R.delta[head + rows[hf]] : 0.f;
  }
  // This warp's operands: pass 1 its resident rows and their width, then
  // in both passes its half of a stage, and its columns of dq.
  const bf16* rows_a = dp_warp ? sG : sQ;
  const int lda = dp_warp ? ldg : ldq;
  const int w1 = dp_warp ? Dv : D;
  const int half = grp * kChunkElems;
  const int c2 = dp_warp ? cb : ca, w2 = dp_warp ? wb : wa;
  float4* mine = sXch + (grp * kAttnWarps + w) * 8 * 32 + lane;
  const float4* theirs = sXch + ((1 - grp) * kAttnWarps + w) * 8 * 32 + lane;

  float acc[NQ * kChunkN][4];
#pragma unroll
  for (int n = 0; n < NQ * kChunkN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    float s[8][4];   // rows 16w + gr (+8) x keys 8n + 2t (+1): s or dp
    zero8(s);
    for (int c = 0; c < n1; ++c) {
      const bf16* X = next();
      if (c < chunks_of(w1))
        rows_by_chunk(s, rows_a, lda, c, X + half, chunk_steps(w1, c), lane,
                      w);
    }
    if (!dp_warp) {
      // p = exp(scale s + m - lse) (0 outside the matrix; key + 1 < S iff
      // key < S).
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int key = j * kAttnRows + n * 8 + 2 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2 p = make_float2(0.f, 0.f);
          if (key < S && rows[hf] < S) {
            const float2 mm = *reinterpret_cast<const float2*>(
                R.m + ((size_t)b * S + rows[hf]) * S + key);
            p.x = __expf(s[n][2 * hf] * R.scale + mm.x - l[hf]);
            p.y = __expf(s[n][2 * hf + 1] * R.scale + mm.y - l[hf]);
          }
          s[n][2 * hf] = p.x;
          s[n][2 * hf + 1] = p.y;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    uint32_t da[4][4];
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const bf16* X = next();   // after the first: p and dp are exchanged
      if (u == 0) {
        // ds = round(scale p (dp - delta) + dssum), s holding p or dp.
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 o4 = theirs[n * 32];
          const float o[4] = {o4.x, o4.y, o4.z, o4.w};
          const int key = j * kAttnRows + n * 8 + 2 * t;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2 dd = make_float2(0.f, 0.f);
            const bool live = key < S && rows[hf] < S;
            if (live)
              dd = *reinterpret_cast<const float2*>(
                  dssum + ((size_t)b * S + rows[hf]) * S + key);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int e = 2 * hf + x;
              const float p = dp_warp ? o[e] : s[n][e];
              const float dp = dp_warp ? s[n][e] : o[e];
              s[n][e] = live ? p * (dp - de[hf]) * R.scale + (x ? dd.y : dd.x)
                             : 0.f;
            }
          }
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) c_to_a(da[kb], s[2 * kb], s[2 * kb + 1]);
      }
      if (u < chunks_of(w2))
        probs_by_chunk(acc, u, da, X + half, chunk_steps(w2, u), lane);
    }
  }
  cp_wait<0>();

  bf16* out = dq + head * D + c2;
#pragma unroll
  for (int n = 0; n < NQ * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < w2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < S)
          *reinterpret_cast<uint32_t*>(out + (size_t)rows[hf] * D + d) =
              pack(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

template <int NQ>
cudaError_t launch_dq_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const bf16* g, const Residuals& R,
                                const float* dssum, int B, int D, int Dv,
                                int ns, bf16* dq, cudaStream_t st,
                                Report& rep) {
  auto kern = hires_dq_wide_bf16_kernel<NQ>;
  const size_t smem = dq_wide_smem(D, Dv);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ns * R.H, (R.S + kAttnRows - 1) / kAttnRows, B), kDkvThreads,
         smem, st>>>(q, k, v, g, R, dssum, D, Dv, ns, dq);
  return rep.done(smem);
}

// dq in 2 ns parts of split_cols(D, 2 ns) columns, two a CTA (ns = 1 up to
// D = 2 kSlice); NQ = the chunks of a part.
cudaError_t dq_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* g, const Residuals& R,
                         const float* dssum, int B, int D, int Dv, bf16* dq,
                         cudaStream_t st, Report& rep) {
  const int ns = (D + 2 * kSlice - 1) / (2 * kSlice);
  switch (chunks_of(split_cols(D, 2 * ns))) {
    case 1:
      return launch_dq_wide_bf16<1>(q, k, v, g, R, dssum, B, D, Dv, ns, dq,
                                    st, rep);
    case 2:
      return launch_dq_wide_bf16<2>(q, k, v, g, R, dssum, B, D, Dv, ns, dq,
                                    st, rep);
    case 3:
      return launch_dq_wide_bf16<3>(q, k, v, g, R, dssum, B, D, Dv, ns, dq,
                                    st, rep);
    default:
      return launch_dq_wide_bf16<4>(q, k, v, g, R, dssum, B, D, Dv, ns, dq,
                                    st, rep);
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

// dm, ssum (the dm/ssum kernel) and dq: bf16 on the tensor cores where the
// call's family allows (Family), every other call on the CUDA-core kernels.
template <typename T>
cudaError_t dm_ssum(const T* q, const T* k, const T* v, const T* g,
                    const Residuals& R, int B, int D, int Dv, T* dm, T* ssum,
                    Family fam, cudaStream_t st, Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (fam.aligned) {
      const unsigned tiles = (unsigned)((R.S + kTile - 1) / kTile);
      cudaError_t err = allow_smem(hires_dm_ssum_bf16_kernel, kDmSsumSmem);
      if (err != cudaSuccess) return err;
      hires_dm_ssum_bf16_kernel<<<dim3(tiles, tiles, B), kAttnThreads,
                                  kDmSsumSmem, st>>>(q, k, v, g, R, D, Dv,
                                                     dm, ssum);
      return rep.done(kDmSsumSmem);
    }
  }
  const dim3 grid((R.S + kSK - 1) / kSK, (R.S + kSQ - 1) / kSQ, B);
  if constexpr (std::is_same<T, float>::value) {
    if (rows16<T>(q, D, D, D, D) && rows16<T>(k, D, D, D, D) &&
        rows16<T>(v, Dv, Dv, Dv, Dv) && rows16<T>(g, Dv, Dv, Dv, Dv)) {
      auto kern = hires_dm_ssum_kernel<T, true>;
      cudaError_t err = allow_smem(kern, kDmSsumCcSmem);
      if (err != cudaSuccess) return err;
      kern<<<grid, kThreads, kDmSsumCcSmem, st>>>(q, k, v, g, R, D, Dv, dm,
                                                  ssum);
      return rep.done(kDmSsumCcSmem);
    }
  }
  auto kern = hires_dm_ssum_kernel<T, false>;
  cudaError_t err = allow_smem(kern, kDmSsumCcSmem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, kDmSsumCcSmem, st>>>(q, k, v, g, R, D, Dv, dm, ssum);
  return rep.done(kDmSsumCcSmem);
}

template <typename T, int NQ, bool kAsync>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* g,
                      const Residuals& R, const float* dssum, int B, int D,
                      int Dv, T* dq, cudaStream_t st, Report& rep) {
  auto kern = hires_dq_kernel<T, NQ, kAsync>;
  constexpr size_t smem = cc_smem(NQ);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int ns = out_slices(D);
  kern<<<dim3(R.H * ns, (R.S + kSQ - 1) / kSQ, B), kThreads, smem, st>>>(
      q, k, v, g, R, dssum, D, Dv, ns, dq);
  return rep.done(smem);
}

// The CUDA-core dq kernel, NQ = the 64-column groups of dq's widest slice
// (with_nv, hires_common.cuh).
template <typename T, bool kAsync>
cudaError_t dq_cuda_cores(const T* q, const T* k, const T* v, const T* g,
                          const Residuals& R, const float* dssum, int B,
                          int D, int Dv, T* dq, cudaStream_t st,
                          Report& rep) {
  return with_nv<kAsync>(nv_of(D), [&](auto nq) {
    return launch_dq<T, decltype(nq)::value, kAsync>(q, k, v, g, R, dssum, B,
                                                     D, Dv, dq, st, rep);
  });
}

template <typename T>
cudaError_t dq_pass(const T* q, const T* k, const T* v, const T* g,
                    const Residuals& R, const float* dssum, int B, int D,
                    int Dv, T* dq, Family fam, cudaStream_t st,
                    Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(kMaxChunks == 4, "one case per chunk count");
    if (fam.tc_dq && (D > kSlice || Dv > kSlice))
      return dq_wide_bf16(q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
    if (fam.tc_dq) {
      switch (chunks_of(D)) {
        case 1:
          return launch_dq_bf16<1>(q, k, v, g, R, dssum, B, D, Dv, dq, st,
                                   rep);
        case 2:
          return launch_dq_bf16<2>(q, k, v, g, R, dssum, B, D, Dv, dq, st,
                                   rep);
        case 3:
          return launch_dq_bf16<3>(q, k, v, g, R, dssum, B, D, Dv, dq, st,
                                   rep);
        default:
          return launch_dq_bf16<4>(q, k, v, g, R, dssum, B, D, Dv, dq, st,
                                   rep);
      }
    }
  }
  if (rows16<T>(q, D, D, D, D) && rows16<T>(k, D, D, D, D) &&
      rows16<T>(v, Dv, Dv, Dv, Dv) && rows16<T>(g, Dv, Dv, Dv, Dv))
    return dq_cuda_cores<T, std::is_same<T, float>::value>(
        q, k, v, g, R, dssum, B, D, Dv, dq, st, rep);
  return dq_cuda_cores<T, false>(q, k, v, g, R, dssum, B, D, Dv, dq, st,
                                 rep);
}

template <typename T, int CJ>
cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* g,
                       const Residuals& R, const float* dssum, int B, int D,
                       int Dv, T* dk, T* dv, cudaStream_t st, Report& rep) {
  auto kern = hires_dkv_kernel<T, CJ>;
  const int wide = D > Dv ? D : Dv;
  const size_t smem = tiled_smem(wide, 2);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((R.S + kTile - 1) / kTile, B * R.H, slices_of(wide)), kThreads,
         smem, st>>>(q, k, v, g, R, dssum, D, Dv, dk, dv);
  return rep.done(smem);
}

// The mask MLP's backward over the rows = B*S rows, from dm (rows, S) and
// gp = gelu'(h1) (rows, 2S): dh1 = round((dm W2) * gp) (rows, 2S) and
// dssum = dh1 W1 (rows, S, fp32), W2 (S, 2S) and W1 (2S, S) read as they
// lie.
template <typename T>
cudaError_t mask_bwd_products(const void* dm, const void* w2, float* gp,
                              const void* w1, void* dh1,
                              float* dssum, long long rows, int S,
                              bool aligned, cudaStream_t st, Report& rep) {
  const long long S2 = 2LL * S;
  Gemm gm = {};
  gm.A = dm; gm.B = w2; gm.C = dh1; gm.C2 = gp;
  gm.epilogue = kDgeluMul; gm.M = (int)rows; gm.N = (int)S2; gm.K = S;
  gm.KO = 1; gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  cudaError_t err = gemm<T>(gm, 1, aligned, st, rep);
  if (err != cudaSuccess) return err;
  gm = Gemm{};
  gm.A = dh1; gm.B = w1; gm.C = dssum; gm.epilogue = kStoreF32;
  gm.M = (int)rows; gm.N = S; gm.K = (int)S2; gm.KO = 1;
  gm.sAm = S2; gm.sAk = 1; gm.sBk = S; gm.sBn = 1; gm.ldc = S;
  return gemm<T>(gm, 1, aligned, st, rep);
}

template <typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* g, const Residuals& R, const void* w1t,
                   const float* b1, const void* w1, const void* w2, void* dq,
                   float* dssum, void* ssum, void* dm, void* a, float* gp,
                   void* dh1, int B, int D, int Dv, Family fam,
                   cudaStream_t st, Report& rep) {
  const int S = R.S;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  cudaError_t err = dm_ssum<T>(qt, kt, vt, gt, R, B, D, Dv,
                               static_cast<T*>(dm), static_cast<T*>(ssum),
                               fam, st, rep);
  if (err != cudaSuccess) return err;

  const long long S2 = 2LL * S, rows = (long long)B * S;
  Gemm gm = {};
  // a = round(gelu(h1)), gp = gelu'(h1), h1 = ssum W1^T + b1.
  gm.A = ssum; gm.B = w1t; gm.C = a; gm.C2 = gp; gm.bias = b1;
  gm.epilogue = kGelu; gm.M = (int)rows; gm.N = (int)S2; gm.K = S; gm.KO = 1;
  gm.sAm = S; gm.sAk = 1; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if ((err = gemm<T>(gm, 1, fam.aligned, st, rep)) != cudaSuccess) return err;
  if ((err = mask_bwd_products<T>(dm, w2, gp, w1, dh1, dssum, rows, S,
                                  fam.aligned, st, rep)) != cudaSuccess)
    return err;
  return dq_pass<T>(qt, kt, vt, gt, R, dssum, B, D, Dv, static_cast<T*>(dq),
                    fam, st, rep);
}

template <typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* g, const Residuals& R, const float* dssum,
                    void* dk, void* dv, int B, int D, int Dv, Family fam,
                    cudaStream_t st, Report& rep) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(kMaxChunks == 4, "one case per chunk count");
    if (fam.tc_dkv && (D > kSlice || Dv > kSlice))
      return dkv_wide_bf16(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt, st,
                           rep);
    if (fam.tc_dkv) {
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
    }
  }
  switch (cols_per_thread(slice_width(D > Dv ? D : Dv))) {
    case 4:
      return launch_dkv<T, 4>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                              st, rep);
    case 8:
      return launch_dkv<T, 8>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                              st, rep);
    default:
      return launch_dkv<T, 16>(qt, kt, vt, gt, R, dssum, B, D, Dv, dkt, dvt,
                               st, rep);
  }
}

// Whether the weight grads' products split over the rows: fp32 always (on
// the CUDA cores), bf16 with S a multiple of 8 (on the tensor cores; the
// products' operands are S or 2S wide, whatever D and Dv are).
bool split_weight_grads(int is_bf16, int S) {
  return !is_bf16 || S % 8 == 0;
}

// Floats of the weight grads' scratch: split, kWgSplits partials of dW1 and
// of dW2 (2S^2 each); always, kColSplits partial column sums of dh1 and dm.
long long weight_grads_scratch(bool split, int S) {
  const long long sq2 = 2LL * S * S;
  return (split ? 2 * kWgSplits * sq2 : 0) + (long long)kColSplits * 3 * S;
}

template <typename T>
cudaError_t run_weight_grads(const void* ssum, const void* dm, const void* a,
                             const void* dh1, float* dw1, float* db1,
                             float* dw2, float* db2, float* part,
                             long long rows, int S, bool kSplit,
                             cudaStream_t st, Report& rep) {
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
  cudaError_t err = gemm<T>(gm, Z, kSplit, st, rep);
  if (err != cudaSuccess) return err;
  // dW2 (S, 2S) = dm^T a over the rows.
  gm = Gemm{};
  gm.A = dm; gm.B = a; gm.C = kSplit ? part + kWgSplits * n : dw2;
  gm.epilogue = kStoreF32; gm.M = S; gm.N = (int)S2; gm.K = (int)kc;
  gm.KO = 1; gm.sAm = 1; gm.sAk = S; gm.sBk = S2; gm.sBn = 1; gm.ldc = S2;
  if (kSplit) {
    gm.Ktot = (int)rows; gm.sAz = kc * S; gm.sBz = kc * S2; gm.sCz = n;
  }
  if ((err = gemm<T>(gm, Z, kSplit, st, rep)) != cudaSuccess) return err;
  if (kSplit) {
    sum_partials_kernel<<<dim3((unsigned)(((n + 3) / 4 + 255) / 256), 2),
                          256, 0, st>>>(part, dw1, part + kWgSplits * n, dw2, n,
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

bool bad_dims(int B, int H, int S, int D, int Dv) {
  return B < 1 || H < 1 || S < 1 || D < 1 || Dv < 1;
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v, g (B,H,S,Dv) in
// the compute type; m (B,S,S), lse and delta (B,H,S) fp32; w1t (S,2S), w1
// (2S,S), w2 (S,2S) in the compute type, b1 (2S) fp32. Outputs: dq
// (B,H,S,D) in the compute type, dssum (B,S,S) fp32, and the per-row factors
// of the weight grads, ssum and dm (B,S,S) and a and dh1 (B,S,2S) in the
// compute type, with gp (B,S,2S) fp32 scratch. All contiguous. Takes any
// S, D and Dv; family_of(is_bf16, S, D, Dv) picks the kernels. Sets
// *launched to the number of kernels the call launched and *smem to the
// largest dynamic shared memory (bytes) one of their CTAs asked for.
extern "C" int hires_attention_dq(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const void* w1t,
    const float* b1, const void* w1, const void* w2, void* dq, float* dssum,
    void* ssum, void* dm, void* a, float* gp, void* dh1, int B, int H, int S,
    int D, int Dv, float scale, void* stream, int* launched,
    long long* smem) {
  *launched = 0;
  *smem = 0;
  if (bad_dims(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Family fam = family_of(is_bf16, S, D, Dv);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_dq<bf16>(q, k, v, g, R, w1t, b1, w1, w2, dq, dssum, ssum,
                             dm, a, gp, dh1, B, D, Dv, fam, st, rep)
              : run_dq<float>(q, k, v, g, R, w1t, b1, w1, w2, dq, dssum,
                              ssum, dm, a, gp, dh1, B, D, Dv, fam, st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// Floats of the scratch `part` that hires_weight_grads needs at S.
extern "C" long long hires_weight_grads_scratch(int is_bf16, int S) {
  return weight_grads_scratch(split_weight_grads(is_bf16, S), S);
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
  if (rows < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = split_weight_grads(is_bf16, S);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_weight_grads<bf16>(ssum, dm, a, dh1, dw1, db1, dw2, db2,
                                       part, rows, S, split, st, rep)
              : run_weight_grads<float>(ssum, dm, a, dh1, dw1, db1, dw2, db2,
                                        part, rows, S, split, st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// dk (B,H,S,D) and dv (B,H,S,Dv) in the compute type from q, k, v, g and the
// residuals m, lse, delta and dssum (fp32, as for hires_attention_dq). Takes
// any S, D and Dv, as hires_attention_dq does. Returns a cudaError_t; sets
// *launched and *smem as hires_attention_dq does.
extern "C" int hires_attention_dkv(
    int is_bf16, const void* q, const void* k, const void* v, const void* g,
    const float* m, const float* lse, const float* delta, const float* dssum,
    void* dk, void* dv, int B, int H, int S, int D, int Dv, float scale,
    void* stream, int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  if (bad_dims(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const Residuals R{m, lse, delta, H, S, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Family fam = family_of(is_bf16, S, D, Dv);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run_dkv<bf16>(q, k, v, g, R, dssum, dk, dv, B, D, Dv, fam, st,
                              rep)
              : run_dkv<float>(q, k, v, g, R, dssum, dk, dv, B, D, Dv, fam,
                               st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// What the card makes of each wide bf16 dk/dv instantiation: kernel k (NC
// = k + 1) fills out[4k..4k+3] as occupancy() does (hires_common.cuh).
// Returns a cudaError_t.
extern "C" int hires_dkv_wide_occupancy(int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(hires_dkv_wide_bf16_kernel<1>),
      reinterpret_cast<const void*>(hires_dkv_wide_bf16_kernel<2>),
      reinterpret_cast<const void*>(hires_dkv_wide_bf16_kernel<3>),
      reinterpret_cast<const void*>(hires_dkv_wide_bf16_kernel<4>)};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t err = occupancy(fns[k], kDkvThreads, kDkvWideSmem,
                                      out + 4 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// What the card makes of each wide bf16 dq instantiation at head dims D,
// Dv (at most kTcDqMaxD): kernel k (NQ = k + 1) fills out[4k..4k+3] as
// occupancy() does (hires_common.cuh). Returns a cudaError_t.
extern "C" int hires_dq_wide_occupancy(int D, int Dv, int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(hires_dq_wide_bf16_kernel<1>),
      reinterpret_cast<const void*>(hires_dq_wide_bf16_kernel<2>),
      reinterpret_cast<const void*>(hires_dq_wide_bf16_kernel<3>),
      reinterpret_cast<const void*>(hires_dq_wide_bf16_kernel<4>)};
  if (D < 1 || Dv < 1 || D > kTcDqMaxD || Dv > kTcDqMaxD)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) {
    const cudaError_t err = occupancy(fns[k], kDkvThreads,
                                      dq_wide_smem(D, Dv), out + 4 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// What the card makes of the fp32 CUDA-core dq kernel with cp.async staging
// (NQ = 1-8: kernel k, NQ = k + 1) and of the fp32 dm/ssum kernel (kernel
// 8): out[4k..4k+3] as occupancy() fills them (hires_common.cuh). Returns a
// cudaError_t.
extern "C" int hires_dq_cc_occupancy(int* out) {
  const void* fns[9] = {
      reinterpret_cast<const void*>(hires_dq_kernel<float, 1, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 2, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 3, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 4, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 5, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 6, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 7, true>),
      reinterpret_cast<const void*>(hires_dq_kernel<float, 8, true>),
      reinterpret_cast<const void*>(hires_dm_ssum_kernel<float, true>)};
  for (int k = 0; k < 9; ++k) {
    const cudaError_t err = occupancy(
        fns[k], kThreads, k < 8 ? cc_smem(k + 1) : kDmSsumCcSmem, out + 4 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The fp32 rope attention route's backward (kernels/axial_attention.py::
// _launch_bwd_f32; design notes in csrc/axial_attention_bwd.cu), built on
// this file's CUDA-core stages, after rope_attention_fwd_f32
// (hires_attention.cu) has written the rotated rows, with the mask ssum, a,
// gelu'(h1) and m, and lse and delta. Pointers in the order of enum
// RopeF32Slot (rope_f32.cuh). Launches, on one stream: with the mask the
// dm/ssum kernel and the mask MLP's backward products (mask_bwd_products);
// the dq kernel; with the mask the weight grads (run_weight_grads: the
// products split over fixed row ranges, the ranges summed in order, the
// bias grads' column sums) into the flat dW1 | db1 | dW2 | db2; the dk/dv
// kernel; the un-rotation of dq and dk with the table gradients. Without
// the mask the m and dssum slots are set to zero (cudaMemsetAsync) for the
// dq and dk/dv kernels, which read both. Returns a cudaError_t; sets
// *launched and *smem as hires_attention_dq does.
extern "C" int rope_attention_bwd_f32(void* const* p, int B, int H, int S,
                                      int Dc, int Dr, int Dv, float scale,
                                      int use_mask, void* stream,
                                      int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  auto f = [&](int slot) { return static_cast<float*>(p[slot]); };
  const int D = Dc + Dr, DP = pad4(D);
  const long long rows = (long long)B * S;
  if (B < 1 || H < 1 || S < 1 || Dc < 0 || Dr < 0 || Dr % 2 || D < 1 ||
      Dv < 1 ||
      !(p[rQp] && p[rKp] && p[rV] && p[rG] && p[rLse] && p[rDelta] &&
        p[rM] && p[rDssum] && p[rDq] && p[rDk] && p[rDv]) ||
      (Dc > 0) != (p[rDqc] && p[rDkc]) ||
      (Dr > 0) != (p[rQr] && p[rKr] && p[rCosQ] && p[rSinQ] && p[rCosK] &&
                   p[rSinK] && p[rDqr] && p[rDkr] && p[rTab]) ||
      (use_mask &&
       !(p[rW1] && p[rW2] && p[rSsum] && p[rA] && p[rGp] && p[rDm] &&
         p[rDh1] && p[rWPart] && p[rWGrad])))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const Residuals R{f(rM), f(rLse), f(rDelta), H, S, scale};
  const Family fam = family_of(0, S, DP, Dv);
  const float *qp = f(rQp), *kp = f(rKp), *v = f(rV), *g = f(rG);
  const float* dssum = f(rDssum);
  cudaError_t err = cudaSuccess;
  if (!use_mask) {  // m = 0 and dssum = 0: no mask
    const size_t bytes = sizeof(float) * (size_t)rows * S;
    err = cudaMemsetAsync(f(rM), 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(f(rDssum), 0, bytes, st);
  }
  if (err == cudaSuccess && use_mask) {
    err = dm_ssum<float>(qp, kp, v, g, R, B, DP, Dv, f(rDm), f(rSsum), fam,
                         st, rep);
    if (err == cudaSuccess)
      err = mask_bwd_products<float>(f(rDm), f(rW2), f(rGp), f(rW1),
                                     f(rDh1), f(rDssum), rows, S, false, st,
                                     rep);
  }
  if (err == cudaSuccess)
    err = dq_pass<float>(qp, kp, v, g, R, dssum, B, DP, Dv, f(rDq), fam, st,
                         rep);
  if (err == cudaSuccess && use_mask) {
    // The flat weight grads: dW1 (2S, S) | db1 (2S) | dW2 (S, 2S) | db2 (S).
    float* wg = f(rWGrad);
    const long long sq2 = 2LL * S * S;
    err = run_weight_grads<float>(f(rSsum), f(rDm), f(rA), f(rDh1), wg,
                                  wg + sq2, wg + sq2 + 2 * S,
                                  wg + 2 * sq2 + 2 * S, f(rWPart), rows, S,
                                  split_weight_grads(0, S), st, rep);
  }
  if (err == cudaSuccess)
    err = run_dkv<float>(qp, kp, v, g, R, dssum, f(rDk), f(rDv), B, DP, Dv,
                         fam, st, rep);
  if (err == cudaSuccess) {
    const float* no = nullptr;
    rope_unrotate_f32_kernel<<<dim3((unsigned)((S * D + 255) / 256), 2), 256,
                               0, st>>>(
        UnrotF32{f(rDq), Dr ? f(rQr) : no, f(rCosQ), f(rSinQ), f(rDqc),
                 f(rDqr), f(rTab)},
        UnrotF32{f(rDk), Dr ? f(rKr) : no, f(rCosK), f(rSinK), f(rDkc),
                 f(rDkr), Dr ? f(rTab) + (size_t)2 * S * Dr : nullptr},
        B * H, S, Dc, Dr, DP);
    err = rep.done(0);
  }
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// What the card makes of the fp32 routes' other kernels, out[4k..4k+3] as
// occupancy() fills them: k = 0-2 the rope route's own (rope_f32.cuh: the
// prologue, delta, the un-rotation); k = 3-14 the strided product with
// cp.async staging, each staging (kAK, kBK) = (0, 0), (0, 1), (1, 0), (1,
// 1) at 128 x 128 tiles, then at 64 x 64 tiles, then at 64 x 64 tiles with
// four groups (gemm_cc_staged; hires_attention.cu compiles the same
// template with the same flags); k = 15-17 the dk/dv kernel at CJ = 4, 8,
// 16 with the shared memory of its widest slice (64, 128, 256 columns).
// Returns a cudaError_t.
extern "C" int rope_f32_occupancy(int* out) {
  cudaError_t err = f32_route_occupancy(out);
  out += 4 * kF32RouteKernels;
  auto gemm_at = [&](auto kern, int bm, int ks, size_t dyn) {
    if (err == cudaSuccess)
      err = occupancy(reinterpret_cast<const void*>(kern), ks * bm * bm / 64,
                      dyn, out);
    out += 4;
  };
  constexpr size_t big = gemm_smem<128, 1>(), mid = gemm_smem<64, 1>(),
                   small = gemm_smem<64, 4>();
  gemm_at(gemm_kernel<float, false, false, true, 128, 1>, 128, 1, big);
  gemm_at(gemm_kernel<float, false, true, true, 128, 1>, 128, 1, big);
  gemm_at(gemm_kernel<float, true, false, true, 128, 1>, 128, 1, big);
  gemm_at(gemm_kernel<float, true, true, true, 128, 1>, 128, 1, big);
  gemm_at(gemm_kernel<float, false, false, true, 64, 1>, 64, 1, mid);
  gemm_at(gemm_kernel<float, false, true, true, 64, 1>, 64, 1, mid);
  gemm_at(gemm_kernel<float, true, false, true, 64, 1>, 64, 1, mid);
  gemm_at(gemm_kernel<float, true, true, true, 64, 1>, 64, 1, mid);
  gemm_at(gemm_kernel<float, false, false, true, 64, 4>, 64, 4, small);
  gemm_at(gemm_kernel<float, false, true, true, 64, 4>, 64, 4, small);
  gemm_at(gemm_kernel<float, true, false, true, 64, 4>, 64, 4, small);
  gemm_at(gemm_kernel<float, true, true, true, 64, 4>, 64, 4, small);
  const void* dkv[3] = {
      reinterpret_cast<const void*>(hires_dkv_kernel<float, 4>),
      reinterpret_cast<const void*>(hires_dkv_kernel<float, 8>),
      reinterpret_cast<const void*>(hires_dkv_kernel<float, 16>)};
  for (int k = 0; k < 3 && err == cudaSuccess; ++k)
    err = occupancy(dkv[k], kThreads, tiled_smem(64 << k, 2), out + 4 * k);
  return (int)err;
}
