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
//   * past 256 columns of D or Dv, the wide bf16 kernel
//     (hires_attention_wide_bf16_kernel): the same CTA and one pass, with
//     o's columns split over the grid (blockIdx.x = head * ns + slice, ns =
//     ceil(Dv / 256) equal slices of 16-column multiples) and each slice
//     recomputing q k^T. A warp's fp32 accumulators for 16 rows x all of Dv
//     would be 256 registers a thread at Dv = 512; a slice keeps them at
//     most 128, as at Dv = 256. Splitting over the grid was chosen over two
//     warps per 16 rows (each owning half of Dv, p handed over through
//     shared memory): it reuses this kernel's pipeline unchanged, needs no
//     exchange or extra barrier per key tile, and takes any Dv; it costs
//     1.5x the products at D = Dv with two slices. Every slice runs the same
//     chunk order, so the scores and the rounded p are the same bits in
//     each and o's slices agree; slice 0 writes lse. q stays resident, so
//     D is bounded by shared memory: D <= kTcFwdMaxD = 1520 (103,424 bytes
//     a CTA at D = 512, two CTAs an SM);
//   * the CUDA-core attention kernel (hires_attention_kernel), which runs
//     every fp32 call and every bf16 call the tensor-core kernels do not
//     take, every product an fp32 FMA (TF32 would not be fp32). Bound on
//     the H100 by its fp32 operations, 67 TFLOP/s outside the tensor cores
//     (19.701 ms of bound per fifteen six-head layers at B=8 with the mask
//     MLP, PERF.md §6), so the design forms each product once and keeps the
//     FMA pipes fed: it is built on the product core of hires_common.cuh
//     (a copy in flight while a chunk is multiplied, at least 8 FMAs per
//     shared load): one CTA of 8 warps per (64 query
//     rows, head, batch element) and one pass with the online softmax
//     above, over 128-key tiles whose scores are formed once for all of
//     o's columns up to kOutSlice = 512: each thread owns 4 rows x 8 keys
//     of the score tile and 4 rows x 4 NV columns of o (NV = 64-column
//     groups, 128 accumulators at Dv = 512), p crosses to the output's
//     threads through a [64][132] tile in shared memory, and the (q, k)
//     score chunks (32 columns) and v chunks (16 keys) stream through a
//     three-stage ring, cp.async where fp32 rows are 16-byte aligned,
//     registers otherwise (132,864 bytes a CTA at Dv 512). In bf16 p is rounded before its normalisation,
//     as the tensor-core kernel rounds it. It takes any D and Dv: past 512
//     columns of o the grid splits them, each CTA recomputing the scores.
// The tensor-core kernels take bf16 S, D and Dv that are multiples of 8
// (16-byte rows), the D, Dv <= 256 kernel and the wide one past that up to
// D = kTcFwdMaxD (family_of, hires_common.cuh); the C entry takes any
// shape.

#include "hires_mma.cuh"
#include "rope_f32.cuh"

namespace {

// The CUDA-core attention kernel: one CTA per (64 query rows, head and
// output slice, batch element), grid (H * ns, ceil(S / 64), B) with the
// heads fastest, so the H CTAs that read the same rows of m run together.
// Per 128-key tile its ring carries the (q, k) score chunks, then the
// tile's v chunks (kVK keys x the slice's columns); one pass with an
// online softmax: the scores get scale and m, each row's running max and
// sum of exp move, o is rescaled by exp(old max - new max), and p = exp(
// logit - running max), rounded to T, goes to the score tile for o += p v.
// o is divided by the row's sum at the end; slice 0 writes lse = max +
// log(sum) where lse is not null.
template <typename T, int NV, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) hires_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ m, T* __restrict__ o, float* __restrict__ lse,
    int H, int S, int D, int Dv, int ns, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sP = smem;                            // [64][kLdS] p, rounded
  const int z = blockIdx.x % ns;
  const int b = blockIdx.z, q0 = blockIdx.y * kSQ;
  const size_t bh = (size_t)b * H + blockIdx.x / ns;
  const int c0 = z * kOutSlice, W = min(kOutSlice, Dv - c0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qh = q + (bh * S + q0) * D;
  const T* kh = k + bh * S * D;
  const T* vh = v + bh * S * Dv + c0;
  const int nkc = (D + kKC - 1) / kKC, nkt = (S + kSK - 1) / kSK;
  const int per = nkc + kSK / kVK;
  auto plan = [&](int at, float* st, Block<T>& a, Block<T>& bb) {
    int t, c;
    tile_of(at, per, nkt, t, c);
    const int t0 = t * kSK;
    if (c < nkc) {
      const int d0 = c * kKC;
      a = {qh + d0, D, kSQ, kKC, S - q0, D - d0, st, kLdK};
      bb = {kh + (size_t)t0 * D + d0, D, kSK, kKC, S - t0, D - d0,
            st + kSQ * kLdK, kLdK};
    } else {
      const int r0 = t0 + (c - nkc) * kVK;
      a = {vh + (size_t)r0 * Dv, Dv, kVK, 64 * NV, S - r0, W, st, out_ld(NV)};
    }
  };
  Ring<T, kAsync, kThreads, cc_stage(NV) / kThreads, decltype(plan)> ring(
      plan, smem + kSQ * kLdS, cc_stage(NV),
      (nkt - 1) * per + nkc + out_chunks(S, nkt - 1));

  float mx[4], se[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -INFINITY, se[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  }
  for (int t = 0; t < nkt; ++t) {
    const int t0 = t * kSK;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nkc; ++c) score_chunk(s, ring.next());
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      const float* mr = m && r < S ? m + ((size_t)b * S + r) * S : nullptr;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = t0 + tx + 16 * j;
        s[i][j] = key < S ? s[i][j] * scale + (mr ? mr[key] : 0.f)
                          : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float nmx = fmaxf(mx[i], row_max16(tmax));
      const float alpha = expf(mx[i] - nmx);   // 0 at the first tile
      mx[i] = nmx;
      se[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - nmx);
        se[i] += p;
        sP[(ty * 4 + i) * kLdS + tx + 16 * j] = rnd<T>(p);
      }
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
    }
    // (the first output chunk's barrier: p is in the score tile)
    const int nvc = out_chunks(S, t);
    for (int c = 0; c < nvc; ++c)
      out_chunk<NV>(acc, sP, c * kVK, ring.next());
  }
  ring.finish();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const float sum = row_sum16(se[i]);
    const float inv = 1.f / sum;
    if (lse && z == 0 && tx == 0 && r < S) lse[bh * S + r] = mx[i] + logf(sum);
    if (r >= S) continue;
    T* orow = o + (bh * S + r) * Dv + c0;
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 64 * u + e;
        if (c < W) orow[c] = from_f<T>(acc[i][4 * u + e] * inv);
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

// The widest D at which the bf16 CTA (the resident q tile and the ring,
// attention_bf16_smem) fits in a CTA's shared memory.
static_assert(2 * (kAttnRows * (kTcFwdMaxD + 8) + kRingStages * kChunkElems) <=
                      kMaxCtaSmem &&
                  2 * (kAttnRows * (kTcFwdMaxD + 16 + 8) +
                       kRingStages * kChunkElems) > kMaxCtaSmem,
              "kTcFwdMaxD is the widest D whose CTA fits");

// The wide bf16 attention kernel: hires_attention_bf16_kernel for D or Dv
// past kSlice. CTA (blockIdx.x = head * ns + z, query tile, batch
// element) owns columns [c0, c0 + W) of o, slice z of split_cols(Dv, ns):
// it streams every k chunk (any D: the q tile stays resident) and only
// its slice's v chunks, so the accumulators stay at most 256 columns (128
// registers a thread). Every slice forms the same scores and rounds the
// same p, so o's slices agree with one another; slice 0 writes lse.
template <int NV, bool kResiduals>
__global__ void __launch_bounds__(kAttnThreads)
    hires_attention_wide_bf16_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const float* __restrict__ m,
        bf16* __restrict__ o, float* __restrict__ lse, int H, int S, int D,
        int Dv, int ns, float scale) {
  using namespace tcore;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = pad16(D) + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sQ + kAttnRows * ldq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.x % ns;
  const int b = blockIdx.z, q0 = blockIdx.y * kAttnRows;
  const size_t bh = (size_t)b * H + blockIdx.x / ns;
  const int cw = split_cols(Dv, ns), c0 = z * cw, W = min(cw, Dv - c0);
  const bf16* kh = k + bh * S * D;
  const bf16* vh = v + bh * S * Dv;
  const int nkt = (S + kAttnRows - 1) / kAttnRows;
  const int nkc = chunks_of(D), nvc = chunks_of(W);
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
  // The ring, as in hires_attention_bf16_kernel: per key tile its k
  // chunks, then the v chunks of this slice's columns.
  const int per = nkc + nvc, n_chunks = nkt * per;
  auto prefetch = [&](int at) {
    if (at < n_chunks) {
      const int j = at / per, c = at - j * per;
      bf16* dst = ring + (at % kRingStages) * kChunkElems;
      if (c < nkc)
        copy_chunk(dst, kh + (size_t)j * kAttnRows * D, D,
                   S - j * kAttnRows, c);
      else
        copy_rows(dst, kChunkLd, vh + (size_t)j * kAttnRows * Dv, Dv,
                  S - j * kAttnRows, c0 + (c - nkc) * kChunkCols, c0 + W,
                  kChunkCols);
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

  // The online softmax of hires_attention_bf16_kernel.
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
      if (u < nvc) probs_by_chunk(acc, u, pa, next(), chunk_steps(W, u), lane);
  }
  cp_wait<0>();
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float sum = quad_sum(se[hf]);
    inv[hf] = 1.f / sum;
    if (kResiduals && z == 0 && t == 0 && rows[hf] < S)
      lse[bh * S + rows[hf]] = mx[hf] + logf(sum);
  }

  bf16* oh = o + bh * S * Dv + c0;
#pragma unroll
  for (int n = 0; n < NV * kChunkN; ++n) {
    const int d = n * 8 + 2 * t;
    if (d < W) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (rows[hf] < S)
          *reinterpret_cast<uint32_t*>(oh + (size_t)rows[hf] * Dv + d) =
              pack(acc[n][2 * hf] * inv[hf], acc[n][2 * hf + 1] * inv[hf]);
    }
  }
}

template <int NV, bool kResiduals>
cudaError_t launch_attention_wide_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const float* m,
                                       bf16* o, float* lse, int B, int H,
                                       int S, int D, int Dv, int ns,
                                       float scale, cudaStream_t st,
                                       Report& rep) {
  auto kern = hires_attention_wide_bf16_kernel<NV, kResiduals>;
  const size_t smem = attention_bf16_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H * ns, (S + kAttnRows - 1) / kAttnRows, B);
  kern<<<grid, kAttnThreads, smem, st>>>(q, k, v, m, o, lse, H, S, D, Dv, ns,
                                         scale);
  return rep.done(smem);
}

// o in slices_of(Dv) slices of split_cols(Dv, ns) columns; NV = the
// chunks of the widest slice, at least 2 (at NV = 1 ptxas held the kernel
// to 128 registers and spilled 4-8 bytes; NV = 2 takes a one-chunk slice
// with its second chunk's products skipped).
template <bool kResiduals>
cudaError_t attention_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const float* m, bf16* o, float* lse, int B,
                                int H, int S, int D, int Dv, float scale,
                                cudaStream_t st, Report& rep) {
  const int ns = slices_of(Dv);
  switch (chunks_of(split_cols(Dv, ns))) {
    case 1:
    case 2:
      return launch_attention_wide_bf16<2, kResiduals>(
          q, k, v, m, o, lse, B, H, S, D, Dv, ns, scale, st, rep);
    case 3:
      return launch_attention_wide_bf16<3, kResiduals>(
          q, k, v, m, o, lse, B, H, S, D, Dv, ns, scale, st, rep);
    default:
      return launch_attention_wide_bf16<4, kResiduals>(
          q, k, v, m, o, lse, B, H, S, D, Dv, ns, scale, st, rep);
  }
}

template <typename T, int NV, bool kAsync>
cudaError_t launch_attention(const T* q, const T* k, const T* v,
                             const float* m, T* o, float* lse, int B, int H,
                             int S, int D, int Dv, float scale,
                             cudaStream_t st, Report& rep) {
  auto kern = hires_attention_kernel<T, NV, kAsync>;
  constexpr size_t smem = cc_smem(NV);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ns = out_slices(Dv);
  const dim3 grid(H * ns, (S + kSQ - 1) / kSQ, B);
  kern<<<grid, kThreads, smem, st>>>(q, k, v, m, o, lse, H, S, D, Dv, ns,
                                     scale);
  return rep.done(smem);
}

// NV = the 64-column groups of o's widest slice (with_nv).
template <typename T, bool kAsync>
cudaError_t attention_cuda_cores(const T* q, const T* k, const T* v,
                                 const float* m, T* o, float* lse, int B,
                                 int H, int S, int D, int Dv, float scale,
                                 cudaStream_t st, Report& rep) {
  return with_nv<kAsync>(nv_of(Dv), [&](auto nv) {
    return launch_attention<T, decltype(nv)::value, kAsync>(
        q, k, v, m, o, lse, B, H, S, D, Dv, scale, st, rep);
  });
}

// The attention pass: bf16 on the tensor cores where the family allows
// (tc: the wide kernel past kSlice), every other call on the CUDA-core
// kernel, with cp.async staging where q, k and v are fp32 rows of 16 bytes.
template <typename T, bool kResiduals>
cudaError_t attention(const T* q, const T* k, const T* v, const float* m,
                      T* o, float* lse, int B, int H, int S, int D, int Dv,
                      float scale, bool tc, cudaStream_t st, Report& rep) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc && D <= kSlice && Dv <= kSlice)
      return attention_bf16<kResiduals>(q, k, v, m, o, lse, B, H, S, D, Dv,
                                        scale, st, rep);
    if (tc)
      return attention_wide_bf16<kResiduals>(q, k, v, m, o, lse, B, H, S, D,
                                             Dv, scale, st, rep);
    return attention_cuda_cores<T, false>(q, k, v, m, o, lse, B, H, S, D,
                                          Dv, scale, st, rep);
  } else {
    if (rows16<T>(q, D, D, D, D) && rows16<T>(k, D, D, D, D) &&
        rows16<T>(v, Dv, Dv, Dv, Dv))
      return attention_cuda_cores<T, true>(q, k, v, m, o, lse, B, H, S, D,
                                           Dv, scale, st, rep);
    return attention_cuda_cores<T, false>(q, k, v, m, o, lse, B, H, S, D,
                                          Dv, scale, st, rep);
  }
}

template <typename T>
cudaError_t run(int residuals, int use_mask, const void* q, const void* k,
                const void* v, const void* w1t, const float* b1,
                const void* w2t, const float* b2, void* ssum, void* a,
                float* m, void* o, float* lse, int B, int H, int S, int D,
                int Dv, float scale, Family fam, cudaStream_t st,
                Report& rep) {
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
    if ((err = gemm<T>(g, B, fam.aligned, st, rep)) != cudaSuccess)
      return err;
    // a = round(gelu(ssum W1^T + b1)) over all B*S rows.
    g = Gemm{};
    g.A = ssum; g.B = w1t; g.C = a; g.bias = b1; g.epilogue = kGelu;
    g.M = (int)R; g.N = (int)S2; g.K = S; g.KO = 1;
    g.sAm = S; g.sAk = 1; g.sBk = S2; g.sBn = 1; g.ldc = S2;
    if ((err = gemm<T>(g, 1, fam.aligned, st, rep)) != cudaSuccess)
      return err;
    // m = a W2^T + b2, fp32.
    g = Gemm{};
    g.A = a; g.B = w2t; g.C = m; g.bias = b2; g.epilogue = kStoreF32;
    g.M = (int)R; g.N = S; g.K = (int)S2; g.KO = 1;
    g.sAm = S2; g.sAk = 1; g.sBk = S; g.sBn = 1; g.ldc = S;
    if ((err = gemm<T>(g, 1, fam.aligned, st, rep)) != cudaSuccess)
      return err;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* mm = use_mask ? m : nullptr;
  if (residuals)
    return attention<T, true>(qt, kt, vt, mm, static_cast<T*>(o), lse, B, H,
                              S, D, Dv, scale, fam.tc_fwd, st, rep);
  return attention<T, false>(qt, kt, vt, mm, static_cast<T*>(o), nullptr, B,
                             H, S, D, Dv, scale, fam.tc_fwd, st, rep);
}

}  // namespace

// Returns a cudaError_t (0 on success). q, k (B,H,S,D), v and o (B,H,S,Dv)
// in the compute type; w1t (S,2S) and w2t (2S,S) in the compute type, b1
// (2S) and b2 (S) fp32; scratch ssum (B,S,S) and a (B,S,2S) in the compute
// type; m (B,S,S) fp32 (an output when residuals is 1); lse (B,H,S) fp32,
// written when residuals is 1. With use_mask 0 the weights, ssum, a and m
// may be null (and residuals must be 0). All contiguous. Takes any S, D and
// Dv; family_of(is_bf16, S, D, Dv) picks the kernels. Sets *launched to
// the number of kernels the call launched and *smem to the largest dynamic
// shared memory (bytes) one of their CTAs asked for.
extern "C" int hires_attention_fwd(
    int is_bf16, int residuals, int use_mask, const void* q, const void* k,
    const void* v, const void* w1t, const float* b1, const void* w2t,
    const float* b2, void* ssum, void* a, float* m, void* o, float* lse,
    int B, int H, int S, int D, int Dv, float scale, void* stream,
    int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  if (B < 1 || H < 1 || S < 1 || D < 1 || Dv < 1 ||
      (residuals && (!use_mask || !lse)) ||
      (use_mask && (!w1t || !b1 || !w2t || !b2 || !ssum || !a || !m)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Family fam = family_of(is_bf16, S, D, Dv);
  Report rep;
  const cudaError_t err =
      is_bf16 ? run<bf16>(residuals, use_mask, q, k, v, w1t, b1, w2t, b2,
                          ssum, a, m, o, lse, B, H, S, D, Dv, scale, fam, st,
                          rep)
              : run<float>(residuals, use_mask, q, k, v, w1t, b1, w2t, b2,
                           ssum, a, m, o, lse, B, H, S, D, Dv, scale, fam,
                           st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// The strided product alone on the CUDA cores (gemm_kernel,
// hires_common.cuh), for its card test: C[z] = epilogue(sum_{o < KO} sum_{k
// < K} A(z, o, m, k) B(z, o, k, n)) for z < Z, A and B in the compute type,
// C in it too (fp32 for epilogue kStoreF32), C2 fp32, bias (N) fp32 or
// null. strides: sAz, sAo, sAm, sAk, sBz, sBo, sBk, sBn, sCz, ldc
// (elements). Returns a cudaError_t; sets *launched and *smem as
// hires_attention_fwd does.
extern "C" int hires_strided_product(int is_bf16, int epilogue, const void* A,
                                     const void* B, void* C, float* C2,
                                     const float* bias, int M, int N, int K,
                                     int KO, int Z, const long long* strides,
                                     void* stream, int* launched,
                                     long long* smem) {
  *launched = 0;
  *smem = 0;
  if (M < 1 || N < 1 || K < 1 || KO < 1 || Z < 1 || epilogue < kStoreF32 ||
      epilogue > kDgeluMul || ((epilogue == kDgeluMul) && !C2))
    return (int)cudaErrorInvalidValue;
  Gemm g = {};
  g.A = A; g.B = B; g.C = C; g.C2 = C2; g.bias = bias;
  g.M = M; g.N = N; g.K = K; g.KO = KO; g.epilogue = epilogue;
  g.sAz = strides[0]; g.sAo = strides[1]; g.sAm = strides[2];
  g.sAk = strides[3]; g.sBz = strides[4]; g.sBo = strides[5];
  g.sBk = strides[6]; g.sBn = strides[7]; g.sCz = strides[8];
  g.ldc = strides[9];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const cudaError_t err = is_bf16 ? gemm_cuda_cores<bf16>(g, Z, st, rep)
                                  : gemm_cuda_cores<float>(g, Z, st, rep);
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}

// What the card makes of each wide bf16 attention instantiation at head dim
// D: kernel k = 2 (NV - 2) + residuals (NV = 2-4) fills out[4k..4k+3] as
// occupancy() does (hires_common.cuh). Returns a cudaError_t.
extern "C" int hires_attention_wide_occupancy(int D, int* out) {
  const void* fns[6] = {
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<2, false>),
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<2, true>),
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<3, false>),
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<3, true>),
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<4, false>),
      reinterpret_cast<const void*>(hires_attention_wide_bf16_kernel<4, true>)};
  if (D < 1 || D > kTcFwdMaxD) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 6; ++k) {
    const cudaError_t err = occupancy(fns[k], kAttnThreads,
                                      attention_bf16_smem(D), out + 4 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// What the card makes of the fp32 CUDA-core attention kernel with cp.async
// staging (the fp32 route's), NV = 1-8: kernel k (NV = k + 1) fills
// out[4k..4k+3] as occupancy() does (hires_common.cuh). Returns a
// cudaError_t.
extern "C" int hires_attention_cc_occupancy(int* out) {
  const void* fns[8] = {
      reinterpret_cast<const void*>(hires_attention_kernel<float, 1, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 2, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 3, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 4, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 5, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 6, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 7, true>),
      reinterpret_cast<const void*>(hires_attention_kernel<float, 8, true>)};
  for (int k = 0; k < 8; ++k) {
    const cudaError_t err =
        occupancy(fns[k], kThreads, cc_smem(k + 1), out + 4 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The fp32 rope attention route (kernels/axial_attention.py::_launch_f32;
// the function of csrc/axial_attention.cu in fp32, design notes there),
// built on this file's CUDA-core kernels. Pointers in the order of enum
// RopeF32Slot (rope_f32.cuh): the inputs, out, the scratch qp and kp, with
// the mask ssum, a and m (and gp: gelu'(h1), if not null), and for the
// backward lse, g and delta (delta = rowsum(g * o) is written when its
// slot is not null, o being `out`). Launches, on one stream: the prologue
// (q and k rotated once into rows of DP = pad4(D) floats; zero columns add
// nothing to a score), with the mask the strided products ssum = sum_h q_h
// k_h^T (the heads the outer contraction), a = gelu(ssum W1^T + b1) (and
// gelu'(h1)) and m = a W2^T + b2 over the B*S rows (W1 and W2 read as they
// lie, no transposed copy), then the attention kernel on the (query tile,
// head, batch) grid, with lse where its slot is not null, and delta.
// Returns a cudaError_t; sets *launched and *smem as hires_attention_fwd
// does.
extern "C" int rope_attention_fwd_f32(void* const* p, int B, int H, int S,
                                      int Dc, int Dr, int Dv, float scale,
                                      int use_mask, void* stream,
                                      int* launched, long long* smem) {
  *launched = 0;
  *smem = 0;
  auto f = [&](int slot) { return static_cast<float*>(p[slot]); };
  const int D = Dc + Dr, DP = pad4(D);
  if (B < 1 || H < 1 || S < 1 || Dc < 0 || Dr < 0 || Dr % 2 || D < 1 ||
      Dv < 1 || !p[rV] || !p[rOut] || !p[rQp] || !p[rKp] ||
      (Dc > 0) != (p[rQc] && p[rKc]) ||
      (Dr > 0) != (p[rQr] && p[rKr] && p[rCosQ] && p[rSinQ] && p[rCosK] &&
                   p[rSinK]) ||
      (use_mask && !(p[rW1] && p[rB1] && p[rW2] && p[rB2] && p[rSsum] &&
                     p[rA] && p[rM])) ||
      (p[rDelta] && !(p[rG] && p[rLse])))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Report rep;
  const size_t rows = (size_t)B * H * S;
  rope_prep_f32_kernel<<<dim3((unsigned)((rows * DP + 255) / 256), 2), 256,
                         0, st>>>(
      PrepF32{f(rQc), f(rQr), f(rCosQ), f(rSinQ), f(rQp)},
      PrepF32{f(rKc), f(rKr), f(rCosK), f(rSinK), f(rKp)}, rows, S, Dc, Dr,
      DP);
  cudaError_t err = rep.done(0);
  if (err == cudaSuccess && use_mask) {
    const long long S2 = 2LL * S, R = (long long)B * S;
    Gemm g = {};
    // ssum[b] = sum_h q_h k_h^T.
    g.A = f(rQp); g.B = f(rKp); g.C = f(rSsum); g.epilogue = kStoreT;
    g.M = S; g.N = S; g.K = DP; g.KO = H;
    g.sAz = (long long)H * S * DP; g.sAo = (long long)S * DP; g.sAm = DP;
    g.sAk = 1;
    g.sBz = g.sAz; g.sBo = g.sAo; g.sBk = 1; g.sBn = DP;
    g.sCz = (long long)S * S; g.ldc = S;
    err = gemm<float>(g, B, false, st, rep);
    if (err == cudaSuccess) {
      // a = gelu(h1), gp = gelu'(h1), h1 = ssum W1^T + b1; W1 (2S, S).
      g = Gemm{};
      g.A = f(rSsum); g.B = f(rW1); g.C = f(rA); g.C2 = f(rGp);
      g.bias = f(rB1); g.epilogue = kGelu;
      g.M = (int)R; g.N = (int)S2; g.K = S; g.KO = 1;
      g.sAm = S; g.sAk = 1; g.sBk = 1; g.sBn = S; g.ldc = S2;
      err = gemm<float>(g, 1, false, st, rep);
    }
    if (err == cudaSuccess) {
      // m = a W2^T + b2; W2 (S, 2S).
      g = Gemm{};
      g.A = f(rA); g.B = f(rW2); g.C = f(rM); g.bias = f(rB2);
      g.epilogue = kStoreF32;
      g.M = (int)R; g.N = S; g.K = (int)S2; g.KO = 1;
      g.sAm = S2; g.sAk = 1; g.sBk = 1; g.sBn = S2; g.ldc = S;
      err = gemm<float>(g, 1, false, st, rep);
    }
  }
  if (err == cudaSuccess) {
    const float* m = use_mask ? f(rM) : nullptr;
    err = p[rLse] ? attention<float, true>(f(rQp), f(rKp), f(rV), m,
                                           f(rOut), f(rLse), B, H, S, DP, Dv,
                                           scale, false, st, rep)
                  : attention<float, false>(f(rQp), f(rKp), f(rV), m,
                                            f(rOut), nullptr, B, H, S, DP,
                                            Dv, scale, false, st, rep);
  }
  if (err == cudaSuccess && p[rDelta]) {
    rope_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
        f(rG), f(rOut), f(rDelta), rows, Dv);
    err = rep.done(0);
  }
  *launched = rep.launched;
  *smem = (long long)rep.smem;
  return (int)err;
}
