// Fused axial attention with in-kernel RoPE and the learned additive mask,
// forward only, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces: the Pallas TPU kernel built by
//   calm_vit_dte_tpu/kernels/axial_attention.py::_make_rope_fused (forward
//   pallas_call at :682), body _make_rope_kernels.fwd_kernel -> _fwd_body
//   (:249) and _mask_fwd (:237); as its Dr == 0 case ::_make_fused (:530).
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
// Two routes compute the function:
//   * bf16 (the training and serving route): rope_attention_fwd_bf16_kernel
//     below, every product on the tensor cores (mma.sync.m16n8k16, bf16 in,
//     fp32 accumulate; building blocks in mma_common.cuh and rope_mma.cuh);
//   * fp32 (the card-vs-CPU parity checks, the DP/TP steps held to fp32
//     limits, fp32 training): every product an fp32 FMA on the CUDA cores,
//     on the hires sources' CUDA-core kernels (see "fp32 route" below).
//
// What bounds it on the H100: at the flagship's widest shape (B=128, H=12,
// S=224, D=Dv=56, bf16) the function needs 2*B*H*S^2*(D+Dv) + 4*B*S^2*2S =
// 28.8 GFLOP (29 us at 989 TFLOP/s) and moves 154 MB of q, k, v and output
// (46 us at 3.35 TB/s): the bound is bytes. 89% of the forward's work in the
// JAX kernel's count is the mask MLP, (64,S)(S,2S) then (64,2S)(2S,S) per
// query tile: products that want tensor cores, not the CUDA cores the
// earlier kernels used. The bf16 kernel does about 41 GFLOP at that shape
// (D and Dv padded to 64, q k^T computed twice: once for ssum, once for the
// scores) in exchange for keeping every intermediate on chip.
//
// bf16 kernel design:
//   * grid (ceil(S/64), B): one CTA of 4 warps per 64 query rows; each warp
//     owns 16 rows and the whole key axis (S <= 256 keys, so the mask MLP,
//     which contracts over all keys, needs no online softmax). The scores
//     of a head live in registers: S/2 fp32 per thread;
//   * a prologue kernel (rope_prep_kernel, rope_mma.cuh) writes q and k
//     rotated and rounded (the plain version's bf16 rotation) and v, each
//     zero-padded to rows of pad16(D) or pad16(Dv) elements, once per call:
//     every tile load after it is a 16-byte cp.async, and no CTA rotates a
//     row (each k_h was rotated by every CTA of its batch element in both
//     passes before);
//   * shared memory holds bf16 operands, never fp32 tiles of them: the K_h
//     and V_h tiles, the fp32 mask m [64][S+8] (the one fp32 tile: it is
//     added to every head's logits), and, while the MLP runs, the bf16 ssum
//     tile (in m's place) and two cp.async stages of W1 rows / W2 columns,
//     16 hidden units each. Rows are padded by 8 elements, so ldmatrix
//     reads are free of bank conflicts. Each warp reads its q_h rows as A
//     fragments straight from global memory;
//   * the tile copies overlap the products: in pass 1 the K tiles of
//     consecutive heads alternate between the K buffer and the m region
//     (free until the MLP), so head h+1's cp.async runs while head h's
//     q k^T does. In pass 2, where a V tile beside the K tile still lets
//     two CTAs share an SM (FwdSmem::kv_stages 2: every shape with S <=
//     208, and every shape without the mask), V_h is copied while the
//     scores and the softmax run and K_{h+1} while P V runs. At S = 224
//     and 256 with the mask the second tile would leave one CTA per SM,
//     and the kernel keeps one buffer for K and V (each copy then waits):
//     two resident CTAs, whose waits the other CTA's products fill, were
//     kept over one CTA with its copies in flight;
//   * the wrapper rounds W1 and W2 to bf16 once per launch (round to nearest
//     even, as rnd<bf16>) and zero-pads them; the MLP streams them through
//     the stages while the previous chunk computes. h1 stays in the
//     accumulators; its GELU output becomes the A fragment of the W2 product
//     in registers, and m accumulates in registers until it goes to shared
//     memory with b2;
//   * the softmax stays in fp32, with e^x on the SFU (__expf, ex2.approx:
//     relative error below 1e-5 at any logit gap, far below p's bf16
//     rounding) and one reciprocal of the row sum per row in place of a
//     division per score: at 2 warps per scheduler the per-score fp32 work,
//     not the tile copies, is what holds the kernel back (PERF.md §6);
//   * P V takes P from the score registers as bf16 A fragments (the C
//     layout of two 8-key tiles is the A layout of one 16-key step);
//   * keys and rows past S are zero rows, and the keys are masked out of
//     the softmax, so any S <= 256 works (S padded to 16); D and Dv are
//     zero-padded to 16, which is exact.
// Shared memory and residency (FwdSmem; ptxas, sm_90a, nvcc 12.9: 255
// registers at S > 160, spilling 8 bytes at S = 193-224 and 16 above; 231-
// 237 at S = 97-160 and 136-203 below; chip_smoke.py phase 2 prints them):
//   forward at (S, D, Dv) = (224, 56, 56): 95744 bytes, 2 CTAs per SM, 1 K/V stage
//   forward at (S, D, Dv) = (176, 44, 44): 86528 bytes, 2 CTAs per SM, 2 K/V stages
//   forward at (S, D, Dv) = (256, 64, 64): 109056 bytes, 2 CTAs per SM, 1 K/V stage
// so 8 warps are resident per SM at every flagship and imagenet-cls-256
// shape (2 CTAs of 4, held there by registers: 2 x 128 x 255 of the SM's
// 65536). More resident warps need fewer registers per thread, which the
// scores (S/2 fp32 per thread) rule out at S > 160.
//
// fp32 route design. The first design (one CTA of 8 warps per 32 query
// rows and batch element, the heads walked in a loop, the mask MLP's
// weights streamed from L2 by every warp for its 4 rows, q and k rotated
// again for every head of every pass) took 13.913 ms per flagship forward
// at B=8 on an H100 (1.44% of its 0.1997 ms fp32 bound, PERF.md §6): 56
// CTAs at S = 224, one shared-memory load per 4 FMAs. The function is the
// hires function (hires_attention.cu) on rotated q and k, and S <= 256,
// D <= 64 sit inside what the hires CUDA-core kernels take, so the route's
// C entry, rope_attention_fwd_f32, sits in hires_attention.cu beside the
// kernels it launches (one call, no transposed weights), and launches:
//   1. rope_prep_f32_kernel (rope_f32.cuh): q and k rotated once per call,
//      as the plain version rounds it (x cos + rot(x) sin, each product and
//      the sum rounded to fp32), into rows of pad4(D) floats, zero-padded,
//      so every later tile moves by 16-byte cp.async and nothing is rotated
//      per head or per pass (zero columns add nothing to a score);
//   2. with the mask, three strided products over the B*S rows (gemm_kernel,
//      hires_common.cuh; on these small grids 64 x 64 tiles of 256 threads
//      in four groups that split each 32-deep chunk): ssum = sum_h q_h k_h^T
//      with the heads as the outer contraction, h1 -> a through the GELU
//      epilogue and m = a W2^T + b2, W1 and W2 read as they lie; the weights
//      pass through shared memory once per 64-row tile, not once per 4 rows;
//   3. the CUDA-core attention kernel (hires_attention_kernel) on a grid
//      over (query tile of 64, head, batch element): 4 x 8 score tiles a
//      thread, an online softmax over 128-key tiles (at S <= 256 one or
//      two), o += p v from a three-stage cp.async ring (16-byte fp32 rows)
//      or through registers (rows off the multiple of 4: odd Dv).
// So a flagship forward at B = 8 runs 384 attention CTAs at S = 224
// (first design: 56). The call launches 2 kernels without the mask, 5 with
// it (the wrapper adds the 4 past the counted one to `.stage_launches`).
// The attention CTA's shared memory (cc_smem, hires_common.cuh: the score
// tile and three ring stages; the strided products' CTAs ask for less;
// CTAs per SM by shared memory, kernels/axial_attention.py::f32_smem_bytes):
//   f32_forward at (S, D, Dv) = (224, 56, 56): 116736 bytes, 1 CTA per SM
//   f32_forward at (S, D, Dv) = (176, 44, 44): 116736 bytes, 1 CTA per SM
//   f32_forward at (S, D, Dv) = (256, 64, 64): 116736 bytes, 1 CTA per SM

#include "attention_common.cuh"
#include "rope_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: every product is mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). Grid (ceil(S/64), B), 4 warps of 16 query rows each.
//   1. ssum = sum_h q_h k_h^T accumulates in registers over the heads (the
//      K_h tiles by cp.async through two stages, U and the M region; the
//      warp's q_h rows as A fragments from global memory), is rounded to
//      bf16 into the M region;
//   2. the mask MLP streams W1 / W2 (bf16) in chunks of 16 hidden units
//      through two cp.async stages; h1 stays in registers, its GELU output
//      becomes the A operand of a W2^T in registers; m accumulates in
//      registers and goes to the M region in fp32 with b2;
//   3. per head: scores q_h k_h^T in registers (S/2 fp32 per thread), fp32
//      softmax with the mask added from M (quad shuffles for the row max and
//      sum; __expf and the row sum's reciprocal), then P V with P taken from
//      the score registers as bf16 A
//      fragments; v_h has its own stage where two CTAs still fit
//      (FwdSmem::kv_stages), and otherwise reuses the buffer k_h used.
template <int NC>
__global__ void __launch_bounds__(tcore::kThreads4, 2)
rope_attention_fwd_bf16_kernel(
    const tcore::bf16* __restrict__ qp, const tcore::bf16* __restrict__ kp,
    const tcore::bf16* __restrict__ vp, const tcore::bf16* __restrict__ w1,
    const float* __restrict__ b1, const tcore::bf16* __restrict__ w2,
    const float* __restrict__ b2, tcore::bf16* __restrict__ out, int H,
    int S, int D, int Dv, float scale, int use_mask) {
  using namespace tcore;
  constexpr int NT = 4 * NC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FwdSmem L(S, D, Dv, use_mask != 0);
  const int SP = pad16(S), H2P = pad16(2 * S);
  const int nk16 = SP / 16;
  const int DP = pad16(D), DVP = pad16(Dv);
  const int ldq = DP + 8, ldv = DVP + 8;
  const int nd = DP / 16, nv = DVP / 16;
  float* Ms = reinterpret_cast<float*>(smem_raw + L.m);
  bf16* X = reinterpret_cast<bf16*>(smem_raw + L.m);
  bf16* U = reinterpret_cast<bf16*>(smem_raw + L.u);
  bf16* V = reinterpret_cast<bf16*>(smem_raw + L.v);  // U with one stage
  const bool two = L.kv_stages == 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRowsCta;
  const int r0 = q0 + warp * 16;  // the warp's first row
  const size_t bh0 = (size_t)b * H;
  auto load_q = [&](uint32_t (&qf)[4][4], int h) {
    global_frags(qf, qp + ((bh0 + h) * S + r0) * DP, DP, S - r0, nd, lane);
  };
  auto load_k = [&](bf16* dst, int h) {
    copy_tile(dst, ldq, kp + (bh0 + h) * S * DP, DP, SP, S, 0, DP, tid,
              kThreads4);
    cp_commit();
  };
  auto load_v = [&](int h) {
    copy_tile(V, ldv, vp + (bh0 + h) * S * DVP, DVP, SP, S, 0, DVP, tid,
              kThreads4);
    cp_commit();
  };

  if (use_mask) {
    // Pass 1: the K tiles alternate between U and the M region (unused
    // until the MLP), the next head's copy in flight while this head's
    // product runs.
    float acc[NT][4];
    zero_tiles(acc);
    load_k(U, 0);
    for (int h = 0; h < H; ++h) {
      cp_wait<0>();
      __syncthreads();  // K_h has landed; head h-1's buffer is free
      if (h + 1 < H) load_k((h & 1) ? U : X, h + 1);
      uint32_t qf[4][4];
      load_q(qf, h);
      qk_rows(acc, qf, (h & 1) ? X : U, ldq, nd, nk16, lane);
    }
    __syncthreads();  // U and M are free for the MLP
    store_rows_bf16(acc, X, SP + 8, nullptr, 0, 0, nk16, lane, warp);
    __syncwarp();
    zero_tiles(acc);  // now the mask m, without b2
    mask_mlp_fwd(acc, X, U, w1, w2, b1, SP, H2P, nk16, nullptr, 0, tid);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j / 2 < nk16) {
        const int k = j * 8 + 2 * t;
        const float c0 = k < S ? b2[k] : 0.f;
        const float c1 = k + 1 < S ? b2[k + 1] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Ms + (warp * 16 + g + 8 * hf) * (SP + 8) +
                                     k) =
              make_float2(acc[j][2 * hf] + c0, acc[j][2 * hf + 1] + c1);
      }
    }
  }

  // Pass 2. With two stages V_h is copied while the scores and the softmax
  // run and K_{h+1} while P V runs; with one, each copy waits for the
  // buffer and then for itself.
  if (two) load_k(U, 0);
  for (int h = 0; h < H; ++h) {
    if (!two) {
      __syncthreads();  // every warp is done with the previous V tile
      load_k(U, h);
    }
    float sc[NT][4];
    zero_tiles(sc);
    {
      uint32_t qf[4][4];
      load_q(qf, h);
      cp_wait<0>();
      __syncthreads();  // K_h has landed (two stages: V_{h-1} is free)
      if (two) load_v(h);
      qk_rows(sc, qf, U, ldq, nd, nk16, lane);
    }
    // logits and the fp32 softmax of rows g (hf 0) and g + 8 (hf 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j / 2 < nk16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = j * 8 + 2 * t + (e & 1);
          const int hf = e >> 1;
          float x = -INFINITY;
          if (k < S) {
            x = sc[j][e] * scale;
            if (use_mask) x += Ms[(warp * 16 + g + 8 * hf) * (SP + 8) + k];
          }
          sc[j][e] = x;
          mx[hf] = fmaxf(mx[hf], x);
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) mx[hf] = quad_max(mx[hf]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j / 2 < nk16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[j][e] == -INFINITY
                              ? 0.f
                              : __expf(sc[j][e] - mx[e >> 1]);
          sc[j][e] = p;
          sum[e >> 1] += p;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) sum[hf] = 1.f / quad_sum(sum[hf]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= sum[e >> 1];

    if (!two) {
      __syncthreads();  // every warp is done reading k_h
      load_v(h);
    }
    cp_wait<0>();
    __syncthreads();  // V_h has landed; every warp is done reading K_h
    if (two && h + 1 < H) load_k(U, h + 1);
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NT / 2; ++kb) {
      if (kb < nk16) {
        uint32_t a[4];
        c_to_a(a, sc[2 * kb], sc[2 * kb + 1]);
#pragma unroll
        for (int d2 = 0; d2 < 4; ++d2) {
          if (d2 < nv) {
            uint32_t bb[4];
            load_b_kn(bb, V, ldv, d2 * 16, kb * 16, lane);
            mma(o[2 * d2], a, bb[0], bb[1]);
            mma(o[2 * d2 + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    bf16* oh = out + (bh0 + h) * S * Dv;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < Dv) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = r0 + g + 8 * hf;
          if (q < S)
            *reinterpret_cast<uint32_t*>(oh + (size_t)q * Dv + d) =
                pack(o[n][2 * hf], o[n][2 * hf + 1]);
        }
      }
    }
  }
}

template <int NC>
cudaError_t launch_bf16(const tcore::bf16* qp, const tcore::bf16* kp,
                        const tcore::bf16* vp, const void* w1,
                        const float* b1, const void* w2, const float* b2,
                        void* out, int B, int H, int S, int D, int Dv,
                        float scale, int use_mask, cudaStream_t stream) {
  typedef tcore::bf16 bf16;
  const size_t smem = tcore::FwdSmem(S, D, Dv, use_mask != 0).bytes;
  auto kern = rope_attention_fwd_bf16_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + tcore::kRowsCta - 1) / tcore::kRowsCta, B);
  kern<<<grid, tcore::kThreads4, smem, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), H, S, D, Dv,
      scale, use_mask);
  return cudaGetLastError();
}

}  // namespace

// The bf16 path on the tensor cores: S <= 256, D <= 64, Dv <= 64, Dc, Dr
// and Dv even. w1 (pad16(2S), pad16(S)) and w2 (pad16(S), pad16(2S)) are
// the mask weights rounded to bf16 and zero-padded, b1 (pad16(2S)) fp32
// zero-padded, b2 (S) fp32; unused when use_mask == 0. Returns a
// cudaError_t. `prep` is a bf16 scratch of B*H*S*(2*pad16(D) + pad16(Dv))
// elements for the prologue's rotated, padded q, k and v rows; the call
// launches the prologue, then the kernel, and sets *launched to the number
// of kernels it launched.
extern "C" int rope_attention_fwd_bf16(
    const void* qc, const void* kc, const void* qr, const void* kr,
    const void* v, const float* cos_q, const float* sin_q,
    const float* cos_k, const float* sin_k, const void* w1, const float* b1,
    const void* w2, const float* b2, void* out, void* prep, int B, int H,
    int S, int Dc, int Dr, int Dv, float scale, int use_mask, void* stream,
    int* launched) {
  typedef tcore::bf16 bf16;
  const int D = Dc + Dr;
  *launched = 0;
  if (B < 1 || H < 1 || S < 1 || S > 256 || Dc < 0 || Dr < 0 || Dc % 2 ||
      Dr % 2 || D < 1 || D > 64 || Dv < 1 || Dv > 64 || Dv % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int DP = tcore::pad16(D), DVP = tcore::pad16(Dv);
  const size_t rows = (size_t)B * H * S;
  bf16* qp = static_cast<bf16*>(prep);
  bf16* kp = qp + rows * DP;
  bf16* vp = kp + rows * DP;
  tcore::PrepJobs jobs = {{
      {static_cast<const bf16*>(qc), static_cast<const bf16*>(qr), cos_q,
       sin_q, qp, Dc, Dr, DP},
      {static_cast<const bf16*>(kc), static_cast<const bf16*>(kr), cos_k,
       sin_k, kp, Dc, Dr, DP},
      {static_cast<const bf16*>(v), nullptr, nullptr, nullptr, vp, Dv, 0,
       DVP},
      {}}};
  cudaError_t err = tcore::launch_prep(jobs, 3, (int)rows, S, st);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
#define CASE(N)                                                              \
  case N:                                                                    \
    err = launch_bf16<N>(qp, kp, vp, w1, b1, w2, b2, out, B, H, S, D, Dv,    \
                         scale, use_mask, st);                               \
    break;
  switch ((S + 31) / 32) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CASE
  if (err == cudaSuccess) *launched = 2;
  return (int)err;
}

// The bf16 kernel's dynamic shared memory (bytes) and K/V stages at a
// shape, as the launch sizes them.
extern "C" void rope_attention_fwd_bf16_layout(int S, int D, int Dv,
                                               int use_mask, long long* bytes,
                                               int* kv_stages) {
  const tcore::FwdSmem L(S, D, Dv, use_mask != 0);
  *bytes = (long long)L.bytes;
  *kv_stages = L.kv_stages;
}
