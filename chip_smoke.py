#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (calm_vit_dte_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (any exception exits non-zero):
  1. probe   card name and count, `nvidia-smi` name/power limit, nvcc,
             whether triton imports; g++, whether a program using the
             system's libjpeg links, and whether the port's native JPEG
             decoder (data/native.py) builds and loads, which libjpeg it
             links, or why not;
  2. build   the CUDA kernels with nvcc for sm_90a, one nvcc per source in
             parallel, printing each source's register and spill figures
             from ptxas (the full log stays in build/torch_kernels/) and
             each hires tensor-core and CUDA-core kernel's; a spill in a
             hires tensor-core kernel or in the fp32 rope route's own
             kernels fails the run; the fp32 rope route's kernels (its own
             and the CUDA-core hires kernels it runs) as the runtime
             reports them, a spill failing the run; every conv
             kernel instantiation's registers, spills, shared memory a CTA
             and CTAs per SM as the CUDA runtime reports them (each, fp32
             and bf16, must keep the CTAs an SM its launch bound asks for,
             with no spill);
  3. check   the rope kernels' shared-memory helpers against the sizes the
             C launches use, at every shape below, mask on and off; the
             conv kernels' grids, threads, shared memory and partial rows
             in fp32 and bf16 against the wrapper's helpers at every conv
             S, and the bf16 erf within its stated bound of erff over
             [-10, 10]; then
             every kernel against its plain PyTorch version at every shape
             the flagship and imagenet-cls-256 give it (B=8; the rope
             attention kernels' bf16 route on the tensor cores, with the
             mask on and off). Forward kernels: fp32 at rtol 2e-4
             / atol 2e-5 (the per-layer eval limit of
             tests/test_parity_torch.py), and in bf16 the kernel's max-abs
             error against the fp32 plain version must be at most twice the
             plain bf16 version's (the conv forward's two launches
             bit-identical, fp32 and bf16); the attention forward also with
             no rope
             half (Dr = 0), with and without the mask. Attention backward:
             all 13 gradients, fp32 within 1e-4 of each gradient's largest
             value (tighter than the 5e-3 of bench.py's kernel-vs-oracle
             check; nothing in the kernel is atomic), bf16 by the same
             twice-the-plain rule, at every flagship shape and at Dr = 0,
             with and without the mask, the bf16 route bit-identical across
             two launches; the autograd Function against torch autograd
             of the plain forward; and the fp32 route (CUDA cores) at B =
             1, 2 and 8 at every flagship and imagenet-cls-256 shape, Dr =
             0 and one shape with odd Dc and Dv, mask on and off: forward
             rtol 2e-4 / atol 2e-5, every gradient within 1e-4 of its
             largest value, each call's stage launches exactly
             `ka.f32_stage_launches`, its hires calls' shared memory a CTA
             `ka.f32_smem_bytes`, and at B = 8 two backward launches bit
             for bit; the CUDA-core dk/dv kernel alone at the same shapes
             (B = 2, D = Dc + Dr, mask on and off) against
             hires_dkv_plain within 1e-4 of each output's largest value,
             two launches bit for bit, one kernel a call whose CTA asks for
             `ka.dkv_smem`;
  4. serve   the flagship through the user's entry points:
             Predictor.fresh("imagenet-cls-224").classify on 128 uint8
             256x256 images in bf16, with exactly 24 attention and 8 conv
             kernel launches; the same weights in fp32 on the card and on
             the CPU (plain versions) for 2 images, logits at rtol 2e-3 /
             atol 2e-4 and KL at rtol 1e-3 (tests/test_parity_full224.py's
             limits); one imagenet-reg-224 reconstruct (24 + 9 launches,
             outputs in [0, 1]; the fp32 predict's 24 rope launches and
             their stage launches checked); Predictor.fresh("imagenet-cls-256")
             .classify at B=128 (24 + 8 launches) and its images/s;
  5. train   imagenet-cls-224 at full width and depth through
             make_train_step: bf16, B=128, remat, fresh weights from seed 0,
             a repeated synthetic uint8 batch with soft labels. Loss finite
             at every step and lower at the last than the first, grad_norm
             finite and nonzero, u/v changed, every parameter's first-step
             gradient nonzero, exactly 24 forward + 24 backward attention
             launches and no fused-conv launch per step, then an eval step
             with 24 + 8; one fp32 step on 2 images card vs CPU under the
             same injected noise (loss rtol 2e-4; gradients per leaf rtol
             5e-3, atol 2e-4 of the leaf's largest value, the limits of
             tests/test_parity_grad.py; 24 + 24 rope launches on the fp32
             route, their stage launches checked); one bf16
             imagenet-cls-256 step at B=128 (finite loss and gradients, 24
             + 24 launches);
  6. time    each kernel and its plain version at every flagship shape
             (the rope attention kernels also at imagenet-cls-256's) at
             B=128 bf16 with CUDA events, plain, kernel, kernel, plain,
             beside its roofline bound (the conv forward also beside its
             CUDA-core floor), and the per-forward and per-step
             sums of the rope attention kernels against their plain
             versions'; the fp32 rope route at B=8 at every flagship shape,
             forward and backward, plain, kernel, kernel, plain, beside its
             fp32 bound, summed per forward and per step; the fp32 conv
             forward, forward with residuals and backward at B=8 at every
             flagship conv S, plain, kernel, kernel, plain (the kernels
             as CUDA-graph replays, the plain versions with events), beside
             the fp32 bound and CUDA-core floor, summed per forward or step;
             classify images/s and peak memory at B=128 bf16; ms per
             training step, images/s and peak memory;
  7. trace   one classify forward and one training step under
             torch.profiler: device busy share, the device kernels that take
             the most time, the attention kernels' share of the step;
  8. hires   hires-cls-1024 (S up to 1024, head dims up to 256), after the
             flagship's trainer is freed: the four hires kernels
             (kernels/hires_attention.py) against their plain versions at
             every hires shape at B=2 (fp32 forward rtol 2e-4 / atol 2e-5,
             fp32 backward within 1e-4 of each output's largest value, bf16
             at most twice the plain bf16 error; the forward-only kernel with
             the mask off, kernels 1-3 with zero mask weights; the autograd
             Function against torch autograd of the plain forward; the bf16
             forwards, dq pass and dk/dv pass bit-identical across two
             launches at S=1024, D=256);
             Predictor.fresh("hires-cls-1024").classify on 8 uint8 1168x1168
             images (exactly 24 forward-only + 8 conv launches, no rope
             kernel), fp32 logits card vs CPU on 1 image; five bf16 training
             steps at B=8 with remat (24 + 24 + 24 hires launches and 24
             weight-grad reductions each, loss lower at the end, every
             gradient finite and nonzero), an eval step (24 forward-only),
             each path's stage launches as the C entries report them (3 per
             forward, 4 per dq pass, 6 per weight-grad reduction, none per
             dk/dv pass), one traced step split by kernel family, one fp32
             step on 1 image card vs CPU; each kernel and its plain version
             timed at B=8 bf16, with each call's device time by part (the
             attention tiles, the strided product, the sums) beside the
             library calls that compute the parts
             (scaled_dot_product_attention with m as an additive bias;
             torch.matmul at the strided product's shapes and at the dk/dv
             pass's four products), which the port never calls; the conv
             forward at the four hires conv S at B=8 against its plain
             version (bf16 at most twice the plain bf16 error, two launches
             bit-identical), then timed beside its plain version, bound and
             CUDA-core floor, summed per hires forward (the floor, a count
             and not a measurement, goes to the log only);
  9. trainer the classification trainer entry point with the fused conv
             residual in training, after the hires phase frees its memory:
             the forward that saves h and acc and the recomputing backward
             (kernels/conv_residual.py) against their plain versions at
             every conv S of the flagship and imagenet-cls-256 at B=8 (fp32
             forward rtol 2e-4 / atol 2e-5, fp32 backward within 1e-4 of
             each output's largest value, bf16 at most twice the plain bf16
             error, two bf16 launches of each kernel and two fp32 backward
             launches bit-identical, the ablation's FULL bit-identical to
             the production backward; the
             Function on both routes against torch autograd of
             the plain forward); then train_cls.main in process on
             imagenet-cls-224 at full width and depth, B=128, synthetic
             data, bf16, remat, six steps, under each conv route (the
             F.conv2d chain, CALM_CONV_FUSED=1, and =1 with
             CALM_CONV_BWD=xla): model and batches on the card, loss finite
             every step, exact launches per step (24 + 24 attention; 8 + 8
             conv and 8 weight-grad sums on the pallas route, 8 forwards
             with residuals on the xla route, none on the chain), the
             checkpoint restored bit for bit and a second main resuming
             from it; three train_reg.main steps on imagenet-reg-224 at
             B=128 (loss finite every step, 24 + 24 attention launches per
             step); p50 ms per step beside phase 5's bare step; each
             kernel and its plain version timed at B=128 bf16 at every conv
             S beside its bound and CUDA-core floor, and the ablation's
             variants at S=224 (FULL and five parts dropped; the sixth
             part, trans, reported absent);
 10. serving the (s,h,d)->(h,s,d) relayout kernel (kernels/relayout.py)
             bit-identical to the transpose at every flagship head split
             (128, S, 12, D), (S, D) in (224, 56), (176, 44), (128, 32),
             (80, 20), fp32 and bf16, with its device time (CUDA-graph
             replay) beside the transpose's and its bytes bound; the layout
             canaries (tools/canary_probes.run_canaries, the relayout's main
             path); then phase 9's step-6 checkpoint: Predictor.
             from_checkpoint, save and load (classify bit-identical), top-1
             by train/evaluate.py on 256 planted 256x256 PNGs labelled with
             the checkpoint's own top-1 (>= 0.99; offset by one <= 0.01),
             int8 and int8-wo (relative logit error < 0.15, top-1 agreement
             >= 0.75 against bf16, tests/test_quantize.py's limits), every
             forward exactly 24 attention + 8 conv launches; classify
             images/s and peak memory at B=128 in bf16, int8 and int8-wo;
 11. proof   the slice's new paths, last: (a) a learnable corpus of 64
             JPEGs at 384 px (data/corpus.py) decoded by the native
             decoder and by Pillow, all within 2 of each other
             (tests/test_native.py:46), and the decode images/s of native
             with all host cores, native on 1 thread and Pillow over the
             same files; (b) Encoder8 and CALMLatentDiffusion at their
             default full widths (dim1 672, 12 heads, S 224): a bf16
             forward at B=8 with exactly 24 attention + 8 conv and 18 + 6
             launches (one prologue each, no hires kernel), finite outputs,
             the fp32 forward card vs CPU on 2 inputs at rtol 2e-3 / atol
             2e-4 (and CALMLatentDiffusion's KL at rtol 1e-3), its rope
             launches and the fp32 route's stage launches checked; (c) 100
             overfit steps through tools/train_proof on the flagship (128
             memorize images, B=128, bf16, remat off, evals at 50 and
             100): every loss finite, the last 10 steps' mean below the
             first 10's, exactly 24 + 24 rope launches a step and 24 + 8
             per eval forward, decoded by the native decoder;
 12. jaxinit the JAX package's own seed-0 imagenet-reg-224 weights: (a)
             rebuilt on this host with numpy from the committed table
             (compat/jax_init.py), every leaf's digest matched (numpy's
             version printed); (b) a bf16 reconstruct at B=8 from them, u/v
             converged as Predictor.fresh does (exactly 24 attention + 9
             conv launches), the fp32 forward card vs CPU on 2 images at
             rtol 2e-3 / atol 2e-4, KL rtol 1e-3 (24 rope launches on the
             fp32 route, their stage launches checked); (c) three
             train_reg.main
             steps at B=128 warm-started from a reference-format .pth of
             them (the first step's weights the table's bit for bit,
             exactly 24 + 24 rope launches a step and 24 + 9 for the epoch
             end's samples, finite loss, finite nonzero gradient norm), the
             step_3.pt restored bit for bit and
             served through create_vit(weights=<dir>), its weights the
             trained ones bit for bit, u/v converged (24 + 9 launches,
             outputs in [0, 1]); (d) whether
             tensorstore imports: Orbax conversion runs host-side.
 13. parallel data and tensor parallelism (parallel/mesh.py) on the one
             card: (a) `torchrun --standalone --nproc_per_node=1 -m
             calm_vit_dte_tpu_torch.train.train_cls --max-steps 3` on the
             flagship at B=128 (NCCL at world 1; every loss finite; 24 +
             24 rope launches a step; its checkpoint restored bit for bit
             equal to that of the same steps without torchrun); (b) two
             processes sharing the card over gloo (tools/parallel_step.py),
             the flagship at full width in fp32, global batch 8, injected
             global noise: DP 2x1 and TP 1x2 (tp_min_shard_dim 512, 59
             weights) against the single-process card step (loss rtol
             1e-5; state rtol 3e-3 / atol 3e-5 for DP, 3e-4 for TP; each
             comparison's worst element printed: tensor, index, values),
             both sides with cuDNN's deterministic algorithms, the
             one-process step run twice and held against itself with the
             DP limits, the ranks bit-identical, 24 + 24 rope launches a
             step on every rank; each rank's stored bytes under TP against
             DP (13,267,968 elements x 12 B less), host ms a step at world
             1 and 2, and the ms the global noise draw adds;
 14. tools   the ported scripts (calm_vit_dte_tpu_torch/tools/), each run
             in this process at a reduced size into a temporary directory
             and checked for what it is for: stage_dataset (a local tar
             staged, skipped on a re-run, extracted); bench_dataplane (256
             corpus JPEGs, B=128, 6 steps each of the resident, loader-only
             and from-disk runs: finite rates and losses, the native
             decoder, no image by Pillow); bench_eval_50k (1,024 staged val
             JPEGs: top-1, loader wait + device seconds within the wall);
             soak (the train_cls CLI over 4 x 64 JPEGs at B=128, SIGTERM
             after 3 epochs: the checkpoint, at most 3 kept, a one-step
             resume from it; its processes run beside the tools that
             follow the dataplane, whose times are marked so and are not
             comparable with the full runs'); bench_hires_train (B=2, 2
             steps);
             bench_hires_serve (B=1, bf16, int8, int8-wo); bench_quantize
             (B=32, both int8 modes within tests/test_quantize.py's limits);
             profile_opt (3 repetitions). Exact launches on every path: 24 +
             24 rope a step, 24 + 8 a flagship forward, 24 + 24 + 24 hires a
             hires step, 24 forward-only + 8 conv a hires forward; a tool
             that fails fails the run;
 15. routes  the attention dispatch (ops/attention.py) and the JAX
             package's 'chunked' and 'xla' routes: (a) at each limit of the
             dispatcher (rope Dv 64 -> 72 at S 224: rope -> hires; D = Dv
             256 -> 264 at S 1024: in bf16 every pass from the
             tensor-core kernels to their wide forms; bf16 S 1024 -> 1020:
             every pass to the CUDA cores;
             Sq = Skv 224 -> Skv 256: rope -> 'xla'), fp32 and bf16, mask
             on and off, with and without grad, one counter each (the
             launches by family: the path routes_limits); the route's fp32
             forward (rtol 2e-4 / atol 2e-5) and gradients (within 1e-4 of
             each one's largest value) card vs CPU; the hires kernels past
             the D, Dv <= 256 tensor-core kernels (the six-head shapes, D
             264, a partial D slice, Dv past 256 with D below it, bf16 S
             1020 and head dims off the multiple of 8) against their plain
             versions as phase 8 holds the tensor-core ones, bf16 twice
             bit for bit, and timed at B=8 (the wide kernels in bf16, the
             CUDA-core kernels in fp32), with the wide kernels' and the
             fp32 CUDA-core forward, dm/ssum, dq and dk/dv kernels'
             registers, spills, shared memory and CTAs per SM from the
             runtime (a spill fails the run, as does the dk/dv kernel at
             NV 1 short of two CTAs an SM); the CUDA-core dk/dv kernel at
             its edges (DKV_EDGE_CHECKS: S 200, D 264 / Dv 56 both ways, D =
             Dv 512 and 520, bf16 D 44 and S 1020) against hires_dkv_plain
             as phase 3 holds it, bf16 at most twice the plain bf16
             error; (b) 'chunked' (chunk
             2) against 'xla' forced at B 16, H 6,
             S 1024, D = Dv 512 in bf16, forward and backward, each within
             twice the other's error of the fp32 route, each one's device
             ms and peak memory, beside the hires kernels that 'auto' takes
             there; (c) create_vit("hires-cls-1024", heads=6) at full
             width, u/v converged as Predictor.fresh does: classify 8 uint8
             1168x1168 images through the Predictor constructor in bf16
             (exactly 24 forward-only hires launches, 15 of them on the
             wide kernel, + 8 conv), fp32 logits card vs CPU on 1 image
             (phase 8's limits; 24 forward-only launches on the CUDA-core
             kernel), and make_train_step steps at B=16 in bf16 with remat
             (exactly 24 + 24 + 24 hires launches: 15 forwards, 15 dq and
             15 dk/dv passes on the wide kernels, none on the CUDA-core
             kernels, no route; the loss finite, every gradient finite and
             nonzero), images/s and ms a step.

Every fp32 comparison runs with torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False, so the plain versions' products
and convolutions are true fp32.

Output: human-readable lines, then the card's `nvidia-smi` name and power
limit, then one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. No single PyTorch call computes any of the
fused functions (scaled_dot_product_attention has no head-coupled learned
mask and returns no mask, residual or table gradients; no convolution call
returns the conv residual's middle activations or its packed weight grads),
so their library_ms is null; the relayout's is the transpose's time
(x.transpose(1, 2).contiguous(), also its plain version). The rope
attention kernels' entries also carry `stage_launches_by_path`: the
launches each bf16 call makes beside its kernel, as the C entry reports
them (the forward's prologue; the backward's prologue, keys kernel, table
and weight-grad reductions), read per main path after the counters were set
to 0 before it, and checked against the path's launches (one prologue per
forward, six per flagship backward; on the fp32 paths
`ka.f32_stage_launches`); so do the hires kernels' (their
strided products and sums), whose per-shape rows also carry the parts'
device times, the parts' library times and the shared memory per CTA.
The rope entries also carry `fp32_b8` (the fp32 route's times at B=8, per
flagship forward and per step's backward, beside its plain version and
fp32 bound) and `fp32_checks` (phase 3's fp32 errors by shape). The conv
forward, the forward with residuals and the backward carry `fp32_b8` too
(phase 6's reads at each flagship conv S and their sums per forward or
step: the kernels' graph-replay times, the plain versions' event times
and the fp32 bound).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
H = 12
CHECK_BATCH = 8
TIME_BATCH = 128


def log(*args) -> None:
    print(*args, flush=True)


# The card's SM count and SM clock (phase 1), for the conv kernels' CUDA-core
# floor (tools/time_conv.py: LANE_OPS x pixels / (SMs x 128 x clock)).
CARD: dict = {}


def conv_floor_ms(kind, b, s, fp32=False):
    import torch

    from calm_vit_dte_tpu_torch.tools import time_conv as tconv

    return tconv.floor_ms(kind, b, s, CARD["sms"], CARD["clock_hz"],
                          torch.float32 if fp32 else torch.bfloat16)


def flagship_shapes(model_cfg):
    """Attention shapes {(S, Dc, Dr, Dv): launches} and conv sizes
    {S: launches} of one flagship forward, from the port's own configs."""
    attn: dict[tuple, int] = {}
    conv: dict[int, int] = {}
    for _, bcfg in model_cfg.backbone_cfg().block_configs():
        for vcfg in (bcfg.encoder_cfg(), bcfg.decoder_cfg(),
                     bcfg.cross_cfg()):
            dc = vcfg.head_dim_content if vcfg.reduce else 0
            dr = vcfg.head_dim_rope if vcfg.reduce else vcfg.head_dim
            key = (vcfg.seq_len_new, dc, dr, vcfg.head_dim)
            attn[key] = attn.get(key, 0) + 1
        conv[bcfg.seq_len_new] = conv.get(bcfg.seq_len_new, 0) + 1
    return attn, conv


def attn_inputs(torch, b, s, dc, dr, dv, device, dtype, seed):
    from calm_vit_dte_tpu_torch.ops.rope import RoPE, rope_tables

    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device=device, dtype=dt)

    qc = n(b, H, s, dc, scale=0.3) if dc else None
    kc = n(b, H, s, dc, scale=0.3) if dc else None
    qr = n(b, H, s, dr, scale=0.3) if dr else None
    kr = n(b, H, s, dr, scale=0.3) if dr else None
    v = n(b, H, s, dv, scale=0.3)
    cq = sq = ck = sk = None
    if dr:
        inv = RoPE(dr).inv_freq.detach().to(device)
        cq, sq = rope_tables(inv, s)
        ck, sk = rope_tables(inv * 1.1, s)
    f32 = torch.float32
    return (qc, qr, kc, kr, v, cq, sq, ck, sk,
            n(2 * s, s, scale=0.05, dt=f32), n(2 * s, scale=0.05, dt=f32),
            n(s, 2 * s, scale=0.05, dt=f32), n(s, scale=0.05, dt=f32))


def grad_like(torch, b, s, dv, device, dtype, seed, h=H):
    """An output gradient (B, H, S, Dv) for the attention backward."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((b, h, s, dv)) * 0.3).astype(np.float32)).to(
        device=device, dtype=dtype)


def conv_inputs(torch, b, s, device, dtype, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device=device, dtype=dt)

    return (n(b, s, s, 3, dt=dtype), n(32, 3, scale=0.3), n(32, scale=0.1),
            n(3, 3, 32, scale=0.3), n(32, scale=0.1), n(3, 32, scale=0.2),
            n(3, scale=0.1))


def cast(torch, args, dtype):
    """The same inputs with the activations (not the fp32 tables and
    weights) in `dtype`."""
    return tuple(a if a is None or a.dtype == torch.float32 and a.dim() < 4
                 else a.to(dtype) for a in args)


def attn_bound(b, s, dc, dr, dv, itemsize, peak=PEAK_BF16_FLOPS):
    """(bytes ms, operations ms) of one forward: reads q, k, v, the tables
    and the mask weights, writes out; operations at `peak` (the compute
    type's rate: bf16 tensor cores, or fp32 outside them)."""
    d = dc + dr
    nbytes = (b * H * s * (2 * d + 2 * dv) * itemsize   # q, k, v, out
              + 4 * s * dr * 4                           # cos/sin tables
              + (2 * s * 2 * s + 3 * s) * 4)             # mask weights
    flops = 2 * b * H * s * s * (d + dv) + 4 * b * s * s * 2 * s
    return nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


def attn_bwd_bound(b, s, dc, dr, dv, itemsize, peak=PEAK_BF16_FLOPS):
    """Reads q, k, v, g, the tables and the mask weights; writes dq in the
    compute type, dk and dv in fp32, and the table and weight gradients;
    three times the forward's operations (recompute, and two products per
    forward product)."""
    d = dc + dr
    small = 4 * s * dr * 4 + (2 * s * 2 * s + 3 * s) * 4
    nbytes = (b * H * s * (2 * d + 2 * dv) * itemsize   # q, k, v, g
              + b * H * s * d * itemsize                 # dq
              + b * H * s * (d + dv) * 4                 # dk, dv
              + 2 * small)                               # read and written
    flops = 3 * (2 * b * H * s * s * (d + dv) + 4 * b * s * s * 2 * s)
    return nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


def conv_bound(b, s, itemsize, peak=PEAK_BF16_FLOPS):
    nbytes = 2 * b * s * s * 3 * itemsize + (96 + 32 + 288 + 32 + 96 + 3) * 4
    flops = 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


# The tensor-core kernels whose registers and spills phase 2 prints.
TENSOR_CORE_KERNELS = ("rope_attention_fwd_bf16_kernel", "bwd_rows_kernel",
                       "bwd_keys_kernel", "xty_mma_kernel",
                       "hires_attention_bf16_kernel",
                       "hires_dm_ssum_bf16_kernel", "hires_dq_bf16_kernel",
                       "hires_dkv_bf16_kernel", "gemm_tc_kernel",
                       "hires_attention_wide_bf16_kernel",
                       "hires_dq_wide_bf16_kernel",
                       "hires_dkv_wide_bf16_kernel")
# The fp32 rope route's own kernels (csrc/axial_attention{,_bwd}.cu, "fp32
# route"); the rest of the route is the CUDA-core hires kernels.
F32_ROPE_KERNELS = ("rope_prep_f32_kernel", "rope_delta_kernel",
                    "rope_unrotate_f32_kernel")
# The CUDA-core kernels of the fp32 routes (hires and rope), whose
# registers and spills phase 2 prints too.
CUDA_CORE_KERNELS = ("hires_attention_kernel", "hires_dq_kernel",
                     "hires_dm_ssum_kernel", "hires_dkv_kernel",
                     "gemm_kernel") + F32_ROPE_KERNELS
# The hires tensor-core kernels and the fp32 rope route's own, whose ptxas
# reports must show no spills.
NO_SPILL_KERNELS = ("hires_attention_bf16_kernel",
                    "hires_dm_ssum_bf16_kernel", "hires_dq_bf16_kernel",
                    "hires_dkv_bf16_kernel", "gemm_tc_kernel",
                    "hires_attention_wide_bf16_kernel",
                    "hires_dq_wide_bf16_kernel",
                    "hires_dkv_wide_bf16_kernel") + F32_ROPE_KERNELS


def kernel_registers(ptxas_log):
    """(kernel name, registers, spill store bytes) per compiled entry."""
    rows, name, spill = [], None, 0
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            known = [k for k in TENSOR_CORE_KERNELS + CUDA_CORE_KERNELS
                     if k in name]
            targs = re.search(r"I((?:L[ib]\d+E|f|13__nv_bfloat16)+)E", name)
            short = (known[0] if known else name) + (
                "<" + ", ".join(
                    {"f": "float", "13__nv_bfloat16": "bf16"}.get(t, t[2:-1])
                    for t in re.findall(r"L[ib]\d+E|f|13__nv_bfloat16",
                                        targs.group(1)))
                + ">" if targs else "")
            rows.append((short, int(m.group(1)), spill))
            name = None
    return rows


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def norm_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


GRAD_NAMES = ("dqc", "dqr", "dkc", "dkr", "dv", "dcos_q", "dsin_q", "dcos_k",
              "dsin_k", "dw1", "db1", "dw2", "db2")
BWD_FP32_LIMIT = 1e-4   # of each gradient's largest value
# Phase 3's checks of the fp32 rope route: its batches, and a shape with odd
# Dc and Dv that only the fp32 route takes.
F32_CHECK_BATCHES = (1, 2, 8)
F32_ODD_SHAPE = (80, 9, 10, 19)


def rope_counts(ka, path, fp32, use_mask=True):
    """The rope wrappers' launches and stage launches since they were set to
    0 before `path`, the stage launches checked to be exactly what each call
    launches past its counted one: in bf16 the prologue a forward and six
    kernels a flagship backward (prologue, keys kernel, table-grad
    reduction, two weight-grad products and their reduction); in fp32
    `ka.f32_stage_launches(use_mask)`. Returns {"attention_fwd",
    "attention_bwd", "stages": {"attention_fwd", "attention_bwd"}}."""
    fwd = ka.fused_rope_attention.launches
    bwd = ka.fused_rope_attention_bwd.launches
    per = (ka.f32_stage_launches(use_mask) if fp32
           else {"forward": 1, "backward": 6})
    stages = {"attention_fwd": ka.fused_rope_attention.stage_launches,
              "attention_bwd": ka.fused_rope_attention_bwd.stage_launches}
    if stages != {"attention_fwd": per["forward"] * fwd,
                  "attention_bwd": per["backward"] * bwd}:
        raise AssertionError(
            f"{path}: stage launches {stages} for {fwd} forwards and {bwd} "
            f"backwards ({'fp32' if fp32 else 'bf16'}, {per} a call)")
    return {"attention_fwd": fwd, "attention_bwd": bwd, "stages": stages}


def zero_rope_counts(ka):
    for w in (ka.fused_rope_attention, ka.fused_rope_attention_bwd):
        w.launches = w.stage_launches = 0


def check_attention_bwd(torch, ka, args, g, scale, use_mask):
    """The backward kernel against its plain version on the same inputs
    (fp32 `args`, `g`): fp32 within BWD_FP32_LIMIT, bf16 at most twice the
    plain bf16 version's error against the fp32 plain version, and the bf16
    route bit-identical across two launches. Returns
    (worst fp32 normalised error, worst fp32 absolute error, worst bf16
    kernel error, the plain bf16 error of that gradient)."""
    bf16, f32 = torch.bfloat16, torch.float32
    kw = dict(scale=scale, use_mask=use_mask)
    got = ka.fused_rope_attention_bwd(g, *args, dtype=f32, **kw)
    ref = ka.fused_rope_attention_bwd_plain(g, *args, dtype=f32, **kw)
    torch.cuda.synchronize()
    a16, g16 = cast(torch, args, bf16), g.to(bf16)
    k16 = ka.fused_rope_attention_bwd(g16, *a16, dtype=bf16, **kw)
    again = ka.fused_rope_attention_bwd(g16, *a16, dtype=bf16, **kw)
    for name, x, y in zip(GRAD_NAMES, k16, again):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{name}: the bf16 backward differs between "
                                 "two launches")
    p16 = ka.fused_rope_attention_bwd_plain(g16, *a16, dtype=bf16, **kw)
    r16 = ka.fused_rope_attention_bwd_plain(
        g16.float(), *cast(torch, a16, f32), dtype=f32, **kw)
    worst = [0.0, 0.0, 0.0, 0.0]
    for name, x, y, k, p, r in zip(GRAD_NAMES, got, ref, k16, p16, r16):
        if (x is None) != (y is None) or (k is None) != (y is None):
            raise AssertionError(f"{name}: kernel and plain version disagree "
                                 "on which gradients exist")
        if x is None:
            continue
        if x.shape != y.shape or x.dtype != y.dtype or k.dtype != p.dtype:
            raise AssertionError(f"{name}: shape or dtype differs")
        e32, e_k, e_p = norm_err(x, y), norm_err(k, r), norm_err(p, r)
        if not e32 <= BWD_FP32_LIMIT:
            raise AssertionError(f"{name}: fp32 error {e32:.3e} of the "
                                 f"largest value > {BWD_FP32_LIMIT}")
        if not e_k <= 2 * e_p + 1e-6:
            raise AssertionError(f"{name}: bf16 kernel error {e_k:.3e} > 2 x "
                                 f"plain bf16 {e_p:.3e}")
        worst[0] = max(worst[0], e32)
        worst[1] = max(worst[1], max_err(x, y))
        if e_k >= worst[2]:
            worst[2], worst[3] = e_k, e_p
    return tuple(worst)


HIRES_BATCH = 8          # hires-cls-1024: serving, training and timing
HIRES_CHECK_BATCH = 2
HIRES_TRAIN_STEPS = 5
REG_STEPS = 3
HIRES_OUT_NAMES = ("dq", "dssum", "dw1", "db1", "dw2", "db2", "dk", "dv")
# Launches past the counted one of each bf16 hires call with the mask, as
# the C entries report them: the forwards' three strided products before
# the attention kernel; the dq pass's dm/ssum kernel and three products
# before the dq kernel; the weight grads' second product, partial sums and
# two two-stage column sums after the first product; none beside the dk/dv
# kernel.
HIRES_STAGES_PER_CALL = {"fwd_res": 3, "fwd_only": 3, "dq": 4,
                         "weight_grads": 6, "dkv": 0}


def hires_inputs(torch, b, s, d, dv, device, dtype, seed, zero_mask=False,
                 h=H):
    """q, k (B,H,S,D), v (B,H,S,Dv) in `dtype` (rotated and concatenated
    already: the hires route does that in torch) and fp32 mask weights
    scaled so that the scores, the mask's hidden layer and m are of order
    one (zeros with `zero_mask`, the route's use_mask=False)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale, dt=torch.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device=device, dtype=dt)

    w = [n(2 * s, s, scale=0.2 / s ** 0.5), n(2 * s, scale=0.1),
         n(s, 2 * s, scale=(2 * s) ** -0.5), n(s, scale=0.1)]
    if zero_mask:
        w = [torch.zeros_like(t) for t in w]
    return [n(b, h, s, d, scale=0.3, dt=dtype), n(b, h, s, d, scale=0.3,
                                                  dt=dtype),
            n(b, h, s, dv, scale=0.3, dt=dtype), *w]


def hires_bounds(b, s, d, dv, itemsize, h=H, peak=PEAK_BF16_FLOPS):
    """(bytes ms, operations ms) of the four hires kernels at one shape:
    each input read once, each output written once; the operations of the
    products each kernel forms (the mask MLP included), at `peak` FLOP/s
    (the compute type's rate: bf16 tensor cores, or fp32)."""
    mlp = 4 * b * s ** 3                       # one (B*S, S) x (S, 2S) product
    qkvo = b * h * s * (2 * d + 2 * dv) * itemsize
    weights = (2 * s * 2 * s + 3 * s) * 4
    sq = b * s * s * 4                          # an fp32 (B, S, S) residual
    vec = b * h * s * 4                         # lse or delta
    work = {
        "fwd_only": (qkvo + weights,
                     2 * b * h * s * s * (d + dv) + 2 * mlp),
        "fwd_res": (qkvo + weights + sq + vec,
                    2 * b * h * s * s * (d + dv) + 2 * mlp),
        "dq": (qkvo + weights + sq + 2 * vec       # q k v g; m lse delta
               + b * h * s * d * itemsize          # dq
               + sq + weights,                     # dssum; weight grads
               2 * b * h * s * s * (2 * d + dv) + 5 * mlp),
        "dkv": (qkvo + b * h * s * (d + dv) * itemsize + 2 * sq + 2 * vec,
                4 * b * h * s * s * (d + dv)),
    }
    return {k: (nb / PEAK_BYTES * 1e3, fl / peak * 1e3)
            for k, (nb, fl) in work.items()}


def hires_bwd(kh, args, g, res, scale, dtype, plain):
    """Both backward passes: (dq, dssum, dw1, db1, dw2, db2, dk, dv)."""
    q, k, v, w1, b1, w2, _ = args
    o, m, lse = res
    delta = (g.float() * o.float()).sum(-1)
    kw = dict(scale=scale, dtype=dtype)
    dq_fn = kh.hires_dq_plain if plain else kh.hires_dq
    dkv_fn = kh.hires_dkv_plain if plain else kh.hires_dkv
    out = dq_fn(q, k, v, g, m, lse, delta, w1, b1, w2, **kw)
    return out + dkv_fn(q, k, v, g, m, lse, delta, out[1], **kw)


def check_hires_shape(torch, ka, kh, s, d, dv, seed, zero_mask=False,
                      h=H, twice=False):
    """Kernels 1-4 against their plain versions at B=HIRES_CHECK_BATCH:
    fp32 forward (o, m, lse; kernel 4 with the mask on and off) at rtol 2e-4
    / atol 2e-5, fp32 backward within BWD_FP32_LIMIT of each output's
    largest value, bf16 at most twice the plain bf16 version's error (and,
    with `twice`, the bf16 forwards and backward passes launched again give
    the same bits). Returns the worst errors: fp32 max abs by kernel, the
    backward's worst normalised fp32 error, the worst bf16 error over the
    plain bf16 one (also by kernel, `bf16_over_plain`) and the bf16 max abs
    kernel-vs-plain difference by kernel (`bf16_abs`)."""
    f32, bf16 = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    scale = 1.0 / d ** 0.5
    args = hires_inputs(torch, HIRES_CHECK_BATCH, s, d, dv, dev, f32, seed,
                        zero_mask, h=h)
    g = grad_like(torch, HIRES_CHECK_BATCH, s, dv, dev, f32, seed + 1, h=h)
    kw32, kw16 = dict(scale=scale, dtype=f32), dict(scale=scale, dtype=bf16)
    worst = {"fwd_res": 0.0, "fwd_only": 0.0, "dq": 0.0, "dkv": 0.0,
             "bwd_norm": 0.0, "bf16_ratio": 0.0,
             "bf16_over_plain": dict.fromkeys(("fwd_res", "fwd_only", "dq",
                                               "dkv"), 0.0),
             "bf16_abs": dict.fromkeys(("fwd_res", "fwd_only", "dq", "dkv"),
                                       0.0)}

    def bf16_ok(what, got, plain, ref, kernel):
        e_k, e_p = norm_err(got, ref), norm_err(plain, ref)
        if not e_k <= 2 * e_p + 1e-6:
            raise AssertionError(f"hires {what} S={s} D={d}: bf16 kernel "
                                 f"error {e_k:.3e} > 2 x plain {e_p:.3e}")
        if e_p > 1e-6:   # where plain bf16 equals plain fp32, no ratio
            worst["bf16_ratio"] = max(worst["bf16_ratio"], e_k / e_p)
            worst["bf16_over_plain"][kernel] = max(
                worst["bf16_over_plain"][kernel], e_k / e_p)
        worst["bf16_abs"][kernel] = max(worst["bf16_abs"][kernel],
                                        max_err(got, plain))

    def same_bits(what, first, again):
        for x, y in zip(first, again):
            if not torch.equal(x, y):
                raise AssertionError(f"hires {what} S={s} D={d} Dv={dv}: "
                                     "two bf16 launches differ")

    res = kh.hires_fwd_res(*args, **kw32)
    res_p = kh.hires_fwd_res_plain(*args, **kw32)
    torch.cuda.synchronize()
    for x, y in zip(res, res_p):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        worst["fwd_res"] = max(worst["fwd_res"], max_err(x, y))
    for use_mask in (True, False):
        out = kh.fused_attention_forward(*args, use_mask=use_mask, **kw32)
        ref = ka.attention_core(*args, use_mask=use_mask, **kw32)
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
        worst["fwd_only"] = max(worst["fwd_only"], max_err(out, ref))
    got = hires_bwd(kh, args, g, res_p, scale, f32, plain=False)
    want = hires_bwd(kh, args, g, res_p, scale, f32, plain=True)
    for name, x, y in zip(HIRES_OUT_NAMES, got, want):
        e = norm_err(x, y)
        if not e <= BWD_FP32_LIMIT:
            raise AssertionError(f"hires {name} S={s} D={d}: fp32 error "
                                 f"{e:.3e} of the largest value")
        worst["bwd_norm"] = max(worst["bwd_norm"], e)
        key = "dkv" if name in ("dk", "dv") else "dq"
        worst[key] = max(worst[key], max_err(x, y))

    a16 = cast(torch, args, bf16)
    a32 = cast(torch, a16, f32)
    g16 = g.to(bf16)
    k16 = kh.hires_fwd_res(*a16, **kw16)
    if twice:
        same_bits("forward", k16, kh.hires_fwd_res(*a16, **kw16))
    p16 = kh.hires_fwd_res_plain(*a16, **kw16)
    r32 = kh.hires_fwd_res_plain(*a32, **kw32)
    for what, x, y, r in zip(("o", "m", "lse"), k16, p16, r32):
        bf16_ok(what, x, y, r, "fwd_res")
    for use_mask in (True, False):
        ref = ka.attention_core(*a32, use_mask=use_mask, **kw32)
        out = kh.fused_attention_forward(*a16, use_mask=use_mask, **kw16)
        if twice:
            same_bits("forward-only", [out], [kh.fused_attention_forward(
                *a16, use_mask=use_mask, **kw16)])
        bf16_ok("forward-only", out,
                ka.attention_core(*a16, use_mask=use_mask, **kw16), ref,
                "fwd_only")
    k16 = hires_bwd(kh, a16, g16, p16, scale, bf16, plain=False)
    if twice:
        same_bits("backward", k16, hires_bwd(kh, a16, g16, p16, scale, bf16,
                                             plain=False))
    b16 = hires_bwd(kh, a16, g16, p16, scale, bf16, plain=True)
    r32 = hires_bwd(kh, a32, g16.float(), p16, scale, f32, plain=True)
    for name, x, y, r in zip(HIRES_OUT_NAMES, k16, b16, r32):
        bf16_ok(name, x, y, r, "dkv" if name in ("dk", "dv") else "dq")
    return worst


# The CUDA-core dk/dv kernel at its edges past the rope shapes (phase 3
# holds it at those, mask on and off): (dtype, H, S, D, Dv, mask): S a
# multiple of neither 64 nor 128; D != Dv with one output's second slice
# empty (each way); two and three slices; bf16 off the multiple of 8 (the
# register path: D 44, S 1020).
DKV_EDGE_CHECKS = (("float32", 4, 200, 72, 40, True),
                   ("float32", 2, 192, 264, 56, True),
                   ("float32", 2, 192, 56, 264, True),
                   ("float32", 2, 256, 512, 512, True),
                   ("float32", 2, 136, 520, 520, True),
                   ("bfloat16", 4, 200, 44, 44, True),
                   ("bfloat16", 2, 1020, 64, 64, True))


def check_dkv_shape(torch, ka, kh, dtype, h, s, d, dv, use_mask, seed):
    """The dk/dv pass alone at B=HIRES_CHECK_BATCH against hires_dkv_plain
    on the same residuals (the plain forward's m, lse, the plain dq pass's
    dssum): fp32 within BWD_FP32_LIMIT of each output's largest value, bf16
    at most twice the plain bf16 version's error against fp32; two launches
    the same bits; one kernel a call, on the CUDA cores, its CTA
    `ka.dkv_smem` of its slice's NV (`ka.dkv_split`; 4 for 3 on the
    register path). Returns the worst error: fp32 normalised, bf16 over
    plain."""
    f32, dt = torch.float32, getattr(torch, dtype)
    dev = torch.device("cuda")
    args = hires_inputs(torch, HIRES_CHECK_BATCH, s, d, dv, dev, dt, seed,
                        zero_mask=not use_mask, h=h)
    g = grad_like(torch, HIRES_CHECK_BATCH, s, dv, dev, dt, seed + 1, h=h)
    kw = dict(scale=1.0 / d ** 0.5, dtype=dt)
    o, m, lse = kh.hires_fwd_res_plain(*args, **kw)
    delta = (g.float() * o.float()).sum(-1)
    q, k, v, w1, b1, w2, _ = args
    res = (m, lse, delta,
           kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2, **kw)[1])
    what = f"dk/dv {dtype} H={h} S={s} D={d} Dv={dv} mask={use_mask}"
    before = (kh.hires_dkv.launches, kh.hires_dkv.cuda_core_launches,
              kh.hires_dkv.stage_launches)
    got = kh.hires_dkv(q, k, v, g, *res, **kw)
    again = kh.hires_dkv(q, k, v, g, *res, **kw)
    torch.cuda.synchronize()
    after = (kh.hires_dkv.launches, kh.hires_dkv.cuda_core_launches,
             kh.hires_dkv.stage_launches)
    if [a - b for a, b in zip(after, before)] != [2, 2, 0]:
        raise AssertionError(f"{what}: launches, CUDA-core launches, stage "
                             f"launches {before} -> {after}")
    nv = ka.dkv_split(d, dv)[2]
    if (dt != f32 or d % 4 or dv % 4) and nv == 3:   # the register path
        nv = 4
    if kh.hires_dkv.smem_bytes != ka.dkv_smem(nv):
        raise AssertionError(f"{what}: {kh.hires_dkv.smem_bytes} bytes of "
                             f"shared memory a CTA, the helper "
                             f"{ka.dkv_smem(nv)}")
    want = kh.hires_dkv_plain(q, k, v, g, *res, **kw)
    ref = kh.hires_dkv_plain(q.float(), k.float(), v.float(), g.float(),
                             *res, scale=kw["scale"], dtype=f32)
    worst = 0.0
    for name, x, y, r, z in zip(("dk", "dv"), got, want, ref, again):
        if not torch.equal(x, z):
            raise AssertionError(f"{what}: {name} differs between two "
                                 "launches")
        if dt == f32:
            e = norm_err(x, y)
            if not e <= BWD_FP32_LIMIT:
                raise AssertionError(f"{what}: {name} error {e:.3e} of its "
                                     "largest value")
        else:
            e_k, e_p = norm_err(x, r), norm_err(y, r)
            if not e_k <= 2 * e_p + 1e-6:
                raise AssertionError(f"{what}: {name} bf16 error {e_k:.3e} "
                                     f"> 2 x plain {e_p:.3e}")
            e = e_k / max(e_p, 1e-12)
        worst = max(worst, e)
    return worst


class NoiseSeq:
    """Injected training noise: call n draws standard normals from numpy
    seed 999 + n, the same on the card and on the CPU."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        self.i += 1
        return np.random.default_rng(999 + self.i).standard_normal(
            shape).astype(np.float32)


def hires_phases(torch, name, smi):
    """hires-cls-1024 (S up to 1024, head dims up to 256) through the hires
    attention route: check every kernel at every hires shape, serve, train,
    time and trace. Returns (kernel summaries, metrics)."""
    from torch.profiler import ProfilerActivity, profile

    from calm_vit_dte_tpu_torch.data.augment import eval_preprocess
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.ops.variational import noise_override
    from calm_vit_dte_tpu_torch.serve import (
        WARMUP_POWER_ITERATIONS,
        Predictor,
    )
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.tools import time_hires as th
    from calm_vit_dte_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    cfg = get_config("hires-cls-1024")
    attn_shapes, conv_sizes = flagship_shapes(cfg.model)
    # The rotation and the content++rope concat run in torch on this route,
    # so the kernels see (S, D = Dc + Dr, Dv).
    kernel_shapes: dict[tuple, int] = {}
    for (s, dc, dr, dv), n in attn_shapes.items():
        kernel_shapes[(s, dc + dr, dv)] = kernel_shapes.get(
            (s, dc + dr, dv), 0) + n
    log(f"[hires] attention shapes (S, Dc, Dr, Dv): launches = {attn_shapes}"
        f"; kernel shapes (S, D, Dv) = {kernel_shapes}; conv S: launches = "
        f"{conv_sizes}")

    # check: every kernel at every hires shape, and with zero mask weights.
    t0 = time.time()
    worst: dict[tuple, dict] = {}
    for i, (s, dc, dr, dv) in enumerate(sorted(attn_shapes, reverse=True)):
        w = check_hires_shape(torch, ka, kh, s, dc + dr, dv, seed=800 + 2 * i)
        key = (s, dc + dr, dv)
        worst[key] = {k: max(v, worst.get(key, {}).get(k, 0.0))
                      for k, v in w.items() if not isinstance(v, dict)}
        log(f"[hires check] S={s} Dc={dc} Dr={dr} Dv={dv}: fp32 max err "
            f"fwd_res {w['fwd_res']:.3e}, fwd_only {w['fwd_only']:.3e}, dq "
            f"pass {w['dq']:.3e}, dkv pass {w['dkv']:.3e}, backward worst "
            f"{w['bwd_norm']:.3e} of the largest value; bf16 worst "
            f"{w['bf16_ratio']:.3f} x the plain bf16 error")
    s, d, dv = min(kernel_shapes)
    w = check_hires_shape(torch, ka, kh, s, d, dv, seed=850, zero_mask=True)
    log(f"[hires check] S={s} D={d} with zero mask weights (the route's "
        f"use_mask=False): backward worst {w['bwd_norm']:.3e}, bf16 worst "
        f"{w['bf16_ratio']:.3f} x plain")
    args = hires_inputs(torch, 2, s, d, dv, dev, f32, seed=860)
    g = grad_like(torch, 2, s, dv, dev, f32, seed=861)

    def autograd_of(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, scale=d ** -0.5, dtype=f32).backward(g)
        return [a.grad for a in leaves]

    fn_err = max(norm_err(x, y) for x, y in zip(
        autograd_of(kh.fused_hires_attention),
        autograd_of(lambda *a, **k: ka.attention_core(*a, use_mask=True,
                                                      **k))))
    if not fn_err <= BWD_FP32_LIMIT:
        raise AssertionError(f"hires Function vs autograd of the plain "
                             f"forward: {fn_err:.3e}")
    log(f"[hires check] Function vs torch autograd of the plain forward (S="
        f"{s}, D={d}): worst gradient error {fn_err:.3e} of its largest "
        f"value; checks took {time.time() - t0:.1f} s")
    del args, g

    # bf16, run to run: the forwards, the dq pass (with its weight grads)
    # and the dk/dv pass give the same bits from two launches at the widest
    # shape.
    s, d, dv = max(kernel_shapes)
    q, k, v, w1, b1, w2, b2 = hires_inputs(torch, HIRES_CHECK_BATCH, s, d, dv,
                                           dev, bf16, seed=870)
    g = grad_like(torch, HIRES_CHECK_BATCH, s, dv, dev, bf16, seed=871)
    kw16 = dict(scale=d ** -0.5, dtype=bf16)

    def bf16_outputs():
        o, m, lse = kh.hires_fwd_res(q, k, v, w1, b1, w2, b2, **kw16)
        delta = (g.float() * o.float()).sum(-1)
        dq_out = kh.hires_dq(q, k, v, g, m, lse, delta, w1, b1, w2, **kw16)
        return (o, m, lse, kh.fused_attention_forward(q, k, v, w1, b1, w2,
                                                      b2, **kw16),
                *dq_out, *kh.hires_dkv(q, k, v, g, m, lse, delta, dq_out[1],
                                       **kw16))

    names = ("o", "m", "lse", "forward-only o") + HIRES_OUT_NAMES
    for n_, x, y in zip(names, bf16_outputs(), bf16_outputs()):
        if not torch.equal(x, y):
            raise AssertionError(f"hires bf16 {n_} at S={s} D={d} differs "
                                 "between two runs")
    log(f"[hires check] bf16 forward, forward-only, dq and dk/dv passes at "
        f"S={s}, D={d}: {len(names)} outputs bit-identical from run to run")
    del q, k, v, w1, b1, w2, b2, g

    def counts():
        return {"fwd_res": kh.fused_hires_attention.launches,
                "dq": kh.hires_dq.launches,
                "weight_grads": kh.hires_weight_grads.launches,
                "dkv": kh.hires_dkv.launches,
                "fwd_only": kh.fused_attention_forward.launches,
                "rope_fwd": ka.fused_rope_attention.launches,
                "rope_bwd": ka.fused_rope_attention_bwd.launches,
                "conv": kc.fused_conv_residual.launches}

    staged = {"fwd_res": kh.fused_hires_attention, "dq": kh.hires_dq,
              "weight_grads": kh.hires_weight_grads, "dkv": kh.hires_dkv,
              "fwd_only": kh.fused_attention_forward}

    def stages():
        return {k: w.stage_launches for k, w in staged.items()}

    def zero_counts():
        kh.fused_hires_attention.launches = kh.hires_dq.launches = 0
        kh.hires_weight_grads.launches = kh.hires_dkv.launches = 0
        kh.fused_attention_forward.launches = 0
        ka.fused_rope_attention.launches = 0
        ka.fused_rope_attention_bwd.launches = 0
        kc.fused_conv_residual.launches = 0
        for w in staged.values():
            w.stage_launches = 0

    def check_stages(what, got, launched):
        want = {k: HIRES_STAGES_PER_CALL[k] * launched[k] for k in staged}
        if got != want:
            raise AssertionError(f"hires {what}: stage launches {got}, "
                                 f"expected {want}")

    none = dict.fromkeys(counts(), 0)

    # serve: Predictor.fresh(...).classify, uint8 1168 x 1168 -> 1024 crop.
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (HIRES_BATCH, cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    t0 = time.time()
    pred = Predictor.fresh("hires-cls-1024", seed=0, device="cuda")
    log(f"[hires serve] Predictor.fresh: {time.time() - t0:.1f} s")
    zero_counts()
    labels, probs = pred.classify(images)
    serve_counts, serve_stages = counts(), stages()
    want = dict(none, fwd_only=24, conv=8)
    log(f"[hires serve] classify B={HIRES_BATCH} bf16: launches "
        f"{serve_counts}, stage launches {serve_stages}, top-5 of image 0 "
        f"{labels[0].tolist()}")
    if serve_counts != want:
        raise AssertionError(f"hires classify: expected {want}, got "
                             f"{serve_counts}")
    check_stages("classify", serve_stages, serve_counts)
    if labels.shape != (HIRES_BATCH, 5) or not np.isfinite(probs).all():
        raise AssertionError("hires classify: bad shape or non-finite")
    p32 = Predictor(pred.model, crop=cfg.crop, dtype=f32)
    l_gpu, kl_gpu = p32.predict(images[:1])
    t0 = time.perf_counter()
    p_cpu = Predictor(copy.deepcopy(pred.model).cpu(), crop=cfg.crop,
                      dtype=f32)
    l_cpu, kl_cpu = p_cpu.predict(images[:1])
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(kl_gpu.cpu(), kl_cpu, rtol=1e-3, atol=0.0)
    log(f"[hires serve] fp32 card vs CPU logits (1 image): max abs diff "
        f"{max_err(l_gpu.cpu(), l_cpu):.3e} (|logits| max "
        f"{float(l_cpu.abs().max()):.3e}); KL {float(kl_gpu):.6f} vs "
        f"{float(kl_cpu):.6f}; the CPU forward took {cpu_s:.1f} s")
    del p_cpu, p32
    pred.classify(images)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.classify(images)
    elapsed = time.perf_counter() - t0
    serve = {"batch": HIRES_BATCH, "dtype": "bfloat16",
             "images_per_s": reps * HIRES_BATCH / elapsed,
             "ms_per_call": elapsed / reps * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[hires time] classify B={HIRES_BATCH} bf16: "
        f"{serve['images_per_s']:.3f} images/s ({serve['ms_per_call']:.1f} "
        f"ms per call), peak memory {serve['peak_mem_gib']:.3f} GiB, on "
        f"{name} ({smi})")
    del pred
    torch.cuda.empty_cache()

    # train: make_train_step at full width and depth, bf16, remat, B=8.
    soft = rng.random((HIRES_BATCH, cfg.model.out_features)).astype(
        np.float32)
    soft[np.arange(HIRES_BATCH), rng.integers(0, cfg.model.out_features,
                                              HIRES_BATCH)] += 50.0
    batch = {"image": images, "label": soft / soft.sum(-1, keepdims=True)}

    def preprocess(generator, b):
        # The JAX hires recipe's eval crop (scripts/bench_hires_train.py).
        return {"image": eval_preprocess(b["image"], crop=cfg.crop),
                "label": b["label"]}

    def optimizer():
        # The config's lr at its global batch of 64, scaled to B=8.
        return make_optimizer(
            base_lr=cfg.lr * HIRES_BATCH / cfg.global_batch_size,
            weight_decay=cfg.weight_decay, b1=cfg.beta1, b2=cfg.beta2,
            epochs=cfg.epochs, steps_per_epoch=1000, clip_norm=cfg.clip_norm,
            eta_min=cfg.eta_min, schedule=cfg.schedule,
            decoupled_wd=cfg.decoupled_wd)

    t0 = time.time()
    _, model = create_vit("hires-cls-1024", seed=cfg.init_seed,
                          device="cuda")
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    start_state = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
    tx = optimizer()
    state = create_train_state(model, tx, seed=0)
    train_step = make_train_step(cfg.model, tx, "cls", dtype=bf16,
                                 remat=cfg.remat, preprocess=preprocess,
                                 microbatches=1)
    log(f"[hires train] model, power iterations and optimizer state: "
        f"{time.time() - t0:.1f} s")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, step_counts = [], [], None
    want = dict(none, fwd_res=24, dq=24, weight_grads=24, dkv=24)
    for i in range(HIRES_TRAIN_STEPS):
        before, before_stages = counts(), stages()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        step_counts = {k: v - before[k] for k, v in counts().items()}
        step_stages = {k: v - before_stages[k] for k, v in stages().items()}
        log(f"[hires train] step {i}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.4f}, kl {m['kl']:.6f}, {step_ms[-1]:.1f} ms, "
            f"launches {step_counts}, stage launches {step_stages}")
        if step_counts != want:
            raise AssertionError(f"hires training step: expected {want}, "
                                 f"got {step_counts}")
        check_stages(f"training step {i}", step_stages, step_counts)
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"hires step {i}: {m}")
        if i == 0:
            dead = [k for k, p_ in model.named_parameters()
                    if p_.grad is None or not torch.isfinite(p_.grad).all()
                    or float(p_.grad.abs().max()) == 0.0]
            if dead:
                raise AssertionError(f"hires parameters with no, non-finite "
                                     f"or zero first-step gradient: {dead}")
    train_counts, train_stages = counts(), stages()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"hires loss did not fall: {losses}")
    steady = float(np.mean(step_ms[1:]))
    train = {"batch": HIRES_BATCH, "dtype": "bfloat16", "remat": cfg.remat,
             "microbatches": 1, "ms_per_step": steady,
             "first_step_ms": step_ms[0],
             "images_per_s": HIRES_BATCH / steady * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "losses": losses}
    log(f"[hires time] training B={HIRES_BATCH} bf16 remat: {steady:.1f} ms "
        f"per step (steps 1-{HIRES_TRAIN_STEPS - 1}; first "
        f"{step_ms[0]:.1f}), {train['images_per_s']:.3f} images/s, peak "
        f"memory {train['peak_mem_gib']:.3f} GiB, on {name} ({smi})")

    zero_counts()
    ev = make_eval_step(cfg.model, "cls", dtype=bf16)(
        state, {"image": eval_preprocess(torch.from_numpy(images).to(dev),
                                         crop=cfg.crop),
                "label": batch["label"].argmax(-1)})
    eval_counts, eval_stages = counts(), stages()
    log(f"[hires train] eval step: {int(ev['correct'])} of "
        f"{int(ev['total'])} correct, launches {eval_counts}, stage "
        f"launches {eval_stages}")
    if eval_counts != dict(none, fwd_only=24, conv=8) or not torch.isfinite(
            ev["kl"]):
        raise AssertionError(f"hires eval step: {eval_counts}, {ev}")
    check_stages("eval step", eval_stages, eval_counts)

    # trace one training step: device busy share, the attention kernels'.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    parts = th.split(events)
    parts.pop("other")
    attn_ms = sum(parts.values())
    trace = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
             "attention_ms": attn_ms, "parts_ms": parts,
             "attention_share_of_busy": attn_ms / busy_ms}
    log(f"[hires trace] one training step B={HIRES_BATCH} bf16: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"kernels; hires attention kernels {attn_ms:.1f} ms "
        f"({attn_ms / busy_ms:.1%} of busy): "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[hires trace] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")
    del state, train_step, tx, model, ev
    torch.cuda.empty_cache()

    # One fp32 step on 1 image, card (remat) vs CPU (no remat), same weights
    # and injected noise.
    small = {k: v[:1] for k, v in batch.items()}
    sides = {}
    for side, remat in (("cuda", True), ("cpu", False)):
        t0 = time.perf_counter()
        _, m_side = create_vit("hires-cls-1024", device=side)
        m_side.load_state_dict(start_state)
        tx_side = optimizer()
        step_side = make_train_step(cfg.model, tx_side, "cls", dtype=f32,
                                    remat=remat, preprocess=preprocess)
        with noise_override(NoiseSeq()):
            _, m = step_side(create_train_state(m_side, tx_side, seed=0),
                             small)
        sides[side] = ({k: float(v) for k, v in m.items()},
                       {k: p_.grad.cpu() for k, p_ in
                        m_side.named_parameters()})
        log(f"[hires train] fp32 step on 1 image on {side} (remat={remat}): "
            f"loss {sides[side][0]['loss']:.6f}, "
            f"{time.perf_counter() - t0:.1f} s")
        del m_side, tx_side, step_side
        torch.cuda.empty_cache()
    (m_gpu, g_gpu), (m_cpu, g_cpu) = sides["cuda"], sides["cpu"]
    np.testing.assert_allclose(m_gpu["loss"], m_cpu["loss"], rtol=2e-4)
    worst_leaf = ("", 0.0)
    for k, want_g in g_cpu.items():
        top = max(float(want_g.abs().max()), 1e-12)
        torch.testing.assert_close(g_gpu[k], want_g, rtol=5e-3,
                                   atol=2e-4 * top, msg=lambda m_, k=k:
                                   f"hires gradient of {k}: {m_}")
        worst_leaf = max(worst_leaf, (k, max_err(g_gpu[k], want_g) / top),
                         key=lambda t: t[1])
    log(f"[hires train] fp32 card vs CPU: loss {m_gpu['loss']:.6f} vs "
        f"{m_cpu['loss']:.6f}; {len(g_cpu)} gradient leaves within rtol "
        f"5e-3 / atol 2e-4 of each leaf's largest value; worst "
        f"{worst_leaf[0]} at {worst_leaf[1]:.3e}")
    del sides, g_gpu, g_cpu, start_state

    # time: each kernel and its plain version at B=8 bf16, per kernel shape.
    rows = {k: [] for k in ("fwd_res", "dq", "dkv", "fwd_only")}
    for i, ((s, d, dv), n) in enumerate(sorted(kernel_shapes.items(),
                                               reverse=True)):
        args = hires_inputs(torch, HIRES_BATCH, s, d, dv, dev, bf16,
                            seed=900 + i)
        g = grad_like(torch, HIRES_BATCH, s, dv, dev, bf16, seed=950 + i)
        kw = dict(scale=d ** -0.5, dtype=bf16)
        res = kh.hires_fwd_res_plain(*args, **kw)
        o, m, lse = res
        delta = (g.float() * o.float()).sum(-1)
        q, k, v, w1, b1, w2, _ = args
        dssum = kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2,
                                  **kw)[1]
        calls = {
            "fwd_res": (lambda: kh.hires_fwd_res(*args, **kw),
                        lambda: kh.hires_fwd_res_plain(*args, **kw)),
            "fwd_only": (lambda: kh.fused_attention_forward(*args, **kw),
                         lambda: ka.attention_core(*args, use_mask=True,
                                                   **kw)),
            "dq": (lambda: kh.hires_dq(q, k, v, g, m, lse, delta, w1, b1,
                                       w2, **kw),
                   lambda: kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1,
                                             b1, w2, **kw)),
            "dkv": (lambda: kh.hires_dkv(q, k, v, g, m, lse, delta, dssum,
                                         **kw),
                    lambda: kh.hires_dkv_plain(q, k, v, g, m, lse, delta,
                                               dssum, **kw)),
        }
        bounds = hires_bounds(HIRES_BATCH, s, d, dv, 2)
        # The library calls that compute the parts (yardsticks only).
        lib = th.yardsticks(args, 5)
        lib_parts = {
            "fwd_res": {"attention forward": lib["sdpa"],
                        "strided product": lib["matmul ssum"]
                        + lib["matmul h1"] + lib["matmul m"]},
            "dq": {"strided product": lib["matmul h1"] + lib["matmul dh1"]
                   + lib["matmul dssum"] + lib["matmul dW1"]
                   + lib["matmul dW2"]},
            "dkv": {"dk/dv": lib["matmul k q^T"] + lib["matmul v g^T"]
                    + lib["matmul p^T g"] + lib["matmul ds^T q"]}}
        lib_parts["fwd_only"] = lib_parts["fwd_res"]
        log(f"[hires time] S={s} D={d}: library yardsticks (ms) "
            + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in lib.items()))
        for kname, (kern, plain) in calls.items():
            ms = cuda_ms(torch, kern, 3, warmup=1)
            plain_ms = cuda_ms(torch, plain, 2, warmup=1)
            parts_ms, traces = th.parts_ms(kern, 3)
            t_bytes, t_ops = bounds[kname]
            err = worst[(s, d, dv)]
            row = dict(S=s, D=d, Dv=dv, launches=n, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       fp32_err=err[kname], fp32_bwd_norm_err=err["bwd_norm"],
                       bf16_err_over_plain=err["bf16_ratio"],
                       parts_ms=parts_ms, parts_traces=traces,
                       parts_library_ms=lib_parts.get(kname, {}))
            if kname in staged:
                row["smem_per_cta"] = staged[kname].smem_bytes
            if kname == "dq":
                row["weight_grads_smem_per_cta"] = \
                    kh.hires_weight_grads.smem_bytes
            rows[kname].append(row)
            log(f"[hires time] {kname} S={s} D={d} Dv={dv} (x{n}): kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / ms:.2%} of bound; parts (device ms, "
                f"{traces} trace(s)) "
                + (", ".join(f"{k_} {v_:.3f}" for k_, v_ in parts_ms.items())
                   or "not measured"))
        del args, g, res, o, m, lse, delta, dssum, calls, q, k, v, lib
        torch.cuda.empty_cache()

    # The conv forward at the hires conv sizes, B=8 bf16: per hires forward
    # it runs once at each conv stage. Held against its plain version first
    # (within twice the plain bf16 version's error against the fp32 plain
    # version, two launches bit-identical), then timed.
    conv_rows, conv_floor = [], 0.0
    for s in sorted(conv_sizes, reverse=True):
        cargs = conv_inputs(torch, HIRES_BATCH, s, dev, bf16, seed=970 + s)
        k16 = kc.fused_conv_residual(*cargs, dtype=bf16)
        again = kc.fused_conv_residual(*cargs, dtype=bf16)
        p16 = kc.fused_conv_residual_plain(*cargs, dtype=bf16)
        ref = kc.fused_conv_residual_plain(cargs[0].float(), *cargs[1:],
                                           dtype=f32)
        torch.cuda.synchronize()
        if not torch.equal(k16, again):
            raise AssertionError(f"hires conv S={s}: two bf16 launches "
                                 "differ")
        e_k, e_p = max_err(k16, ref), max_err(p16, ref)
        if not e_k <= 2 * e_p:
            raise AssertionError(f"hires conv S={s}: bf16 kernel error "
                                 f"{e_k} > 2 x plain bf16 {e_p}")
        del k16, again, p16, ref
        ms = cuda_ms(torch, lambda: kc.fused_conv_residual(*cargs,
                                                           dtype=bf16), 10)
        plain_ms = cuda_ms(torch, lambda: kc.fused_conv_residual_plain(
            *cargs, dtype=bf16), 3, warmup=1)
        t_bytes, t_ops = conv_bound(HIRES_BATCH, s, 2)
        floor = conv_floor_ms("fwd", HIRES_BATCH, s)
        conv_floor += conv_sizes[s] * floor
        row = dict(config="hires-cls-1024", S=s, B=HIRES_BATCH, launches=0,
                   launches_hires=conv_sizes[s], ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bf16_err=e_k, plain_bf16_err=e_p)
        conv_rows.append(row)
        log(f"[hires check] conv forward S={s} B={HIRES_BATCH}: bf16 err "
            f"kernel {e_k:.3e} vs plain {e_p:.3e}, two launches "
            "bit-identical")
        log(f"[hires time] conv forward S={s} B={HIRES_BATCH} "
            f"(x{conv_sizes[s]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"CUDA-core floor {floor:.4f} ms")
        del cargs
        torch.cuda.empty_cache()
    hires_conv = {
        "per_forward": {k: sum(r["launches_hires"] * r[k] for r in conv_rows)
                        for k in ("ms", "plain_ms", "bound_ms")},
        "rows": conv_rows,
        "launches": {"hires_classify": serve_counts["conv"],
                     "hires_eval_step": eval_counts["conv"]}}
    log(f"[hires time] conv forward per hires forward (B={HIRES_BATCH}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    hires_conv["per_forward"].items())
        + f", CUDA-core floor {conv_floor:.4f}; on {name} ({smi})")

    per_step = f"train_{HIRES_TRAIN_STEPS}_steps"
    stage_launches = {
        "fwd_res": {per_step: train_stages["fwd_res"]},
        "dq": {per_step: train_stages["dq"],
               "weight_grad_reductions": train_stages["weight_grads"]},
        "dkv": {per_step: train_stages["dkv"]},
        "fwd_only": {"classify": serve_stages["fwd_only"],
                     "eval_step": eval_stages["fwd_only"]},
    }
    launches = {
        "fwd_res": {per_step: train_counts["fwd_res"]},
        "dq": {per_step: train_counts["dq"],
               "weight_grad_reductions": train_counts["weight_grads"]},
        "dkv": {per_step: train_counts["dkv"]},
        "fwd_only": {"classify": serve_counts["fwd_only"],
                     "eval_step": eval_counts["fwd_only"]},
    }
    meta = {
        "fwd_res": ("hires_attention_fwd_res", kh.SOURCE,
                    kh.REPLACES_FWD_RES),
        "dq": ("hires_attention_dq", kh.BWD_SOURCE, kh.REPLACES_DQ),
        "dkv": ("hires_attention_dkv", kh.BWD_SOURCE, kh.REPLACES_DKV),
        "fwd_only": ("hires_attention_fwd_only", kh.SOURCE,
                     kh.REPLACES_FWD_ONLY),
    }
    kernels = []
    for key, (kname, source, replaces) in meta.items():
        r = rows[key]
        t_bytes = sum(x["launches"] * x["bound_ms"] for x in r
                      if x["bound_by"] == "bytes")
        t_ops = sum(x["launches"] * x["bound_ms"] for x in r
                    if x["bound_by"] == "operations")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[key].values()) - launches[key].get(
                "weight_grad_reductions", 0),
            "max_abs_err": max(x["fp32_err"] for x in r),
            "ms": sum(x["launches"] * x["ms"] for x in r),
            "plain_ms": sum(x["launches"] * x["plain_ms"] for x in r),
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches_by_path": launches[key],
            **({"stage_launches_by_path": stage_launches[key]}
               if key in stage_launches else {}),
            "per_shape": r})
    log("[hires time] hires kernels' ms, plain_ms and bound_ms are per "
        f"hires-cls-1024 forward (or training step's backward) at "
        f"B={HIRES_BATCH} bf16; dq includes its weight-grad reduction")
    return kernels, {"classify": serve, "train": train, "trace": trace,
                     "conv_fwd": hires_conv}


TRAINER_STEPS = 6
CONV_BWD_NAMES = ("dx",) + tuple(f"wg[:, {j}]" for j in range(24))


def conv_resid_bound(b, s, itemsize, peak=PEAK_BF16_FLOPS):
    """The forward with residuals: reads x, writes y, h and acc (3 + 3 + 32
    + 32 values per pixel); the forward's operations."""
    nbytes = b * s * s * 70 * itemsize + (96 + 32 + 288 + 32 + 96 + 3) * 4
    flops = 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


def conv_bwd_bound(b, s, itemsize, peak=PEAK_BF16_FLOPS):
    """The backward: reads x and g, writes dx (3 values per pixel each) and
    the (32, 24) fp32 weight grads; three times the forward's operations."""
    nbytes = (b * s * s * 9 * itemsize + (96 + 32 + 288 + 32 + 96) * 4
              + 32 * 24 * 4)
    flops = 3 * 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3


def check_conv_training_kernels(torch, kc, abl, s, seed):
    """The forward with residuals and the backward against their plain
    versions at B=CHECK_BATCH: fp32 forward outputs at rtol 2e-4 / atol
    2e-5, fp32 backward outputs within BWD_FP32_LIMIT of each one's largest
    value, bf16 at most twice the plain bf16 error against the fp32 plain
    version; two bf16 launches of each kernel, two fp32 backward launches,
    and the ablation's FULL and the production backward, bit-identical.
    Returns the worst errors."""
    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    args = conv_inputs(torch, CHECK_BATCH, s, dev, f32, seed)
    g = torch.from_numpy((np.random.default_rng(seed + 1).standard_normal(
        (CHECK_BATCH, s, s, 3)) * 0.5).astype(np.float32)).to(dev)
    w = args[1:6]
    worst = {"fwd_resid": 0.0, "bwd": 0.0, "bwd_norm": 0.0,
             "bf16_ratio": 0.0}

    def bf16_ok(what, got, plain, ref, norm):
        err = norm_err if norm else max_err
        e_k, e_p = err(got, ref), err(plain, ref)
        if not e_k <= 2 * e_p + 1e-6:
            raise AssertionError(f"conv {what} S={s}: bf16 kernel error "
                                 f"{e_k:.3e} > 2 x plain {e_p:.3e}")
        if e_p > 1e-6:
            worst["bf16_ratio"] = max(worst["bf16_ratio"], e_k / e_p)

    got = kc.conv_residual_fwd_resid(*args, dtype=f32)
    want = kc.conv_residual_fwd_resid_plain(*args, dtype=f32)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        worst["fwd_resid"] = max(worst["fwd_resid"], max_err(x, y))
    got = kc.conv_residual_bwd(args[0], g, *w, dtype=f32)
    again = kc.conv_residual_bwd(args[0], g, *w, dtype=f32)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"conv backward S={s}: two fp32 launches "
                             "differ")
    want = kc.conv_residual_bwd_plain(args[0], g, *w, dtype=f32)
    outs = [got[0]] + [got[1][:, j] for j in range(24)]
    refs = [want[0]] + [want[1][:, j] for j in range(24)]
    for name, x, y in zip(CONV_BWD_NAMES, outs, refs):
        e = norm_err(x, y) if float(y.abs().max()) > 0 else max_err(x, y)
        if not e <= BWD_FP32_LIMIT:
            raise AssertionError(f"conv backward {name} S={s}: fp32 error "
                                 f"{e:.3e} of the largest value")
        worst["bwd_norm"] = max(worst["bwd_norm"], e)
        worst["bwd"] = max(worst["bwd"], max_err(x, y))

    x16, g16 = args[0].to(bf16), g.to(bf16)
    a16 = (x16,) + tuple(args[1:])
    k16 = kc.conv_residual_fwd_resid(*a16, dtype=bf16)
    if not all(torch.equal(a, b) for a, b in zip(
            k16, kc.conv_residual_fwd_resid(*a16, dtype=bf16))):
        raise AssertionError(f"conv forward with residuals S={s}: two bf16 "
                             "launches differ")
    for what, k, p, r in zip(
            ("y", "h", "acc"), k16,
            kc.conv_residual_fwd_resid_plain(*a16, dtype=bf16),
            kc.conv_residual_fwd_resid_plain(x16.float(), *args[1:],
                                             dtype=f32)):
        bf16_ok(what, k, p, r, norm=False)
    k16 = kc.conv_residual_bwd(x16, g16, *w, dtype=bf16)
    p16 = kc.conv_residual_bwd_plain(x16, g16, *w, dtype=bf16)
    r32 = kc.conv_residual_bwd_plain(x16.float(), g16.float(), *w, dtype=f32)
    for j, name in enumerate(CONV_BWD_NAMES):
        pick = (lambda t: t[0]) if j == 0 else (lambda t, j=j: t[1][:, j - 1])
        if float(pick(r32).abs().max()) > 0:
            bf16_ok(f"backward {name}", pick(k16), pick(p16), pick(r32),
                    norm=True)
    again = kc.conv_residual_bwd(x16, g16, *w, dtype=bf16)
    torch.cuda.synchronize()
    if not (torch.equal(k16[0], again[0]) and torch.equal(k16[1], again[1])):
        raise AssertionError(f"conv backward S={s}: two launches differ")
    if not abl.full_equals_production((x16, g16) + tuple(w)):
        raise AssertionError(f"ablation FULL S={s} differs from the "
                             "production backward")
    return worst


def trainer_phase(torch, name, smi, bare, keep_ckpt):
    """Phase 9: the classification trainer entry point on imagenet-cls-224
    with the fused conv residual in training. `bare` is phase 5's
    make_train_step measurement (same call). The chain route's step-6
    checkpoint is copied into the directory `keep_ckpt` for phase 10.
    Returns (kernel summaries, metrics)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.tools import ablate_conv_bwd as abl
    from calm_vit_dte_tpu_torch.train import checkpoint as ckpt_mod
    from calm_vit_dte_tpu_torch.train import train_cls
    from calm_vit_dte_tpu_torch.train import trainer as trainer_mod
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    cfg = get_config("imagenet-cls-224")
    _, conv_sizes = flagship_shapes(cfg.model)
    _, conv256 = flagship_shapes(get_config("imagenet-cls-256").model)
    t_phase = time.time()

    # 1. check both kernels at every conv S of the flagship and of
    # imagenet-cls-256, and the Function.
    t0 = time.time()
    per_s = {}
    for i, s in enumerate(sorted(set(conv_sizes) | set(conv256),
                                 reverse=True)):
        per_s[s] = check_conv_training_kernels(torch, kc, abl, s, 1000 + i)
        w = per_s[s]
        log(f"[trainer check] conv S={s}: fp32 max err forward with "
            f"residuals {w['fwd_resid']:.3e}, backward {w['bwd']:.3e} "
            f"(worst {w['bwd_norm']:.3e} of its largest value); bf16 worst "
            f"{w['bf16_ratio']:.3f} x the plain bf16 error; each kernel "
            "twice and the ablation's FULL bit-identical")
    args = conv_inputs(torch, 2, 80, dev, f32, seed=1100)
    g = torch.from_numpy(np.random.default_rng(1101).standard_normal(
        (2, 80, 80, 3)).astype(np.float32)).to(dev)

    def autograd_of(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, dtype=f32).backward(g)
        return [a.grad for a in leaves]

    want = autograd_of(kc.fused_conv_residual_plain)
    fn_err = {}
    for route in ("pallas", "xla"):
        os.environ["CALM_CONV_BWD"] = route
        try:
            fn_err[route] = max(norm_err(x, y) for x, y in zip(
                autograd_of(kc.fused_conv_residual_train), want))
        finally:
            del os.environ["CALM_CONV_BWD"]
        if not fn_err[route] <= BWD_FP32_LIMIT:
            raise AssertionError(f"conv Function ({route} route) vs "
                                 f"autograd of the plain forward: "
                                 f"{fn_err[route]:.3e}")
    log(f"[trainer check] conv Function vs torch autograd of the plain "
        f"forward (S=80): worst gradient error {fn_err['pallas']:.3e} "
        f"(pallas route), {fn_err['xla']:.3e} (xla route) of its largest "
        f"value; checks took {time.time() - t0:.1f} s")

    # 2. train through the entry point, three conv routes.
    counters = {"conv_fwd": kc.fused_conv_residual,
                "conv_fwd_resid": kc.conv_residual_fwd_resid,
                "conv_bwd": kc.conv_residual_bwd,
                "conv_wgrad_sum": kc.conv_weight_grad_sum,
                "attention_fwd": ka.fused_rope_attention,
                "attention_bwd": ka.fused_rope_attention_bwd}

    def counts():
        return {k: c.launches for k, c in counters.items()}

    zero = dict.fromkeys(counters, 0)
    attention = dict(zero, attention_fwd=24, attention_bwd=24)
    routes = {
        "chain": ({}, attention),
        "pallas": ({"CALM_CONV_FUSED": "1"},
                   dict(attention, conv_fwd=8, conv_bwd=8, conv_wgrad_sum=8)),
        "xla": ({"CALM_CONV_FUSED": "1", "CALM_CONV_BWD": "xla"},
                dict(attention, conv_fwd_resid=8)),
    }
    orig_make_step = trainer_mod.make_train_step
    per_step: list[dict] = []
    losses: list[float] = []

    def recording_make_step(*a, **k):
        step = orig_make_step(*a, **k)

        def wrapped(state, batch):
            if state.device.type != "cuda" or any(
                    v.device.type != "cuda" for v in batch.values()):
                raise AssertionError("the trainer's model or batch is not "
                                     "on the card")
            before = counts()
            state, metrics = step(state, batch)
            per_step.append({k_: v - before[k_] for k_, v in counts().items()})
            losses.append(float(metrics["loss"]))
            return state, metrics

        return wrapped

    class Tee(io.StringIO):
        """Keeps what the trainer prints and passes it on."""

        def __init__(self, real):
            super().__init__()
            self.real = real

        def write(self, text):
            self.real.write(text)
            return super().write(text)

    def run_main(argv):
        out = Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            state = train_cls.main(argv)
        torch.cuda.synchronize()
        return state, out.getvalue()

    trainer_mod.make_train_step = recording_make_step
    results = {}
    route_counts = {}
    try:
        for route, (env, want_step) in routes.items():
            os.environ.update(env)
            try:
                with tempfile.TemporaryDirectory() as ckpt:
                    argv = ["--config", "imagenet-cls-224", "global_batch_size"
                            f"={TIME_BATCH}", "dataset_root=synthetic",
                            f"checkpoint_dir={ckpt}", "log_every=1"]
                    per_step.clear()
                    losses.clear()
                    for k_ in counters.values():
                        k_.launches = 0
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    state, text = run_main(argv + ["--max-steps",
                                                   str(TRAINER_STEPS)])
                    wall = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    run_counts = counts()
                    p50 = float(re.search(r"p50 step: ([0-9.]+)s",
                                          text).group(1))
                    if len(per_step) != TRAINER_STEPS or any(
                            c != want_step for c in per_step):
                        raise AssertionError(f"trainer {route} route: "
                                             f"expected {want_step} per "
                                             f"step, got {per_step}")
                    if not all(np.isfinite(losses)):
                        raise AssertionError(f"trainer {route}: losses "
                                             f"{losses}")
                    if ckpt_mod.latest_step(ckpt) != TRAINER_STEPS:
                        raise AssertionError(f"trainer {route}: no "
                                             "checkpoint at the last step")
                    if route == "chain":
                        shutil.copy(os.path.join(
                            ckpt, f"step_{TRAINER_STEPS}.pt"), keep_ckpt)
                    first_losses = list(losses)
                    # The checkpoint restores the state bit for bit.
                    _, fresh = create_vit("imagenet-cls-224", seed=7,
                                          device="cuda")
                    other = create_train_state(fresh, make_optimizer(),
                                               seed=0)
                    ckpt_mod.restore_checkpoint(ckpt, other)
                    saved = state.model.state_dict()
                    same = all(torch.equal(v, saved[k_]) for k_, v in
                               other.model.state_dict().items())
                    same &= all(torch.equal(a, b) for a, b in zip(
                        other.opt_state.mu + other.opt_state.nu,
                        state.opt_state.mu + state.opt_state.nu))
                    same &= (other.step, other.seed, other.opt_state.count) \
                        == (state.step, state.seed, state.opt_state.count)
                    if not same:
                        raise AssertionError(f"trainer {route}: the restored"
                                             " state differs from the saved")
                    del fresh, other, state, saved
                    torch.cuda.empty_cache()
                    # A second main resumes from the checkpoint.
                    per_step.clear()
                    losses.clear()
                    state, text2 = run_main(argv + ["--max-steps", "1"])
                    if (f"resumed from step {TRAINER_STEPS}" not in text2
                            or state.step != TRAINER_STEPS + 1
                            or per_step != [want_step]
                            or not np.isfinite(losses[0])):
                        raise AssertionError(f"trainer {route}: resume "
                                             f"failed: step {state.step}, "
                                             f"{per_step}, {losses}")
                    del state
                    torch.cuda.empty_cache()
            finally:
                for k_ in env:
                    del os.environ[k_]
            route_counts[route] = run_counts
            results[route] = {
                "ms_per_step_p50": p50 * 1e3,
                "images_per_s": TIME_BATCH / p50,
                "wall_s_6_steps_with_setup": wall,
                "peak_mem_gib": peak, "losses": first_losses,
                "resumed_loss": losses[0]}
            log(f"[trainer] {route} route: train_cls.main "
                f"imagenet-cls-224 B={TIME_BATCH} bf16 remat, "
                f"{TRAINER_STEPS} steps: p50 {p50 * 1e3:.1f} ms per step, "
                f"{TIME_BATCH / p50:.2f} images/s; per step {per_step[0]}; "
                f"losses {[round(x, 4) for x in first_losses]}; peak "
                f"{peak:.3f} GiB; checkpoint restored bit for bit, resumed "
                f"at step {TRAINER_STEPS} (loss {losses[0]:.4f}); on {name} "
                f"({smi})")
        # Reconstruction training through train_reg.main on
        # imagenet-reg-224 (the F.conv2d chain in training).
        from calm_vit_dte_tpu_torch.train import train_reg

        with tempfile.TemporaryDirectory() as ckpt:
            per_step.clear()
            losses.clear()
            torch.cuda.reset_peak_memory_stats()
            out = Tee(sys.stdout)
            with contextlib.redirect_stdout(out):
                state = train_reg.main(
                    ["--config", "imagenet-reg-224", "--max-steps",
                     str(REG_STEPS), f"global_batch_size={TIME_BATCH}",
                     "dataset_root=synthetic", f"checkpoint_dir={ckpt}",
                     f"save_samples_dir={ckpt}/samples", "log_every=1"])
            torch.cuda.synchronize()
            found = re.search(r"p50 step: ([0-9.]+)s", out.getvalue())
            reg_p50 = float(found.group(1)) if found else float("nan")
            if (len(per_step) != REG_STEPS
                    or any(c != attention for c in per_step)
                    or not all(np.isfinite(losses))
                    or state.step != REG_STEPS):
                raise AssertionError(f"train_reg: per step {per_step}, "
                                     f"losses {losses}, step {state.step}")
            results["reg"] = {
                "ms_per_step_p50": reg_p50 * 1e3,
                "images_per_s": TIME_BATCH / reg_p50,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "losses": list(losses)}
            log(f"[trainer] train_reg.main imagenet-reg-224 B={TIME_BATCH} "
                f"bf16, {REG_STEPS} steps: losses "
                f"{[round(x, 5) for x in losses]}, per step {per_step[0]}, "
                f"p50 {reg_p50 * 1e3:.1f} ms per step, peak "
                f"{results['reg']['peak_mem_gib']:.3f} GiB")
            del state
            torch.cuda.empty_cache()
    finally:
        trainer_mod.make_train_step = orig_make_step
    log(f"[trainer] bare make_train_step (phase 5, same call): "
        f"{bare['ms_per_step']:.1f} ms per step, {bare['images_per_s']:.2f} "
        f"images/s; through the trainer (chain route, same conv): "
        f"{results['chain']['ms_per_step_p50']:.1f} ms, "
        f"{results['chain']['images_per_s']:.2f} images/s")

    # 3. time both kernels at every conv S, B=128 bf16, and the ablation.
    rows = {"fwd_resid": [], "bwd": []}
    floors = {"fwd_resid": 0.0, "bwd": 0.0}   # per step, for the log
    for s in sorted(conv_sizes, reverse=True):
        args = conv_inputs(torch, TIME_BATCH, s, dev, bf16, seed=1200 + s)
        g = torch.from_numpy((np.random.default_rng(s).standard_normal(
            (TIME_BATCH, s, s, 3)) * 0.5).astype(np.float32)).to(dev, bf16)
        w = args[1:6]
        calls = {
            "fwd_resid": (lambda: kc.conv_residual_fwd_resid(*args,
                                                             dtype=bf16),
                          lambda: kc.conv_residual_fwd_resid_plain(
                              *args, dtype=bf16), conv_resid_bound),
            "bwd": (lambda: kc.conv_residual_bwd(args[0], g, *w, dtype=bf16),
                    lambda: kc.conv_residual_bwd_plain(args[0], g, *w,
                                                       dtype=bf16),
                    conv_bwd_bound)}
        for key, (kern, plain, bound) in calls.items():
            ms = cuda_ms(torch, kern, 10)
            plain_ms = cuda_ms(torch, plain, 2, warmup=1)
            t_bytes, t_ops = bound(TIME_BATCH, s, 2)
            floor = conv_floor_ms(key, TIME_BATCH, s)
            floors[key] += conv_sizes[s] * floor
            row = dict(S=s, launches=conv_sizes[s], ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       fp32_err=per_s[s][key], bf16_err_over_plain=per_s[s][
                           "bf16_ratio"])
            rows[key].append(row)
            log(f"[trainer time] {key} S={s}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), {row['bound_ms'] / ms:.2%} of bound; "
                f"CUDA-core floor {floor:.4f} ms, {floor / ms:.1%} of it")
        del args, g, w, calls
        torch.cuda.empty_cache()
    abl.ablated_bwd.launches = 0
    ab_args = abl.inputs(TIME_BATCH, 224, dev)
    ab_rows = abl.run(ab_args, reps=10)
    ab_launches = abl.ablated_bwd.launches
    full = next(r for r in ab_rows if r["variant"] == "FULL")
    for r in ab_rows:
        log(f"[trainer ablation] {abl.describe(r)}" + (
            "" if r["ms"] is None else
            f" per backward (B={TIME_BATCH}, S=224, bf16)"))
    ab_plain = cuda_ms(torch, lambda: kc.conv_residual_bwd_plain(
        ab_args[0], ab_args[1], *ab_args[2:], dtype=bf16), 2, warmup=1)
    ab_bytes, ab_ops = conv_bwd_bound(TIME_BATCH, 224, 2)
    del ab_args

    def summary(kname, source, replaces, r, by_path):
        t_bytes = sum(x["launches"] * x["bound_ms"] for x in r
                      if x["bound_by"] == "bytes")
        t_ops = sum(x["launches"] * x["bound_ms"] for x in r
                    if x["bound_by"] == "operations")
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": max(x["fp32_err"] for x in r),
                "ms": sum(x["launches"] * x["ms"] for x in r),
                "plain_ms": sum(x["launches"] * x["plain_ms"] for x in r),
                "bound_ms": t_bytes + t_ops,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "launches_by_path": by_path,
                "per_shape": r}

    steps = f"trainer_{TRAINER_STEPS}_steps"
    kernels = [
        summary("conv_residual_fwd_resid", kc.SOURCE, kc.REPLACES_FWD_RESID,
                rows["fwd_resid"],
                {f"{steps}_xla_route": route_counts["xla"]["conv_fwd_resid"]}),
        summary("conv_residual_bwd", kc.BWD_SOURCE, kc.REPLACES_BWD,
                rows["bwd"],
                {f"{steps}_pallas_route": route_counts["pallas"]["conv_bwd"]}),
        {"name": "conv_residual_bwd_ablation", "route": "cuda",
         "source": "calm_vit_dte_tpu_torch/tools/ablate_conv_bwd.py + "
                   + kc.BWD_SOURCE,
         "replaces": "scripts/ablate_conv_bwd.py:119",
         "launches": ab_launches, "max_abs_err": 0.0, "ms": full["ms"],
         "plain_ms": ab_plain, "bound_ms": max(ab_bytes, ab_ops),
         "bound_by": "bytes" if ab_bytes >= ab_ops else "operations",
         "library_ms": None,
         "launches_by_path": {"ablate_conv_bwd.run": ab_launches},
         "variants": ab_rows},
    ]
    log(f"[trainer] phase 9 took {time.time() - t_phase:.1f} s")
    log("[trainer time] conv training kernels' ms, plain_ms and bound_ms are "
        f"per training step (8 launches) at B={TIME_BATCH} bf16; the "
        "backward includes its ordered weight-grad sum; the ablation row is "
        "one FULL backward at S=224 (max_abs_err: FULL vs the production "
        "kernel, bit-identical)")
    log(f"[trainer time] CUDA-core floor per training step: forward with "
        f"residuals {floors['fwd_resid']:.4f} ms, backward "
        f"{floors['bwd']:.4f} ms; the ablation's FULL backward at S=224 "
        f"{conv_floor_ms('bwd', TIME_BATCH, 224):.4f} ms")
    metrics = {"routes": results, "bare_make_train_step": bare,
               "function_err": fn_err,
               "conv_fwd_launches_pallas_route":
               route_counts["pallas"]["conv_fwd"]}
    return kernels, metrics


RELAYOUT_SHAPES = ((224, 56), (176, 44), (128, 32), (80, 20))
SERVE_IMAGES = 256
QUANT_REL_LIMIT = 0.15       # tests/test_quantize.py:157-162
QUANT_AGREE_LIMIT = 0.75


def relayout_bound(b, s, d, itemsize):
    """A copy: each element read once and written once, no operations."""
    return 2 * b * s * H * d * itemsize / PEAK_BYTES * 1e3


def serving_phase(torch, name, smi, ckpt):
    """Phase 10: the relayout kernel, the layout canaries, and what a user
    runs after training: serve phase 9's step-6 checkpoint (`ckpt`), save
    and load it as a serving artifact, evaluate its top-1 on a planted val
    split, and serve and evaluate it in int8. Returns (the relayout kernel's
    summary, forward launches by kind and the attention prologues,
    metrics)."""
    import contextlib
    import io
    import tempfile

    from PIL import Image

    from calm_vit_dte_tpu_torch.data.loader import ImageFolderDataset
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import relayout as kr
    from calm_vit_dte_tpu_torch.serve import Predictor
    from calm_vit_dte_tpu_torch.tools import canary_probes as canary
    from calm_vit_dte_tpu_torch.train import evaluate as ev
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    t_phase = t = time.time()
    laps = {}

    def lap(key, t0):
        laps[key] = time.time() - t0
        return time.time()

    # 1. the relayout kernel against its plain version: bit-identical at
    # every flagship head split in both dtypes; device times (CUDA-graph
    # replay, CUDA events) of the kernel and of the transpose, which is
    # also the one PyTorch call computing the function.
    rows = []
    for i, (s, d) in enumerate(RELAYOUT_SHAPES):
        x32 = torch.from_numpy(np.random.default_rng(1300 + i).standard_normal(
            (TIME_BATCH, s, H, d)).astype(np.float32)).to(dev)
        for dtype in (f32, bf16):
            x = x32.to(dtype)
            y = kr.swap_seq_heads(x)
            torch.cuda.synchronize()
            if not torch.equal(y, kr.swap_seq_heads_plain(x)):
                raise AssertionError(f"relayout S={s} D={d} {dtype}: not "
                                     "bit-identical to the transpose")
        x = x32.to(bf16)
        ms = canary.graph_ms(lambda: kr.swap_seq_heads(x))
        plain = canary.graph_ms(lambda: kr.swap_seq_heads_plain(x))
        row = dict(S=s, D=d, launches=int((s, d) == RELAYOUT_SHAPES[0]),
                   ms=ms, plain_ms=plain, library_ms=plain,
                   bound_ms=relayout_bound(TIME_BATCH, s, d, 2),
                   bound_by="bytes", fp32_err=0.0, bf16_err=0.0)
        rows.append(row)
        log(f"[relayout] (B,S,H,D)=({TIME_BATCH},{s},{H},{d}): bit-identical"
            f" to the transpose in fp32 and bf16; bf16 device time kernel "
            f"{ms * 1e3:.2f} us, transpose {plain * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us (bytes), "
            f"{row['bound_ms'] / ms:.1%} of bound")
        del x32, x, y
    try:
        kr.swap_seq_heads(torch.zeros(2, 8, H, 20, device=dev).transpose(1, 2))
    except ValueError:
        pass
    else:
        raise AssertionError("relayout: a non-contiguous input did not raise")
    t = lap("relayout", t)

    # 2. the canaries: the relayout kernel's main path.
    kr.swap_seq_heads.launches = 0
    canaries, flips = canary.run_canaries()
    relayout_launches = kr.swap_seq_heads.launches
    log(f"[canary] {json.dumps(canaries)}")
    for flip, todo in flips:
        log(f"[canary] OPPORTUNITY [{flip}]: {todo}")
    if relayout_launches < 1:
        raise AssertionError("run_canaries launched no relayout kernel")
    t = lap("canaries", t)

    # 3. serve the checkpoint; save and load it as a serving artifact.
    counters = {"attention": ka.fused_rope_attention,
                "conv": kc.fused_conv_residual}
    launches = dict.fromkeys(counters, 0)

    prologues = [0]

    def counted(fn, forwards):
        """Run fn with the counters at 0; exactly 24 attention and 8 conv
        launches per forward, and one attention prologue per attention
        launch."""
        for c in counters.values():
            c.launches = 0
        ka.fused_rope_attention.stage_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        want = {"attention": 24 * forwards, "conv": 8 * forwards}
        if got != want:
            raise AssertionError(f"{forwards} forwards: expected {want} "
                                 f"launches, got {got}")
        if ka.fused_rope_attention.stage_launches != got["attention"]:
            raise AssertionError(
                f"{forwards} forwards: {ka.fused_rope_attention.stage_launches}"
                f" attention prologues for {got['attention']} launches")
        for k in launches:
            launches[k] += got[k]
        prologues[0] += got["attention"]
        return out

    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (SERVE_IMAGES, 256, 256, 3), dtype=np.uint8)
    halves = (slice(0, TIME_BATCH), slice(TIME_BATCH, SERVE_IMAGES))
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    def logits_of(p):
        return torch.cat([counted(lambda: p.predict(images[h])[0], 1)
                          for h in halves]).float()

    t = time.time()
    pred = Predictor.from_checkpoint(ckpt, "imagenet-cls-224", device="cuda")
    before = counted(lambda: pred.classify(images[halves[0]]), 1)
    pred.save(str(root / "artifact"))
    loaded = Predictor.load(str(root / "artifact"), config="imagenet-cls-224",
                            device="cuda")
    after = counted(lambda: loaded.classify(images[halves[0]]), 1)
    l_before = counted(lambda: pred.predict(images[halves[0]])[0], 1)
    l_after = counted(lambda: loaded.predict(images[halves[0]])[0], 1)
    if not (all(np.array_equal(a, b) for a, b in zip(before, after))
            and torch.equal(l_before, l_after)):
        raise AssertionError("serve -> save -> load is not bit-identical")
    del loaded, l_before, l_after
    log(f"[serving] Predictor.from_checkpoint(step {TRAINER_STEPS}) -> "
        f"save -> load: classify and logits bit-identical on "
        f"{TIME_BATCH} images (artifact "
        f"{(root / 'artifact' / 'weights.pt').stat().st_size / 2**20:.1f} "
        "MiB)")
    t = lap("serve_save_load", t)

    # 4. classify rate and peak memory at B=128 per mode, each predictor
    # alone on the card; the logits of all images, against bf16's.
    rates, quant, logits = {}, {}, {}
    for q in (None, "int8", "int8-wo"):
        key = q or "bfloat16"
        if q is None:
            p, pred = pred, None
        else:
            p = Predictor.from_checkpoint(ckpt, "imagenet-cls-224",
                                          quantize=q, device="cuda")
        batch = images[halves[0]]
        counted(lambda: p.classify(batch), 1)   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = 5
        t0 = time.perf_counter()
        counted(lambda: [p.classify(batch) for _ in range(reps)], reps)
        elapsed = time.perf_counter() - t0
        rates[key] = {"images_per_s": reps * TIME_BATCH / elapsed,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2**30}
        logits[key] = logits_of(p)
        del p
        torch.cuda.empty_cache()
        log(f"[int8] classify {key} B={TIME_BATCH}: "
            f"{rates[key]['images_per_s']:.2f} images/s, peak memory "
            f"{rates[key]['peak_mem_gib']:.3f} GiB, on {name} ({smi})")
    base = logits["bfloat16"]
    t = lap("classify_rates", t)

    # 5. a planted val split: every class directory, labels = the
    # checkpoint's own bf16 top-1 on the images as the loader decodes them.
    split = root / "data" / "val"
    for c in range(1000):
        (split / f"c{c:04d}").mkdir(parents=True)

    def plant(labels_of):
        for f in split.glob("*/*.png"):
            f.unlink()
        for i, img in enumerate(images):
            Image.fromarray(img).save(
                split / f"c{labels_of[i]:04d}" / f"{i:03d}.png",
                compress_level=1)

    plant(np.zeros(SERVE_IMAGES, int))
    data = ImageFolderDataset(str(root / "data"), "val")
    decoded = np.stack([data.load(i)[0] for i in range(SERVE_IMAGES)])
    if not np.array_equal(decoded, images):
        raise AssertionError("the loader's decode differs from the images")
    labels = base.argmax(-1).cpu().numpy()
    cfg = get_config("imagenet-cls-224", dataset_root=str(root / "data"),
                     checkpoint_dir=ckpt, global_batch_size=TIME_BATCH)

    def run_eval(quantize=None):
        out = io.StringIO()
        stats = {}
        with contextlib.redirect_stdout(out):
            acc = counted(lambda: ev.evaluate(cfg, quantize=quantize,
                                              stats_out=stats),
                          SERVE_IMAGES // TIME_BATCH)
        text = out.getvalue()
        if f"evaluating checkpoint at step {TRAINER_STEPS}" not in text \
                or f"over {SERVE_IMAGES} images" not in text:
            raise AssertionError(f"evaluate printed {text!r}")
        return acc, stats

    evals = {}
    plant((labels + 1) % 1000)
    acc_off, _ = run_eval()
    plant(labels)
    acc, evals["bfloat16"] = run_eval()
    log(f"[evaluate] checkpoint at step {TRAINER_STEPS}, {SERVE_IMAGES} "
        f"planted images, batch {TIME_BATCH}: top-1 {acc:.4f} with its own "
        f"labels (limit >= 0.99), {acc_off:.4f} with labels offset by one "
        f"(limit <= 0.01); {int(round(acc * SERVE_IMAGES))} of "
        f"{SERVE_IMAGES} counted correct")
    if not (acc >= 0.99 and acc_off <= 0.01):
        raise AssertionError(f"planted top-1 {acc}, offset {acc_off}")
    t = lap("evaluate_bf16", t)

    # 6. int8: evaluate (top-1 on the bf16 labels = agreement with bf16)
    # and the relative logit error against bf16.
    for q in ("int8", "int8-wo"):
        agree, evals[q] = run_eval(q)
        rel = float(torch.linalg.norm(logits[q] - base)
                    / torch.linalg.norm(base))
        quant[q] = {"relative_logit_error": rel, "top1_agreement": agree}
        log(f"[int8] {q}: relative logit error vs bf16 {rel:.4f} (limit "
            f"< {QUANT_REL_LIMIT}), top-1 agreement {agree:.4f} (limit >= "
            f"{QUANT_AGREE_LIMIT})")
        if not (rel < QUANT_REL_LIMIT and agree >= QUANT_AGREE_LIMIT):
            raise AssertionError(f"{q}: {quant[q]}")
    for key, stats in evals.items():
        log(f"[evaluate] stats_out {key}: {stats}")
    lap("evaluate_int8", t)
    tmp.cleanup()
    log(f"[serving] phase 10 took {time.time() - t_phase:.1f} s; seconds by "
        f"part: { {k: round(v, 1) for k, v in laps.items()} }")

    main_row = rows[0]
    kernel = {
        "name": "swap_seq_heads", "route": "cuda", "source": kr.SOURCE,
        "replaces": kr.REPLACES, "also_replaces": kr.REPLACES_MODULE_PROBE,
        "launches": relayout_launches, "max_abs_err": 0.0,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "launches_by_path": {"run_canaries": relayout_launches},
        "per_shape": rows}
    metrics = {"canaries": canaries, "flips": [f for f, _ in flips],
               "seconds_by_part": laps,
               "top1_planted": acc, "top1_offset": acc_off,
               "evaluate_stats": evals, "int8": quant, "classify": rates,
               "forward_launches": launches}
    launches["attention_prologues"] = prologues[0]
    return kernel, launches, metrics


PROOF_DECODE_IMAGES = 64      # phase 11: the decode check's learnable corpus
PROOF_DECODE_REPS = 3
PROOF_MODEL_BATCH = 8
PROOF_STEPS = 100
PROOF_IMAGES = 128
NATIVE_PIL_LIMIT = 2          # tests/test_native.py:46


def native_probe():
    """Phase 1: g++, whether a program using the system's libjpeg links,
    and whether the port's native decoder (data/native.py) builds and loads
    (and which libjpeg it links), with the reason if it does not."""
    import shutil
    import tempfile

    from calm_vit_dte_tpu_torch.data import native

    gxx = shutil.which("g++")
    version = (subprocess.run([gxx, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.splitlines()[0]
               if gxx else "not found")
    links = "not tried (no g++)"
    if gxx:
        with tempfile.TemporaryDirectory() as d:
            src = Path(d) / "probe.cpp"
            src.write_text("#include <cstddef>\n#include <cstdio>\n"
                           "#include <jpeglib.h>\nint main() { "
                           "jpeg_decompress_struct c; jpeg_error_mgr e; "
                           "c.err = jpeg_std_error(&e); "
                           "jpeg_create_decompress(&c); "
                           "jpeg_destroy_decompress(&c); return 0; }\n")
            proc = subprocess.run([gxx, str(src), "-o", str(Path(d) / "p"),
                                   "-ljpeg"], capture_output=True,
                                  text=True, timeout=120)
            links = ("links" if proc.returncode == 0 else
                     f"does not link: {proc.stderr.strip()[-400:]}")
    t0 = time.time()
    ok = native.available()
    state = (f"built and loaded in {time.time() - t0:.1f} s at "
             f"{native.LIB_PATH.relative_to(ROOT)}, linking "
             f"{native.libjpeg()}" if ok else native.unavailable_reason())
    log(f"[probe] g++: {version}; the system's libjpeg {links}; the port's "
        f"native decoder: {state}")
    return {"gxx": version, "system_libjpeg": links, "native_decoder": ok,
            "native_libjpeg": native.libjpeg(),
            "native_reason": None if ok else state}


def proof_phase(torch, name, smi):
    """Phase 11: the slice's new paths. (a) the native decoder against
    Pillow on a learnable corpus and its decode rates; (b) Encoder8 and
    CALMLatentDiffusion at their default full widths: launches, finite
    outputs, fp32 card vs CPU; (c) a short overfit run through
    tools/train_proof on the flagship. Returns (launches by path and
    kernel, metrics)."""
    import os
    import shutil
    import tempfile

    from calm_vit_dte_tpu_torch.data import native
    from calm_vit_dte_tpu_torch.data.corpus import make_corpus
    from calm_vit_dte_tpu_torch.data.loader import ImageFolderDataset
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.models import (
        CALMLatentDiffusion,
        CALMLatentDiffusionConfig,
        Encoder8,
        Encoder8Config,
    )
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.serve import WARMUP_POWER_ITERATIONS
    from calm_vit_dte_tpu_torch.tools import train_proof

    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    t_phase = time.time()
    metrics: dict = {}
    by_path: dict = {}

    def zero_counts():
        for w in (ka.fused_rope_attention, ka.fused_rope_attention_bwd):
            w.launches = w.stage_launches = 0
        kc.fused_conv_residual.launches = 0
        for w in (kh.fused_hires_attention, kh.hires_dq, kh.hires_dkv,
                  kh.hires_weight_grads, kh.fused_attention_forward,
                  kc.conv_residual_fwd_resid, kc.conv_residual_bwd):
            w.launches = 0

    def read_counts(path, want, fp32=False):
        """The path's launches against `want` (attention forward, backward,
        conv forward); the rope calls' stage launches (`rope_counts`: in
        bf16 one prologue a forward, six a flagship backward); no hires or
        conv training kernel."""
        got = {"attention_fwd": ka.fused_rope_attention.launches,
               "attention_bwd": ka.fused_rope_attention_bwd.launches,
               "conv": kc.fused_conv_residual.launches}
        others = {w.__name__: w.launches for w in (
            kh.fused_hires_attention, kh.hires_dq, kh.hires_dkv,
            kh.hires_weight_grads, kh.fused_attention_forward,
            kc.conv_residual_fwd_resid, kc.conv_residual_bwd)}
        if got != want or any(others.values()):
            raise AssertionError(f"{path}: launches {got} (want {want}), "
                                 f"other kernels {others}")
        stages = rope_counts(ka, path, fp32)["stages"]
        by_path[path] = dict(got, stages=stages)
        log(f"[proof] {path}: {got['attention_fwd']} attention forward + "
            f"{got['attention_bwd']} backward + {got['conv']} conv forward "
            f"launches (stage launches {stages}); no hires or conv "
            "training kernel")

    # (a) the native decoder against Pillow over the same files.
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_proof_"))
    try:
        t0 = time.time()
        root = make_corpus(work / "learnable", n_train=PROOF_DECODE_IMAGES,
                           num_classes=10, mode="learnable", seed=12)
        ds = ImageFolderDataset(str(root), split="train", size=256)
        paths = [p for p, _ in ds.samples]
        log(f"[proof] corpus: {len(paths)} learnable JPEGs at 384 px in "
            f"{time.time() - t0:.1f} s")
        if not native.available():
            raise AssertionError(native.unavailable_reason())
        imgs, ok = native.decode_resize_batch(paths, 256)
        pil = np.stack([ds.load(i)[0] for i in range(len(ds))])
        diff = int(np.abs(imgs.astype(int) - pil.astype(int)).max())
        if not ok.all() or diff > NATIVE_PIL_LIMIT:
            raise AssertionError(f"native decode: ok {ok.sum()}/{len(ok)}, "
                                 f"max |native - Pillow| {diff} > "
                                 f"{NATIVE_PIL_LIMIT}")
        cores = os.cpu_count()

        def rate(fn):
            reads = []
            for _ in range(PROOF_DECODE_REPS):
                t0 = time.perf_counter()
                fn()
                reads.append(len(paths) / (time.perf_counter() - t0))
            return max(reads), reads

        rates = {
            f"native_{cores}_threads": rate(
                lambda: native.decode_resize_batch(paths, 256)),
            "native_1_thread": rate(
                lambda: native.decode_resize_batch(paths, 256, 1)),
            "pillow": rate(lambda: [ds.load(i) for i in range(len(ds))])}
        metrics["decode"] = {
            "images": len(paths), "source_px": 384, "out_px": 256,
            "host_cores": cores, "max_abs_native_vs_pillow": diff,
            "images_per_s": {k: v[0] for k, v in rates.items()},
            "images_per_s_reads": {k: v[1] for k, v in rates.items()}}
        log(f"[proof] native decode within {diff} of Pillow (limit "
            f"{NATIVE_PIL_LIMIT}) on {len(paths)} JPEGs 384 -> 256 px; "
            "images/s, best of "
            f"{PROOF_DECODE_REPS} (host clock, {cores} cores): "
            + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items()))

        # (b) Encoder8 and CALMLatentDiffusion at their default widths.
        models = {"encoder8": (Encoder8, Encoder8Config(), 24, 8),
                  "latent_diffusion": (CALMLatentDiffusion,
                                       CALMLatentDiffusionConfig(), 18, 6)}
        for path, (cls, mcfg, n_attn, n_conv) in models.items():
            cpu_model = cls(mcfg, torch.Generator().manual_seed(0)).eval()
            with torch.no_grad():   # converged sigma, as Predictor.fresh
                for _ in range(WARMUP_POWER_ITERATIONS):
                    normalize_tree(cpu_model, training=True)
            model = copy.deepcopy(cpu_model).to(dev)
            s = mcfg.seq_length
            gen = torch.Generator().manual_seed(11)
            x = torch.randn(PROOF_MODEL_BATCH, s, s, 3, generator=gen)
            zero_counts()
            with torch.no_grad():
                out = model(x.to(dev), dtype=bf16)
            torch.cuda.synchronize()
            read_counts(path, {"attention_fwd": n_attn, "attention_bwd": 0,
                               "conv": n_conv})
            y = out[0] if isinstance(out, tuple) else out
            if not torch.isfinite(y).all():
                raise AssertionError(f"{path}: bf16 outputs not finite")
            zero_counts()
            with torch.no_grad():
                card = model(x[:2].to(dev), dtype=f32)
            torch.cuda.synchronize()
            read_counts(f"{path}_fp32", {"attention_fwd": n_attn,
                                         "attention_bwd": 0,
                                         "conv": n_conv}, fp32=True)
            with torch.no_grad():
                host = cpu_model(x[:2], dtype=f32)
            card = card if isinstance(card, tuple) else (card,)
            host = host if isinstance(host, tuple) else (host,)
            torch.testing.assert_close(card[0].cpu(), host[0], rtol=2e-3,
                                       atol=2e-4)
            errs = {"max_abs_err_fp32_card_vs_cpu":
                    max_err(card[0].cpu(), host[0])}
            if len(card) == 2:   # the KL, at phase 4's rtol 1e-3
                torch.testing.assert_close(card[1].cpu(), host[1],
                                           rtol=1e-3, atol=0)
                errs["kl_card"], errs["kl_cpu"] = (float(card[1]),
                                                   float(host[1]))
            metrics[path] = {"config": dataclasses.asdict(mcfg),
                             "out_shape": list(y.shape),
                             "parameters": sum(p.numel() for p in
                                               model.parameters()), **errs}
            n_params = sum(p.numel() for p in model.parameters()) / 1e6
            log(f"[proof] {path} ({n_params:.2f}M parameters): bf16 "
                f"B={PROOF_MODEL_BATCH} "
                f"output {tuple(y.shape)} finite; fp32 card vs CPU on 2 "
                f"inputs max abs err {errs['max_abs_err_fp32_card_vs_cpu']:.3e}"
                " (rtol 2e-3 / atol 2e-4)"
                + (f", KL {errs['kl_card']:.6g} vs {errs['kl_cpu']:.6g}"
                   if len(card) == 2 else ""))
            del model, cpu_model, out, y, card, host
            torch.cuda.empty_cache()

        # (c) a short overfit run through the proof tool, flagship, B=128.
        zero_counts()
        t0 = time.time()
        res = train_proof.run([
            "overfit", "--steps", str(PROOF_STEPS), "--n-train",
            str(PROOF_IMAGES), "--eval-every", "50", "--lr", "1.5e-3",
            "--root", str(work / "memorize"), "--out", str(work / "out")])
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = res["step_losses"]
        evals = len(res["history"])
        path = f"proof_overfit_{PROOF_STEPS}_steps"
        read_counts(path, {"attention_fwd": 24 * (PROOF_STEPS + evals),
                           "attention_bwd": 24 * PROOF_STEPS,
                           "conv": 8 * evals})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"overfit: a loss is not finite: {losses}")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        if not last < first:
            raise AssertionError(f"overfit: last 10 steps' mean loss {last} "
                                 f"not below the first 10's {first}")
        if res["rope_launches_per_step"] != {"attention_fwd": [24],
                                             "attention_bwd": [24]}:
            raise AssertionError(f"overfit: launches per step "
                                 f"{res['rope_launches_per_step']}")
        if res["eval_launches_per_forward"] != {"attention": 24.0,
                                                "conv": 8.0}:
            raise AssertionError(f"overfit: eval launches "
                                 f"{res['eval_launches_per_forward']}")
        if res["decoder"] != "native" or res["pillow_images"]:
            raise AssertionError(f"overfit decoded with {res['decoder']} "
                                 f"({res['decoder_reason']}), "
                                 f"{res['pillow_images']} by Pillow")
        metrics["proof_overfit"] = {
            k: res[k] for k in ("steps", "batch", "lr", "n_train", "history",
                                "ms_per_step", "first_step_ms",
                                "peak_mem_gib", "decoder", "pillow_images",
                                "rope_launches_per_step",
                                "eval_launches_per_forward")}
        metrics["proof_overfit"].update(
            wall_s=wall, first_10_mean_loss=float(first),
            last_10_mean_loss=float(last))
        log(f"[proof] overfit {PROOF_STEPS} steps, {PROOF_IMAGES} memorize "
            f"images, B={res['batch']}, bf16, remat off: loss "
            f"{losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (first 10 mean {first:.4f}, last 10 "
            f"{last:.4f}); {res['history']}; {res['ms_per_step']:.1f} ms per "
            f"step after the first ({res['first_step_ms']:.1f}), peak "
            f"{res['peak_mem_gib']:.2f} GiB, 24 + 24 rope launches a step, "
            f"24 + 8 per eval forward, decoder {res['decoder']}; {wall:.1f} "
            f"s on {name} ({smi})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    metrics["seconds"] = time.time() - t_phase
    log(f"[proof] phase 11 in {metrics['seconds']:.1f} s")
    return by_path, metrics


JAXINIT_CONFIG = "imagenet-reg-224"   # phase 12: the committed JAX init table
JAXINIT_BATCH = 8
JAXINIT_STEPS = 3


def jax_weights_phase(torch, name, smi):
    """Phase 12: the JAX package's seed-0 imagenet-reg-224 weights in the
    port. (a) rebuilt on this host from the committed table
    (compat/jax_init.py), every leaf's digest matched; (b) a bf16
    reconstruct at B=8 from them (24 attention + 9 conv launches) and the
    fp32 forward card vs CPU on 2 images; (c) three train_reg.main steps at
    B=128 warm-started from a reference-format .pth of them (24 + 24 rope
    launches a step, 24 + 9 for the samples, the first step's weights the table's bit for bit,
    finite loss, nonzero gradient norm), the step_<n>.pt restored bit for
    bit and served through create_vit(weights=<dir>); (d) whether
    tensorstore imports (Orbax conversion is host-side either way).
    Returns (launches by path and kernel, metrics)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from calm_vit_dte_tpu_torch.compat import jax_init
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.serve import (
        WARMUP_POWER_ITERATIONS,
        Predictor,
    )
    from calm_vit_dte_tpu_torch.train import checkpoint as ckpt_mod
    from calm_vit_dte_tpu_torch.train import train_reg
    from calm_vit_dte_tpu_torch.train import trainer as trainer_mod
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    t_phase = time.time()
    cfg = get_config(JAXINIT_CONFIG)
    metrics: dict = {}
    by_path: dict = {}
    others = (kh.fused_hires_attention, kh.hires_dq, kh.hires_dkv,
              kh.hires_weight_grads, kh.fused_attention_forward,
              kc.conv_residual_fwd_resid, kc.conv_residual_bwd)

    def zero_counts():
        for w in (ka.fused_rope_attention, ka.fused_rope_attention_bwd):
            w.launches = w.stage_launches = 0
        for w in (kc.fused_conv_residual, *others):
            w.launches = 0

    def read_counts(path, want, fp32=False):
        got = {"attention_fwd": ka.fused_rope_attention.launches,
               "attention_bwd": ka.fused_rope_attention_bwd.launches,
               "conv": kc.fused_conv_residual.launches}
        other = {w.__name__: w.launches for w in others}
        if got != want or any(other.values()):
            raise AssertionError(f"{path}: launches {got} (want {want}), "
                                 f"other kernels {other}")
        # The fp32 route's stage launches checked (`rope_counts`), the bf16
        # paths' recorded.
        stages = (rope_counts(ka, path, True)["stages"] if fp32 else
                  {"attention_fwd": ka.fused_rope_attention.stage_launches,
                   "attention_bwd":
                       ka.fused_rope_attention_bwd.stage_launches})
        by_path[path] = dict(got, stages=stages)
        log(f"[jaxinit] {path}: {got['attention_fwd']} attention forward + "
            f"{got['attention_bwd']} backward + {got['conv']} conv forward "
            f"launches (stage launches {stages})")

    # (a) the weights, rebuilt from the table with numpy alone.
    t0 = time.time()
    table_path = jax_init.table_path(JAXINIT_CONFIG, 0)
    table = jax_init.load_table(table_path)
    sd = jax_init.state_dict_from_jax_init(table_path)
    n_values = sum(v.numel() for v in sd.values())
    metrics["table"] = {
        "file": table_path.name, "entries": len(sd), "values": n_values,
        "numpy_here": np.__version__, "seconds": time.time() - t0,
        **{k: table[k] for k in ("jax_version", "jax_threefry_partitionable",
                                 "numpy_version", "draws")}}
    log(f"[jaxinit] {table_path.name}: {len(sd)} entries, {n_values} values "
        f"rebuilt with numpy {np.__version__} in "
        f"{metrics['table']['seconds']:.1f} s, every digest matched (the "
        f"table: jax {table['jax_version']}, threefry_partitionable "
        f"{table['jax_threefry_partitionable']}, numpy "
        f"{table['numpy_version']}, {table['draws']} draws)")

    work = tempfile.mkdtemp(prefix="chip_smoke_jaxinit_")
    try:
        pth = os.path.join(work, "jax_init.pth")
        torch.save(sd, pth)
        images = np.random.default_rng(1200).integers(
            0, 256, (JAXINIT_BATCH, cfg.image_size, cfg.image_size, 3),
            dtype=np.uint8)

        # (b) reconstruct from those weights, u/v converged as
        # Predictor.fresh converges them.
        t0 = time.time()
        _, model = create_vit(JAXINIT_CONFIG, device="cuda", weights=pth)
        with torch.no_grad():
            for _ in range(WARMUP_POWER_ITERATIONS):
                normalize_tree(model, training=True)
        pred = Predictor(model, crop=cfg.crop, dtype=bf16,
                         config_name=JAXINIT_CONFIG)
        zero_counts()
        recon = pred.reconstruct(images)
        read_counts("jaxinit_reconstruct", {"attention_fwd": 24,
                                            "attention_bwd": 0, "conv": 9})
        if recon.shape != (JAXINIT_BATCH, cfg.crop, cfg.crop, 3) or not (
                np.isfinite(recon).all() and recon.min() >= 0
                and recon.max() <= 1):
            raise AssertionError("jaxinit reconstruct: bad shape or values "
                                 "outside [0, 1]")
        p32 = Predictor(pred.model, crop=cfg.crop, dtype=f32)
        zero_counts()
        card, kl_card = p32.predict(images[:2])
        read_counts("jaxinit_predict_fp32", {
            "attention_fwd": 24, "attention_bwd": 0,
            "conv": kc.fused_conv_residual.launches}, fp32=True)
        host = Predictor(copy.deepcopy(pred.model).cpu(), crop=cfg.crop,
                         dtype=f32)
        want, kl_host = host.predict(images[:2])
        torch.testing.assert_close(card.cpu(), want, rtol=2e-3, atol=2e-4)
        torch.testing.assert_close(kl_card.cpu(), kl_host, rtol=1e-3,
                                   atol=0.0)
        metrics["reconstruct"] = {
            "batch": JAXINIT_BATCH, "range": [float(recon.min()),
                                              float(recon.max())],
            "max_abs_err_fp32_card_vs_cpu": max_err(card.cpu(), want),
            "kl_card": float(kl_card), "kl_cpu": float(kl_host),
            "seconds": time.time() - t0}
        log(f"[jaxinit] reconstruct B={JAXINIT_BATCH} bf16 from the JAX "
            f"weights: range [{recon.min():.4f}, {recon.max():.4f}]; fp32 "
            f"card vs CPU on 2 images max abs err "
            f"{metrics['reconstruct']['max_abs_err_fp32_card_vs_cpu']:.3e} "
            f"(rtol 2e-3 / atol 2e-4), KL {float(kl_card):.6g} vs "
            f"{float(kl_host):.6g}")
        del model, pred, p32, host, card
        torch.cuda.empty_cache()

        # (c) three train_reg.main steps warm-started from the .pth.
        t0 = time.time()
        orig_make_step = trainer_mod.make_train_step
        per_step: list[dict] = []
        losses: list[float] = []
        gnorms: list[float] = []
        first_weights: list[bool] = []

        def launch_counts():
            return (ka.fused_rope_attention.launches,
                    ka.fused_rope_attention_bwd.launches)

        def recording_make_step(*a, **k):
            step = orig_make_step(*a, **k)

            def wrapped(state, batch):
                if not first_weights:
                    now = state.model.state_dict()
                    first_weights.append(all(
                        torch.equal(now[k_].cpu(), v) for k_, v in
                        sd.items()))
                before = launch_counts()
                state, m = step(state, batch)
                after = launch_counts()
                per_step.append({"attention_fwd": after[0] - before[0],
                                 "attention_bwd": after[1] - before[1]})
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                return state, m

            return wrapped

        ckpt = os.path.join(work, "ckpt")
        samples = os.path.join(work, "samples")
        trainer_mod.make_train_step = recording_make_step
        zero_counts()
        try:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                state = train_reg.main(
                    ["--config", JAXINIT_CONFIG, "--max-steps",
                     str(JAXINIT_STEPS), f"global_batch_size={TIME_BATCH}",
                     "dataset_root=synthetic", f"checkpoint_dir={ckpt}",
                     f"warm_start={pth}", f"save_samples_dir={samples}",
                     "log_every=1"])
            torch.cuda.synchronize()
        finally:
            trainer_mod.make_train_step = orig_make_step
        # The steps, and the epoch end's sample forward (24 + 9).
        read_counts(f"jaxinit_train_reg_{JAXINIT_STEPS}_steps",
                    {"attention_fwd": 24 * JAXINIT_STEPS + 24,
                     "attention_bwd": 24 * JAXINIT_STEPS, "conv": 9})
        if not os.listdir(samples):
            raise AssertionError("jaxinit train_reg wrote no samples")
        if (f"warm-started from {pth}" not in text.getvalue()
                or first_weights != [True]):
            raise AssertionError("train_reg did not start from the JAX "
                                 f"weights: {text.getvalue()[-2000:]}")
        if (per_step != [{"attention_fwd": 24, "attention_bwd": 24}]
                * JAXINIT_STEPS or not all(np.isfinite(losses))
                or not all(np.isfinite(g) and g > 0 for g in gnorms)
                or state.step != JAXINIT_STEPS):
            raise AssertionError(f"jaxinit train_reg: per step {per_step}, "
                                 f"losses {losses}, grad norms {gnorms}, "
                                 f"step {state.step}")
        _, fresh = create_vit(JAXINIT_CONFIG, seed=7, device="cuda")
        other = create_train_state(fresh, make_optimizer(), seed=0)
        ckpt_mod.restore_checkpoint(ckpt, other)
        saved = state.model.state_dict()
        same = all(torch.equal(v, saved[k_]) for k_, v in
                   other.model.state_dict().items())
        same &= all(torch.equal(a, b) for a, b in zip(
            other.opt_state.mu + other.opt_state.nu,
            state.opt_state.mu + state.opt_state.nu))
        same &= (other.step, other.seed, other.opt_state.count) == (
            state.step, state.seed, state.opt_state.count)
        if not same:
            raise AssertionError("jaxinit: the restored state differs from "
                                 "the saved")
        del fresh, other
        torch.cuda.empty_cache()
        # Served through create_vit(weights=<dir>): the checkpoint's
        # weights bit for bit, u/v then converged as Predictor.fresh does
        # (three steps' power iterations leave sigma under-estimated).
        _, served_model = create_vit(JAXINIT_CONFIG, device="cuda",
                                     weights=ckpt)
        if not all(torch.equal(v, saved[k_]) for k_, v in
                   served_model.state_dict().items()):
            raise AssertionError("jaxinit: create_vit(weights=<dir>) differs "
                                 "from the trained state")
        with torch.no_grad():
            for _ in range(WARMUP_POWER_ITERATIONS):
                normalize_tree(served_model, training=True)
        served = Predictor(served_model, crop=cfg.crop, dtype=bf16,
                           config_name=JAXINIT_CONFIG)
        zero_counts()
        recon = served.reconstruct(images)
        read_counts("jaxinit_serve_checkpoint",
                    {"attention_fwd": 24, "attention_bwd": 0, "conv": 9})
        if recon.shape != (JAXINIT_BATCH, cfg.crop, cfg.crop, 3) or not (
                np.isfinite(recon).all() and recon.min() >= 0
                and recon.max() <= 1):
            raise AssertionError("jaxinit: serving the checkpoint gave bad "
                                 "reconstructions")
        metrics["train_reg"] = {
            "batch": TIME_BATCH, "steps": JAXINIT_STEPS, "losses": losses,
            "grad_norms": gnorms, "per_step": per_step[0],
            "seconds": time.time() - t0}
        log(f"[jaxinit] train_reg.main {JAXINIT_CONFIG} B={TIME_BATCH} bf16 "
            f"warm-started from the JAX weights (first step's weights the "
            f"table's bit for bit): losses {[round(x, 5) for x in losses]}, "
            f"grad norms {[round(g, 4) for g in gnorms]}, 24 + 24 rope "
            f"launches a step; step_{JAXINIT_STEPS}.pt restored bit for bit "
            f"and served through create_vit(weights=<dir>) (24 + 9 "
            f"launches)")
        del state, served, served_model, saved
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (d) Orbax conversion runs where tensorstore is.
    try:
        import tensorstore  # noqa: F401
        have_ts = True
    except ImportError:
        have_ts = False
    metrics["tensorstore_imports"] = have_ts
    metrics["seconds"] = time.time() - t_phase
    log(f"[jaxinit] tensorstore {'imports' if have_ts else 'does not import'}"
        " here; Orbax checkpoints are converted host-side (python -m "
        "calm_vit_dte_tpu_torch.compat.orbax import|export) and the card "
        "loads the step_<n>.pt")
    log(f"[jaxinit] phase 12 in {metrics['seconds']:.1f} s on {name} "
        f"({smi})")
    return by_path, metrics


PARALLEL_STEPS = 3        # phase 13 (a): torchrun at world 1; (b) steps
PARALLEL_BATCH = 8        # phase 13 (b): global batch, fp32
ROPE_PER_STEP = {"fused_rope_attention": 24, "fused_rope_attention_bwd": 24}


def parallel_phase(torch, name, smi):
    """Phase 13: data and tensor parallelism (parallel/mesh.py) on the one
    card. (a) `torchrun --standalone --nproc_per_node=1 -m
    calm_vit_dte_tpu_torch.train.train_cls --max-steps 3` on
    imagenet-cls-224 at B=128, synthetic data: NCCL at world 1, every
    loss finite, 24 + 24 rope launches a step (the epoch-stats line's
    counters), its checkpoint restored bit for bit equal to the same three
    steps of train_cls in a process without torchrun. (b)
    tools/parallel_step.py:
    two processes sharing the card over gloo (NCCL refuses two ranks on
    one GPU), imagenet-cls-224 at full width, fp32, global batch 8,
    injected global noise, from a carried state (u/v converged, one step
    taken, as tests/test_torch_parallel.py does), DP (2x1) and TP (1x2,
    tp_min_shard_dim 512), three steps each, held against the
    single-process card step: DP loss rtol 1e-5, state rtol 3e-3 / atol
    3e-5; TP loss rtol 1e-5, state rtol 3e-3 / atol 3e-4
    (tests/test_sharding.py's limits), each comparison's worst element
    (tensor, flat index, both values) printed; both sides under cuDNN's
    deterministic algorithms (`parallel_step.deterministic_cudnn`, only
    around the in-process runs here: the carried state and the
    one-process step), and the one-process step run twice,
    the second held against the first with the DP limits; the ranks'
    states bit for bit equal; 24 + 24 rope launches a step on every rank,
    with the fp32 route's stage launches (24 x 4 + 24 x 15) a step.
    Prints each rank's
    stored bytes of parameters and moments under TP against DP, the host
    ms a step at world 1 and 2, and the ms the global noise draw adds.
    Returns (launches by path and kernel, metrics)."""
    import os
    import shutil
    import tempfile

    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.tools import parallel_step as ps
    from calm_vit_dte_tpu_torch.train.checkpoint import restore_checkpoint
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    t_phase = time.time()
    config = "imagenet-cls-224"
    metrics: dict = {}
    by_path: dict = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CALM_CONV_")}   # the trainer's chain route
    env["PYTHONPATH"] = str(ROOT)
    saved_env = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith("CALM_CONV_")}

    f32_per_call = ka.f32_stage_launches(True)
    f32_stages = {"fused_rope_attention": 24 * f32_per_call["forward"],
                  "fused_rope_attention_bwd": 24 * f32_per_call["backward"]}

    def record(path, per_step, steps, stages_per_step=None):
        """Each step's rope launches, and for the fp32 steps (b) each step's
        stage launches (the fp32 route's, `ka.f32_stage_launches`)."""
        for step, got in enumerate(per_step):
            if got != ROPE_PER_STEP:
                raise AssertionError(f"parallel {path}: step {step + 1} "
                                     f"launched {got}, want {ROPE_PER_STEP}")
        for step, got in enumerate(stages_per_step or []):
            if got != f32_stages:
                raise AssertionError(f"parallel {path}: step {step + 1} "
                                     f"stage launches {got}, want "
                                     f"{f32_stages}")
        n = len(stages_per_step or [])
        by_path[path] = {"attention_fwd": 24 * steps,
                         "attention_bwd": 24 * steps, "conv": 0,
                         "stages": {"attention_fwd":
                                        n * f32_stages["fused_rope_attention"],
                                    "attention_bwd":
                                        n * f32_stages[
                                            "fused_rope_attention_bwd"]}}

    try:
        # (a) torchrun at world 1 (NCCL) and the same steps in a plain
        # process, both at once on the card (their checkpoints must agree
        # bit for bit; their step times share the card).
        t0 = time.time()
        args = ["--config", config, "--max-steps", str(PARALLEL_STEPS),
                f"global_batch_size={TIME_BATCH}", "dataset_root=synthetic",
                "log_every=1"]
        stats = work / "epochs.jsonl"
        procs = [subprocess.Popen(
            [sys.executable, *launcher,
             "calm_vit_dte_tpu_torch.train.train_cls", *args,
             f"checkpoint_dir={work / sub}", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for sub, launcher, extra in (
                ("torchrun", ["-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node=1", "-m"],
                 [f"epoch_stats_path={stats}"]),
                ("plain", ["-m"], []))]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"train_cls failed ({p.args[:6]}):\n"
                                     + out[-3000:] + err[-3000:])
        run_out, plain_out = outs[0][0], outs[1][0]
        losses = [float(x) for x in re.findall(
            r"^Epoch: 1, Batch: \d+, loss: ([-+0-9.eEnaif]+)", run_out,
            re.M)]
        row = json.loads(stats.read_text().splitlines()[-1])
        if len(losses) != PARALLEL_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"torchrun train_cls losses {losses}")
        launches = row["kernel_launches"]
        record("parallel_torchrun_world1", [
            {k: n // PARALLEL_STEPS for k, n in launches.items()}],
            PARALLEL_STEPS)
        if any(n % PARALLEL_STEPS for n in launches.values()):
            raise AssertionError(f"torchrun launches {launches}")
        torchrun_s = time.time() - t0
        p50 = re.search(r"p50 step: ([0-9.]+)s", run_out)
        p50_plain = re.search(r"p50 step: ([0-9.]+)s", plain_out)
        states = []
        for sub in ("torchrun", "plain"):
            _, fresh = create_vit(config, seed=7, device="cuda")
            states.append(create_train_state(fresh, make_optimizer(), seed=0))
            restore_checkpoint(str(work / sub), states[-1])
        a, b = states
        same = all(torch.equal(v, b.model.state_dict()[k])
                   for k, v in a.model.state_dict().items())
        same &= all(torch.equal(x, y) for x, y in zip(
            a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu))
        same &= (a.step, a.opt_state.count) == (
            b.step, b.opt_state.count) == (PARALLEL_STEPS,) * 2
        if not same:
            raise AssertionError("parallel: the torchrun checkpoint differs "
                                 "from the one-process run's")
        metrics["torchrun_world1"] = {
            "batch": TIME_BATCH, "steps": PARALLEL_STEPS, "losses": losses,
            "kernel_launches": launches, "p50_ms": float(p50.group(1)) * 1e3,
            "one_process_p50_ms": float(p50_plain.group(1)) * 1e3,
            "seconds": torchrun_s}
        log(f"[parallel] torchrun --standalone --nproc_per_node=1 train_cls "
            f"{config} B={TIME_BATCH} bf16 (NCCL, world 1): losses "
            f"{[round(x, 5) for x in losses]}, launches {launches} over "
            f"{PARALLEL_STEPS} steps, p50 {float(p50.group(1)) * 1e3:.1f} ms"
            f" a step (the plain process beside it on the card "
            f"{float(p50_plain.group(1)) * 1e3:.1f}); the two checkpoints "
            f"restored bit for bit equal; {torchrun_s:.1f} s with start-up")
        del states, a, b, fresh
        torch.cuda.empty_cache()

        # (b) two ranks over gloo on the one card, against one process.
        spec_run = {"name": "flagship", "config": config,
                    "batch": PARALLEL_BATCH, "steps": PARALLEL_STEPS,
                    "preprocess": False, "noise_seed": 1000,
                    "state_seed": 3, "restore": str(work / "carried"),
                    "meshes": [[2, 1], [1, 2]], "min_shard_dim": 512,
                    "time_noise": True}
        # The carried state and the one-process step (twice), with cuDNN's
        # deterministic algorithms as the ranks run (tools/parallel_step.
        # main; the chain route's convolution backward otherwise varies the
        # fp32 state's last bits from run to run, and with them the state
        # every comparison starts from): the second step held against the
        # first with the DP limits measures the card's own run-to-run
        # spread.
        singles = []
        with ps.deterministic_cudnn():
            ps.carry_state(spec_run, spec_run["restore"],
                           torch.device("cuda", 0))
            torch.cuda.empty_cache()
            for path in ("parallel_single_fp32",
                         "parallel_single_fp32_rerun"):
                zero = launch_counts()
                singles.append(ps.run_one(spec_run, None,
                                          torch.device("cuda", 0)))
                if any(n != zero[k] + 24 * PARALLEL_STEPS
                       for k, n in launch_counts().items()
                       if k in ROPE_PER_STEP):
                    raise AssertionError(f"parallel: {path} launches")
                record(path, singles[-1]["launches"], PARALLEL_STEPS,
                       singles[-1]["stages"])
                torch.cuda.empty_cache()
        single = singles[0]
        rerun = ps.excess(singles[1], single, 3e-3, 3e-5)
        rerun_same = all(torch.equal(v, singles[1]["state"][k])
                         for k, v in single["state"].items())
        spec = {"out": str(work / "ranks"), "device": "cuda",
                "timeout_s": 600, "runs": [spec_run]}
        spec_path = work / "spec.json"
        spec_path.write_text(json.dumps(spec))
        t0 = time.time()
        ps.collect(ps.spawn(str(spec_path), 2, env=env), timeout=600)
        ranks_s = time.time() - t0
        recs = {layout: [torch.load(work / "ranks" /
                                    f"flagship_{layout}_rank{r}.pt",
                                    weights_only=False) for r in range(2)]
                for layout in ("2x1", "1x2")}

        def where(x):
            return (f"{x['excess']:.3g} at {x['tensor']}[{x['index']}] "
                    f"({x['got']!r} against {x['want']!r})")

        summary = {"one_process_rerun": dict(rerun, bit_identical=rerun_same)}
        log(f"[parallel] the one-process fp32 step run twice: "
            f"{'bit for bit equal' if rerun_same else 'not bit-identical'}"
            f"; its state past rtol 3e-3 / atol 3e-5 of the first run's by "
            f"{where(rerun)}")
        if rerun["excess"] > 0:
            raise AssertionError(f"parallel: the one-process step against "
                                 f"itself beyond rtol 3e-3 / atol 3e-5 by "
                                 f"{where(rerun)}")
        for layout, atol in (("2x1", 3e-5), ("1x2", 3e-4)):
            rec = recs[layout]
            for r, one in enumerate(rec):
                record(f"parallel_{layout}_rank{r}", one["launches"],
                       PARALLEL_STEPS, one["stages"])
                apart = {k: float((one["state"][k] - v).abs().max())
                         for k, v in rec[0]["state"].items()
                         if not torch.equal(one["state"][k], v)}
                if apart:
                    raise AssertionError(
                        f"parallel {layout}: rank {r}'s state differs from "
                        f"rank 0's in {len(apart)} tensors, e.g. "
                        f"{sorted(apart.items(), key=lambda x: -x[1])[:8]}")
            losses_l = [m["loss"] for m in rec[0]["metrics"]]
            losses_1 = [m["loss"] for m in single["metrics"]]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses_l,
                                                          losses_1))
            past = ps.excess(rec[0], single, 3e-3, atol)
            log(f"[parallel] {layout} against one process: loss rel "
                f"{rel:.3g}; state past rtol 3e-3 / atol {atol} by "
                f"{where(past)}")
            if rel > 1e-5 or past["excess"] > 0:
                raise AssertionError(
                    f"parallel {layout} against one process: loss rel "
                    f"{rel:.3g} (limit 1e-5), state beyond rtol 3e-3 / atol "
                    f"{atol} by {where(past)}")
            summary[layout] = {
                "losses": losses_l, "loss_max_rel": rel, "state": past,
                "ms_per_step": [float(np.median(one["ms"][1:]))
                                for one in rec],
                "stored_bytes": [one["stored"]["params"]
                                 + one["stored"]["moments"] for one in rec],
                "sharded_weights": len(rec[0]["stored"]["sharded"]),
                "noise_global_ms": rec[0]["noise_global_ms"],
                "noise_local_ms": rec[0]["noise_local_ms"]}
        single_ms = float(np.median(single["ms"][1:]))
        saved = summary["2x1"]["stored_bytes"][0] - \
            summary["1x2"]["stored_bytes"][0]
        if saved != 13_267_968 * 12 or summary["1x2"]["sharded_weights"] \
                != 59:
            raise AssertionError(f"parallel TP stores {saved} B less than "
                                 "DP; want 13,267,968 x 12")
        metrics["gloo_two_ranks"] = dict(
            summary, single_ms_per_step=single_ms,
            single_losses=[m["loss"] for m in single["metrics"]],
            tp_saves_bytes_per_rank=saved, seconds_ranks=ranks_s)
        dp = summary["2x1"]
        log(f"[parallel] {config} fp32 B={PARALLEL_BATCH}, 2 ranks over gloo "
            f"on one card against one process: DP 2x1 loss rel "
            f"{dp['loss_max_rel']:.3g}, TP 1x2 (59 weights sharded at 512) "
            f"{summary['1x2']['loss_max_rel']:.3g}; ranks bit-identical; "
            "24 + 24 rope launches a step on every rank, each with the "
            f"fp32 route's stage launches {f32_stages}")
        log(f"[parallel] stored params + moments per rank: DP "
            f"{dp['stored_bytes'][0] / 1e6:.1f} MB, TP "
            f"{summary['1x2']['stored_bytes'][0] / 1e6:.1f} MB "
            f"({saved / 1e6:.1f} MB less = 13,267,968 elements x 12 B)")
        log(f"[parallel] host ms a step: world 1 {single_ms:.1f}; world 2 "
            f"DP {dp['ms_per_step']}, TP {summary['1x2']['ms_per_step']}; "
            f"the step's noise from a generator at the global shapes "
            f"{dp['noise_global_ms']:.3f} ms against the local "
            f"{dp['noise_local_ms']:.3f} ms (adds "
            f"{dp['noise_global_ms'] - dp['noise_local_ms']:.3f}); ranks "
            f"{ranks_s:.1f} s with start-up")
    finally:
        os.environ.update(saved_env)
        shutil.rmtree(work, ignore_errors=True)
    metrics["seconds"] = time.time() - t_phase
    log(f"[parallel] phase 13 in {metrics['seconds']:.1f} s on {name} "
        f"({smi}); one card: no multi-card speed is measured")
    return by_path, metrics


TOOLS_DATAPLANE_STEPS = 6   # phase 14: the from-disk dataplane run
TOOLS_EVAL_IMAGES = (4, 256)  # phase 14: staged val classes x images each
TOOLS_SOAK_EPOCHS = 3       # phase 14: epochs before the soak's SIGTERM
# The kernel line's entry of each wrapper that phase 14's paths launch.
TOOLS_KERNEL_NAMES = {
    "fused_rope_attention": "fused_rope_attention_fwd",
    "fused_rope_attention_bwd": "fused_rope_attention_bwd",
    "fused_conv_residual": "fused_conv_residual_fwd",
    "conv_residual_fwd_resid": "conv_residual_fwd_resid",
    "conv_residual_bwd": "conv_residual_bwd",
    "fused_hires_attention": "hires_attention_fwd_res",
    "hires_dq": "hires_attention_dq",
    "hires_dkv": "hires_attention_dkv",
    "fused_attention_forward": "hires_attention_fwd_only",
    "fused_hires_attention:cuda_core": "hires_attention_fwd_res_cuda_core",
    "hires_dq:cuda_core": "hires_attention_dq_cuda_core",
    "hires_dkv:cuda_core": "hires_attention_dkv_cuda_core",
    "fused_attention_forward:cuda_core": "hires_attention_fwd_only_cuda_core",
    "fused_hires_attention:wide": "hires_attention_fwd_res_wide",
    "hires_dq:wide": "hires_attention_dq_wide",
    "hires_dkv:wide": "hires_attention_dkv_wide",
    "fused_attention_forward:wide": "hires_attention_fwd_only_wide",
}


def tools_phase(torch, name, smi):
    """Phase 14: the ported scripts (calm_vit_dte_tpu_torch/tools/), each at
    a reduced size, checked for what it is for, with the kernels each path
    launched (counters read before and after it): stage_dataset (a local
    tar staged, skipped on a re-run, extracted); bench_dataplane (256
    corpus JPEGs, B=128, a chain of 6 steps each of the synthetic, the
    loader-only and the from-disk runs: finite rates and losses, the native
    decoder and no Pillow image, 24 + 24 rope launches a step);
    bench_eval_50k (1,024 staged val JPEGs: top-1 in [0, 1], loader wait
    plus device seconds within the wall, 24 + 8 launches a batch); soak
    (4 classes x 64 JPEGs at 256 px, B=128, SIGTERM after 3 epochs: the
    checkpoint written, at most 3 kept, a one-step resume from it, 24 + 24
    launches a step in every epoch line; its trainer processes run beside
    the tools after the dataplane, whose metrics and log lines say so:
    their times are not comparable with the full runs'); bench_hires_train
    (B=2, 2 steps,
    bf16 moments: 24 + 24 + 24 hires launches a step); bench_hires_serve
    (B=1, bf16, int8, int8-wo: finite, 24 forward-only + 8 conv launches a
    forward); bench_quantize (B=32, both int8 modes within the limits, 24 +
    8 a forward); profile_opt (3 repetitions, 5 flagship steps: every
    variant's ms between CUDA events and busy ms from a trace, the
    flagship step's). Every tool writes under a temporary directory.
    Returns (launches and stage launches by path and wrapper, metrics)."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import tarfile
    import tempfile
    import threading

    from calm_vit_dte_tpu_torch.tools import (
        bench_dataplane,
        bench_eval_50k,
        bench_hires_serve,
        bench_hires_train,
        bench_quantize,
        profile_opt,
        soak,
        stage_dataset,
    )
    from calm_vit_dte_tpu_torch.utils.profiling import (
        launch_counts,
        stage_counts,
    )

    t_phase = time.time()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    out = str(work / "out")
    by_path: dict = {}
    metrics: dict = {}
    saved_env = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith("CALM_CONV_")}   # the trainer's chain route
    soaker = None

    def soaking():
        return soaker is not None and soaker.is_alive()

    def run(path, fn):
        """fn() with the launches it made recorded under `path`, and
        whether the soak's trainer shared the card meanwhile."""
        gc.collect()
        torch.cuda.empty_cache()
        counts, stages = launch_counts(), stage_counts()
        shared = soaking()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        shared = shared or soaking()
        by_path[path] = {
            "launches": {k: n - counts[k] for k, n in launch_counts().items()
                         if n != counts[k]},
            "stages": {k: n - stages[k] for k, n in stage_counts().items()
                       if n != stages[k]}}
        metrics[path] = {"seconds": time.time() - t0,
                         "beside_soak_trainer": shared}
        return result, by_path[path]["launches"]

    def beside(path):
        """The log's mark on a time taken while the soak trained."""
        return (" [timed beside the soak's trainer: not comparable with the "
                "full runs]" if metrics[path]["beside_soak_trainer"] else "")

    def want(path, got, **per):
        for k, n in per.items():
            if got.get(k, 0) != n:
                raise AssertionError(f"tools {path}: {k} launched "
                                     f"{got.get(k, 0)} times, want {n}")

    try:
        # stage_dataset: a local-path stage, re-run and skipped, extracted.
        src = work / "imagenet_src"
        src.mkdir()
        inner = io.BytesIO()
        with tarfile.open(fileobj=inner, mode="w") as tf:
            for i in range(3):
                info = tarfile.TarInfo(f"n01440764_{i}.JPEG")
                info.size = 4
                tf.addfile(info, io.BytesIO(b"img%d" % i))
        with tarfile.open(src / "ILSVRC2012_img_train.tar", "w") as tf:
            info = tarfile.TarInfo("n01440764.tar")
            info.size = len(inner.getvalue())
            tf.addfile(info, io.BytesIO(inner.getvalue()))
        with tarfile.open(src / "ILSVRC2012_img_val.tar", "w") as tf:
            info = tarfile.TarInfo("ILSVRC2012_val_00000001.JPEG")
            info.size = 3
            tf.addfile(info, io.BytesIO(b"val"))
        (src / "ILSVRC2012_devkit_t12.tar.gz").write_bytes(b"devkit")
        argv = ["--src", str(src), "--dest", str(work / "imagenet"),
                "--extract"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            stage_dataset.main(argv)
            stage_dataset.main(argv)
        dest = work / "imagenet"
        if (printed.getvalue().count("already staged") != 3
                or sorted(os.listdir(dest / "train" / "n01440764"))
                != [f"n01440764_{i}.JPEG" for i in range(3)]
                or os.listdir(dest / "val")
                != ["ILSVRC2012_val_00000001.JPEG"]):
            raise AssertionError("tools stage_dataset:\n" + printed.getvalue())
        log("[tools] stage_dataset: 3 local files staged, the re-run skipped "
            "all 3 (.staged.json), --extract wrote train/n01440764/ (3) and "
            "val/ (1)")

        # bench_dataplane: the loader from disk feeding the flagship step.
        dp, got = run("tools_dataplane", lambda: bench_dataplane.main([
            "--images", "256", "--n-train", "256",
            "--steps", str(TOOLS_DATAPLANE_STEPS), "--batch", str(TIME_BATCH),
            "--chains", "1", "--repeat", "1",
            "--root", str(work / "dp_corpus"), "--out", out]))
        integ = dp["integrated"]
        steps = 1 + TOOLS_DATAPLANE_STEPS   # warm-up + the chain, twice
        want("dataplane", got, fused_rope_attention=24 * 2 * steps,
             fused_rope_attention_bwd=24 * 2 * steps)
        rates = [integ[k] for k in ("synthetic_img_per_s",
                                    "loader_only_img_per_s",
                                    "real_loader_img_per_s")]
        if (integ["decoder"] != "native" or integ["pillow_images"]
                or not integ["losses_finite"]
                or not all(np.isfinite(rates)) or min(rates) <= 0):
            raise AssertionError(f"tools dataplane: {integ}")
        metrics["tools_dataplane"].update(
            standalone=dp["standalone"], integrated=integ,
            stall_analysis=dp["stall_analysis"])
        log(f"[tools] bench_dataplane B={TIME_BATCH}, 256 JPEGs, a chain of "
            f"{TOOLS_DATAPLANE_STEPS} steps: synthetic "
            f"{integ['synthetic_img_per_s']} images/s, loader alone "
            f"{integ['loader_only_img_per_s']}, from disk "
            f"{integ['real_loader_img_per_s']} (ratio {integ['ratio']}), "
            f"decoder {integ['decoder']}, Pillow images "
            f"{integ['pillow_images']}; native 1 thread "
            f"{dp['standalone'].get('native_1t_img_per_s')}, Pillow "
            f"{dp['standalone']['pil_img_per_s']} images/s; launches {got}")

        # soak: the trainer CLI over 3 epochs, SIGTERM, a one-step resume,
        # in its own processes while the tools below run in this one (the
        # trainer's launches are its epoch lines', not this process's).
        soak_result: dict = {}

        def soak_thread():
            t0 = time.time()
            try:
                soak_result["summary"] = soak.main([
                    "--classes", "4", "--per-class", "64", "--img-size",
                    "256", "--batch", str(TIME_BATCH), "--microbatch", "1",
                    "--minutes", "10",
                    "--sigterm-after-epochs", str(TOOLS_SOAK_EPOCHS),
                    "--resume-steps", "1", "--log-every", "1",
                    "--corpus", str(work / "soak_corpus"),
                    "--ckpt-dir", str(work / "soak_ckpt"),
                    "--out", str(work / "soak_out")])
            except BaseException as exc:   # re-raised after the join
                soak_result["error"] = exc
            soak_result["seconds"] = time.time() - t0

        soaker = threading.Thread(target=soak_thread)
        soaker.start()

        # bench_eval_50k: evaluate() over staged val JPEGs.
        classes, per = TOOLS_EVAL_IMAGES
        ev, got = run("tools_eval", lambda: bench_eval_50k.main([
            "--classes", str(classes), "--per-class", str(per),
            "--batch", str(TIME_BATCH), "--corpus", str(work / "eval"),
            "--out", out]))
        batches = -(-classes * per // TIME_BATCH)
        want("eval", got, fused_rope_attention=24 * batches,
             fused_conv_residual=8 * batches)
        if not (ev["images"] == classes * per and 0 <= ev["top1"] <= 1
                and bench_eval_50k.accounting_fault(ev["exact_s"]) is None):
            raise AssertionError(f"tools eval: {ev}")
        metrics["tools_eval"].update(ev)
        log(f"[tools] bench_eval_50k over {ev['images']} staged JPEGs "
            f"(staged in {ev['stage_s']} s): top-1 {ev['top1']}, "
            f"{ev['img_per_s']} images/s, wall {ev['wall_s']} s, loader wait "
            f"{ev['loader_wait_s']} s, device {ev['device_s']} s; launches "
            f"{got}{beside('tools_eval')}")

        # bench_hires_train: the hires step at B=2, bf16 moments.
        ht, got = run("tools_hires_train", lambda: bench_hires_train.main([
            "--batch", "2", "--steps", "2", "--out", out]))
        want("hires_train", got, fused_hires_attention=48, hires_dq=48,
             hires_dkv=48)
        if ht["status"] != "trained":
            raise AssertionError(f"tools hires_train: {ht}")
        metrics["tools_hires_train"].update(
            {k: v for k, v in ht.items() if k != "losses"})
        log(f"[tools] bench_hires_train B=2, 2 steps, bf16 moments: losses "
            f"{ht['losses']}, peak {ht['hbm_peak_gb']} GiB of "
            f"{ht['hbm_limit_gb']} GiB; states {ht['accounting']} ; "
            f"launches {got}{beside('tools_hires_train')}")

        # bench_hires_serve: B=1 in bf16, int8 and int8-wo.
        hs, got = run("tools_hires_serve", lambda: bench_hires_serve.main([
            "--batch", "1", "--out", out]))
        for r in hs["rows"]:
            want(f"hires_serve {r['mode']}", r["kernel_launches_per_forward"],
                 fused_attention_forward=24, fused_conv_residual=8)
        metrics["tools_hires_serve"].update(rows=hs["rows"])
        log("[tools] bench_hires_serve B=1: " + "; ".join(
            f"{r['mode']} {r['img_s_chip']} images/s, p50 {r['p50_ms']} ms, "
            f"finite {r['finite']}, peak {r['peak_mem_gib']:.3f} GiB"
            for r in hs["rows"]) + beside("tools_hires_serve"))

        # bench_quantize: bf16 against both int8 modes at B=32.
        qz, got = run("tools_quantize", lambda: bench_quantize.main([
            "--batches", "32", "--out", out]))
        for r in qz["rows"]:
            want(f"quantize {r['mode']}", r["kernel_launches_per_forward"],
                 fused_rope_attention=24, fused_conv_residual=8)
        metrics["tools_quantize"].update(rows=qz["rows"])
        log("[tools] bench_quantize B=32: " + "; ".join(
            f"{r['mode']} {r['int8_img_s']} vs bf16 {r['bf16_img_s']} "
            f"images/s (x{r['speedup']}), logit rel err "
            f"{r['logit_rel_err']}, top-1 agree {r['top1_agree']}"
            for r in qz["rows"]) + beside("tools_quantize"))

        # profile_opt: FusedAdamW alone, beside the flagship step.
        po, got = run("tools_profile_opt", lambda: profile_opt.main([
            "--reps", "3", "--warmup", "1", "--step-reps", "2",
            "--out", out]))
        steps = 1 + 2 + 2   # warm-up, 2 timed, 2 traced
        want("profile_opt", got, fused_rope_attention=24 * steps,
             fused_rope_attention_bwd=24 * steps)
        if not all(v["event_ms"] > 0
                   and (v["busy_ms"] is None or v["busy_ms"] > 0)
                   for v in po["variants"].values()):
            raise AssertionError(f"tools profile_opt: {po}")
        metrics["tools_profile_opt"].update(
            variants=po["variants"], step=po["step"],
            optimizer_share_of_step=po["optimizer_share_of_step"])
        log("[tools] profile_opt ms between CUDA events / device-busy ms "
            "(None: the trace saw no device work): " + ", ".join(
                f"{k} {v['event_ms']:.3f} / {v['busy_ms']}"
                for k, v in po["variants"].items())
            + f"; flagship step B={po['step']['batch']} "
            f"{po['step']['ms']:.1f} / {po['step']['busy_ms']} ms (optimizer "
            f"{po['optimizer_share_of_step']:.1%} by events)"
            + beside("tools_profile_opt"))
        soaker.join()
        if "error" in soak_result:
            raise soak_result["error"]
        sk = soak_result["summary"]
        metrics["tools_soak"] = {"seconds": soak_result["seconds"]}
        rows = [json.loads(line) for line in (
            work / "soak_out" / "soak_epochs.jsonl").read_text().splitlines()]
        for r in rows:
            want(f"soak epoch {r['epoch']}", r["kernel_launches"],
                 fused_rope_attention=24 * r["steps"],
                 fused_rope_attention_bwd=24 * r["steps"])
        resume = sk["resume"]
        if not (sk["sigterm_sent"] and sk["sigterm_checkpointed"]
                and sk["epochs_completed"] >= TOOLS_SOAK_EPOCHS
                and sk["max_to_keep_respected"]
                and sk["sigterm_step"] in sk["checkpoints_kept"]
                and resume["rc"] == 0
                and resume["resumed_from_step"] == sk["sigterm_step"]
                and max(resume["checkpoints_kept"]) == sk["sigterm_step"] + 1
                and sk["resumed_segments"] >= 1):
            raise AssertionError(f"tools soak: {sk}")
        # The SIGTERM-cut epoch writes no line: its launches are not read.
        by_path["tools_soak"] = {"launches": {
            k: sk["kernel_launches"].get(k, 0)
            + resume["kernel_launches"].get(k, 0)
            for k in set(sk["kernel_launches"]) | set(
                resume["kernel_launches"])}, "stages": {}}
        metrics["tools_soak"].update({k: v for k, v in sk.items()
                                      if k != "resume"},
                                     resume={k: v for k, v in resume.items()
                                             if k != "rows"})
        log(f"[tools] soak B={TIME_BATCH}, 256 JPEGs (beside the tools "
            f"above): {sk['epochs_completed']} epochs of 2 steps, p50 "
            f"{sk['p50_all']} s (an epoch's first step carries the last "
            f"one's checkpoint), peak RSS {sk['rss_mb_first']} -> "
            f"{sk['rss_mb_last']} MB; SIGTERM checkpointed at step "
            f"{sk['sigterm_step']}, kept {sk['checkpoints_kept']}; resumed "
            f"from step {resume['resumed_from_step']} for 1 step (kept "
            f"{resume['checkpoints_kept']}); launches "
            f"{by_path['tools_soak']['launches']}")
    finally:
        if soaker is not None:
            soaker.join()   # its trainer processes end before the cleanup
        os.environ.update(saved_env)
        shutil.rmtree(work, ignore_errors=True)
    metrics["seconds"] = time.time() - t_phase
    log(f"[tools] phase 14 in {metrics['seconds']:.1f} s on {name} ({smi}): "
        + ", ".join(f"{k.removeprefix('tools_')} {v['seconds']:.1f} s"
                    for k, v in metrics.items() if k != "seconds"))
    return by_path, metrics


ROUTES_HEADS = 6          # phase 15: hires-cls-1024 at heads=6
ROUTES_TRAIN_BATCH = 16   # phase 15 (c): the batch at which S = 1024 chunks
ROUTES_TRAIN_STEPS = 2
# Phase 15 (c), fixed from hires-cls-1024's shapes at heads=6, (S, D, Dv)
# as the hires kernels see them (D = Dc + Dr): layers. Every layer has Sq ==
# Skv, so every one takes the hires kernels and none the route: the 9 at D
# 224 their D, Dv <= 256 tensor-core kernels; the 15 at D 320, 416 and 512
# (past 256) the wide tensor-core forward, dq and dk/dv kernels. The TPU
# takes a Pallas kernel for all 24.
ROUTES_LAYERS = {(448, 224, 224): 9, (640, 320, 320): 6, (832, 416, 416): 6,
                 (1024, 512, 512): 3}
ROUTES_CLASSIFY_LAUNCHES = {"fused_attention_forward": 24,
                            "fused_conv_residual": 8}
ROUTES_STEP_LAUNCHES = {"fused_hires_attention": 24, "hires_dq": 24,
                        "hires_weight_grads": 24, "hires_dkv": 24}
# Of each hires wrapper's launches in a forward or step: those on the
# CUDA-core kernels, and those on the wide tensor-core kernels.
ROUTES_CUDA_CORE = {"fused_hires_attention": 0, "fused_attention_forward": 0,
                    "hires_dkv": 0, "hires_dq": 0}
ROUTES_WIDE = {"fused_hires_attention": 15, "fused_attention_forward": 15,
               "hires_dkv": 15, "hires_dq": 15}
# Phase 15 (a): the hires kernels past the D, Dv <= 256 tensor-core kernels,
# (H, S, D, Dv): the six-head model's three shapes past D 256, D 264 (the
# dispatcher's limit), a partial slice on the D side, Dv past 256 with D
# below it (bf16: the wide tensor-core forward, dq and dk/dv kernels; fp32:
# the CUDA-core kernels), and bf16 S 1020 and head dims off the multiple
# of 8 (every pass on the CUDA cores).
ROUTES_WIDE_CHECKS = ((6, 1024, 512, 512), (6, 832, 416, 416),
                      (6, 640, 320, 320), (4, 1024, 264, 264),
                      (4, 256, 264, 200), (4, 256, 200, 264),
                      (4, 1020, 256, 256), (3, 192, 130, 300))
# Phase 15 (b): chunked against xla, forced, bf16 (B, H, S, D = Dv).
ROUTES_COMPARE = (16, 6, 1024, 512)


def route_inputs(torch, shape, device, seed):
    """fp32 leaves of one attention call: {qc, qr, kc, kr, v, fq, fk} (or q,
    k, v with Dr = 0) and the four mask tensors (w1, b1, w2, b2), scaled so
    that the scores, the mask's hidden layer and m are of order one."""
    b, h, sq, skv, dc, dr, dv = shape
    rng = np.random.default_rng(seed)

    def n(*shp, scale):
        return torch.from_numpy((rng.standard_normal(shp) * scale).astype(
            np.float32)).to(device)

    x = ({"q": n(b, h, sq, dc, scale=0.3), "k": n(b, h, skv, dc, scale=0.3)}
         if not dr else
         {"qc": n(b, h, sq, dc, scale=0.3), "qr": n(b, h, sq, dr, scale=0.3),
          "kc": n(b, h, skv, dc, scale=0.3), "kr": n(b, h, skv, dr, scale=0.3),
          "fq": (1.0 / 10000 ** (torch.arange(0, dr, 2, device=device)
                                 / dr)).float()})
    if dr:
        x["fk"] = x["fq"] * 1.1
    x["v"] = n(b, h, skv, dv, scale=0.3)
    x.update(w1=n(2 * skv, skv, scale=0.2 / skv ** 0.5),
             b1=n(2 * skv, scale=0.1), w2=n(skv, 2 * skv,
                                             scale=(2 * skv) ** -0.5),
             b2=n(skv, scale=0.1))
    return x


def route_call(ops, x, dtype, use_mask):
    """masked_attention (Dr = 0) or masked_rope_attention on the leaves."""
    mask = tuple(x[k] for k in ("w1", "b1", "w2", "b2"))
    if "q" in x:
        return ops.masked_attention(x["q"], x["k"], x["v"], mask, dtype=dtype,
                                    use_mask=use_mask)
    return ops.masked_rope_attention(x["qc"], x["qr"], x["kc"], x["kr"],
                                     x["v"], x["fq"], x["fk"], mask,
                                     dtype=dtype, use_mask=use_mask)


def routes_phase(torch, name, smi):
    """Phase 15: the attention dispatch (ops/attention.py) and the JAX
    package's 'chunked' and 'xla' routes. (a) each limit of the dispatcher,
    fp32 and bf16, mask on and off: the shape just inside and just past
    each take their route (rope, the hires kernels, each pass on the
    tensor cores, their wide kernels or the CUDA cores, 'xla'), one
    counter each, with and without grad; the route's fp32 forward and
    gradients card vs CPU; the hires kernels at shapes past the D, Dv <=
    256 tensor-core kernels against their plain versions (bf16 twice bit
    for bit), and timed at the six-head shapes (the wide kernels in bf16,
    the CUDA-core kernels in fp32); (b)
    'chunked' against 'xla' forced at S 1024, D = Dv 512, H 6, B 16, bf16,
    forward and backward, each one's device ms and peak memory; (c)
    hires-cls-1024 at heads=6 at full width: classify 8 images in bf16 (24
    forward-only hires launches, 15 of them on the wide kernel, + 8 conv),
    fp32 logits card vs CPU on 1 image (24 on the CUDA-core kernel), and
    make_train_step steps at B=16 in bf16 with remat (24 + 24 + 24 hires
    launches a step: 15 forwards, 15 dq and 15 dk/dv passes on the wide
    kernels; no route). Returns (launches and
    stage launches by path and wrapper, metrics, the wide and CUDA-core
    hires kernels' summaries for the kernels line)."""
    from calm_vit_dte_tpu_torch.data.augment import eval_preprocess
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.kernels import relayout as kr
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.ops import attention as ops
    from calm_vit_dte_tpu_torch.serve import (
        WARMUP_POWER_ITERATIONS,
        Predictor,
    )
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.train.step import make_train_step
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.profiling import (
        launch_counts,
        stage_counts,
    )

    t_phase = time.time()
    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    wrappers = (ka.fused_rope_attention, ka.fused_rope_attention_bwd,
                kh.fused_hires_attention, kh.hires_dq, kh.hires_weight_grads,
                kh.hires_dkv, kh.fused_attention_forward)
    hires_wrappers = (kh.fused_hires_attention, kh.hires_dq, kh.hires_dkv,
                      kh.fused_attention_forward)
    pass_of = {"fused_hires_attention": "fwd", "fused_attention_forward": "fwd",
               "hires_dq": "dq", "hires_dkv": "dkv"}
    wrapper_of = {"fwd_res": "fused_hires_attention",
                  "fwd_only": "fused_attention_forward", "dq": "hires_dq",
                  "dkv": "hires_dkv"}

    def zero_counts():
        """Every wrapper's launches, stage launches and CUDA-core launches,
        and the route's forwards, to 0 (just before each path)."""
        for fn in (*wrappers, kc.fused_conv_residual,
                   kc.conv_residual_fwd_resid, kc.conv_residual_bwd,
                   kc.conv_weight_grad_sum, kr.swap_seq_heads):
            fn.launches = 0
        for fn in wrappers:
            fn.stage_launches = 0
        for fn in hires_wrappers:
            fn.cuda_core_launches = 0
            fn.wide_launches = 0
        for k in ops.route_calls:
            ops.route_calls[k] = 0

    def counts():
        got = {k: n for k, n in launch_counts().items() if n}
        got.update({f"route:{k}": n for k, n in ops.route_calls.items() if n})
        return got

    def cuda_core():
        return {fn.__name__: fn.cuda_core_launches for fn in hires_wrappers
                if fn.cuda_core_launches}

    def wide():
        return {fn.__name__: fn.wide_launches for fn in hires_wrappers
                if fn.wide_launches}

    def families(s, d, dv, dtype, names):
        """The CUDA-core and the wide launches, by wrapper, of one call of
        each of `names` at a shape, as `family` per pass says."""
        cc, wd = {}, {}
        for n in names:
            fam = kh.family(s, d, dv, dtype, pass_of[n])
            if fam != "tensor_cores":
                (cc if fam == "cuda_core" else wd)[n] = 1
        return cc, wd

    def by_family(got, cc, wd):
        """Launches by wrapper, the hires wrappers' CUDA-core and wide
        calls apart (`<wrapper>:cuda_core`, `<wrapper>:wide`)."""
        launches = dict(got)
        for suffix, part in ((":cuda_core", cc), (":wide", wd)):
            for k, n in part.items():
                launches[k] -= n
                launches[k + suffix] = n
        return {k: n for k, n in launches.items() if n}

    def stages():
        return {k: n for k, n in stage_counts().items() if n}

    route_counter = {"rope": "fused_rope_attention",
                     "hires": "fused_hires_attention",
                     "xla": "route:xla", "chunked": "route:chunked"}
    metrics: dict = {"limits": [], "name": name, "smi": smi}

    # (a) each limit of the dispatcher: inside and past take their routes.
    t0 = time.time()
    limits_launches: dict = {}
    for li, (what, inside, past, first, second, dtypes) in enumerate(
            ops.ROUTE_LIMITS):
        for dt_name in dtypes:
            dtype = getattr(torch, dt_name)
            for use_mask in (True, False):
                for shape, want_route in ((inside, first), (past, second)):
                    b, h, sq, skv, dc, dr, dv = shape
                    x = route_inputs(torch, shape, dev, seed=1500 + li)
                    for t in x.values():
                        t.requires_grad_()
                    zero_counts()
                    out = route_call(ops, x, dtype, use_mask)
                    got = counts()
                    family = None
                    if want_route == "hires":
                        family = {p_: kh.family(sq, dc + dr, dv, dtype, p_)
                                  for p_ in kh.TC_MAX_D}
                    if got != {route_counter[want_route]: 1}:
                        raise AssertionError(
                            f"routes {what} {shape} {dt_name} mask="
                            f"{use_mask}: expected one "
                            f"{route_counter[want_route]}, got {got}")
                    g = torch.from_numpy(np.random.default_rng(1550 + li)
                                         .standard_normal(out.shape).astype(
                        np.float32)).to(dev)
                    (out.float() * g).sum().backward()
                    with torch.no_grad():   # the forward-only kernels
                        route_call(ops, x, dtype, use_mask)
                    torch.cuda.synchronize()
                    cc, wd = cuda_core(), wide()
                    if want_route == "hires" and (cc, wd) != families(
                            sq, dc + dr, dv, dtype, pass_of):
                        raise AssertionError(
                            f"routes {what} {shape} {dt_name}: expected "
                            f"{family}, got CUDA-core launches {cc}, wide "
                            f"launches {wd}")
                    for k, n in by_family(counts(), cc, wd).items():
                        limits_launches[k] = limits_launches.get(k, 0) + n
                    leaves = {k: t for k, t in x.items() if t.grad is not None}
                    if not torch.isfinite(out.float()).all() or not all(
                            torch.isfinite(t.grad).all()
                            for t in leaves.values()):
                        raise AssertionError(f"routes {what} {shape} "
                                             f"{dt_name}: not finite")
                    row = {"limit": what, "shape": shape, "dtype": dt_name,
                           "use_mask": use_mask, "route": want_route,
                           "hires_kernels": family}
                    if want_route in ("xla", "chunked") and dtype == f32:
                        # The route's fp32 forward and gradients, card vs CPU.
                        xc = {k: t.detach().cpu().requires_grad_()
                              for k, t in x.items()}
                        oc = route_call(ops, xc, f32, use_mask)
                        (oc * g.cpu()).sum().backward()
                        oc = oc.detach()
                        torch.testing.assert_close(out.detach().cpu(), oc,
                                                   rtol=2e-4, atol=2e-5)
                        worst = 0.0
                        for k, t in leaves.items():
                            err = norm_err(t.grad.cpu(), xc[k].grad)
                            if err > BWD_FP32_LIMIT:
                                raise AssertionError(
                                    f"routes {what} {shape}: gradient of {k} "
                                    f"{err:.3e} of its largest value, card "
                                    "vs CPU")
                            worst = max(worst, err)
                        row.update(fwd_err=max_err(out.detach().cpu(), oc),
                                   bwd_norm_err=worst,
                                   grads=sorted(leaves))
                    metrics["limits"].append(row)
                    del x, out, g
        log(f"[routes] (a) {what}: {first} just inside, {second} just past "
            f"({', '.join(dtypes)}, mask on and off, with and without grad), "
            "one counter each; hires passes by family: " + "; ".join(
                f"{r['dtype']} {r['shape'][2]}x{r['shape'][4] + r['shape'][5]}"
                f": {r['hires_kernels']}" for r in metrics["limits"]
                if r["limit"] == what and r["hires_kernels"]
                and r["use_mask"]))
    for row in metrics["limits"]:
        if "fwd_err" in row:
            log(f"[routes] (a) fp32 {row['route']} card vs CPU at "
                f"{row['shape']} mask={row['use_mask']}: forward max abs "
                f"diff {row['fwd_err']:.3e}, gradients ({', '.join(row['grads'])}) "
                f"worst {row['bwd_norm_err']:.3e} of the largest value")
    # The hires kernels past the D, Dv <= 256 tensor-core kernels, against
    # their plain versions (fp32 and bf16, as phase 8 holds the tensor-core
    # ones), the bf16 launches twice bit for bit.
    worst: dict = {}
    for i, (h, s, d, dv) in enumerate(ROUTES_WIDE_CHECKS):
        w = check_hires_shape(torch, ka, kh, s, d, dv, seed=1520 + 2 * i,
                              h=h, twice=True)
        worst[(s, d, dv)] = w
        fam = {p_: kh.family(s, d, dv, bf16, p_) for p_ in kh.TC_MAX_D}
        log(f"[routes check] hires kernels H={h} S={s} D={d} Dv={dv} (bf16 "
            f"passes: {fam}; fp32: CUDA cores): fp32 max err fwd_res "
            f"{w['fwd_res']:.3e}, fwd_only {w['fwd_only']:.3e}, dq pass "
            f"{w['dq']:.3e}, dkv pass {w['dkv']:.3e}, backward worst "
            f"{w['bwd_norm']:.3e} of the largest value; bf16 worst "
            f"{w['bf16_ratio']:.3f} x the plain bf16 error (fwd_res "
            f"{w['bf16_over_plain']['fwd_res']:.3f}, fwd_only "
            f"{w['bf16_over_plain']['fwd_only']:.3f}, dq "
            f"{w['bf16_over_plain']['dq']:.3f}, dkv "
            f"{w['bf16_over_plain']['dkv']:.3f}), two bf16 launches the "
            "same bits")
    # The CUDA-core dk/dv kernel at its edges (DKV_EDGE_CHECKS).
    metrics["dkv_edges"] = []
    for i, (dt_name, h, s, d, dv, use_mask) in enumerate(DKV_EDGE_CHECKS):
        w = check_dkv_shape(torch, ka, kh, dt_name, h, s, d, dv, use_mask,
                            seed=1700 + 2 * i)
        metrics["dkv_edges"].append({"dtype": dt_name, "H": h, "S": s,
                                     "D": d, "Dv": dv, "use_mask": use_mask,
                                     "worst": w})
        log(f"[routes check] CUDA-core dk/dv {dt_name} H={h} S={s} D={d} "
            f"Dv={dv} (slices, columns, NV {ka.dkv_split(d, dv)}): "
            + (f"fp32 worst {w:.3e} of the largest value" if dt_name ==
               "float32" else f"bf16 worst {w:.3f} x the plain bf16 error")
            + ", two launches the same bits")
    metrics["limits_seconds"] = time.time() - t0

    # The hires kernels' times at the six-head shapes past D 256, B=8,
    # beside their plain versions and bounds (per forward, or per training
    # step's backward: each shape's time x its layers): in bf16 the wide
    # tensor-core kernels, the main path's; in fp32 the CUDA-core kernels,
    # which bf16 no longer takes at these shapes.
    t0 = time.time()
    rows: dict = {}
    for dtype in (bf16, f32):
        itemsize, peak = (2, PEAK_BF16_FLOPS) if dtype == bf16 else \
            (4, PEAK_FP32_FLOPS)
        for i, ((s, d, dv), n) in enumerate(sorted(ROUTES_LAYERS.items())):
            if max(d, dv) <= kh.TC_SLICE:
                continue
            args = hires_inputs(torch, HIRES_BATCH, s, d, dv, dev, dtype,
                                seed=1560 + i, h=ROUTES_HEADS)
            g = grad_like(torch, HIRES_BATCH, s, dv, dev, dtype,
                          seed=1570 + i, h=ROUTES_HEADS)
            kw = dict(scale=d ** -0.5, dtype=dtype)
            o, m, lse = kh.hires_fwd_res_plain(*args, **kw)
            delta = (g.float() * o.float()).sum(-1)
            q, k, v, w1, b1, w2, _ = args
            dssum = kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2,
                                      **kw)[1]
            calls = {
                "fwd_res": (lambda: kh.hires_fwd_res(*args, **kw),
                            lambda: kh.hires_fwd_res_plain(*args, **kw)),
                "fwd_only": (lambda: kh.fused_attention_forward(*args, **kw),
                             lambda: ka.attention_core(*args, use_mask=True,
                                                       **kw)),
                "dq": (lambda: kh.hires_dq(q, k, v, g, m, lse, delta, w1,
                                           b1, w2, **kw),
                       lambda: kh.hires_dq_plain(q, k, v, g, m, lse, delta,
                                                 w1, b1, w2, **kw)),
                "dkv": (lambda: kh.hires_dkv(q, k, v, g, m, lse, delta,
                                             dssum, **kw),
                        lambda: kh.hires_dkv_plain(q, k, v, g, m, lse, delta,
                                                   dssum, **kw)),
            }
            bounds = hires_bounds(HIRES_BATCH, s, d, dv, itemsize,
                                  h=ROUTES_HEADS, peak=peak)
            for kname, (kern, plain) in calls.items():
                family = kh.family(s, d, dv, dtype,
                                   pass_of[wrapper_of[kname]])
                ms = cuda_ms(torch, kern, 2, warmup=1)
                plain_ms = cuda_ms(torch, plain, 2, warmup=1)
                t_bytes, t_ops = bounds[kname]
                w = worst[(s, d, dv)]
                row = dict(H=ROUTES_HEADS, S=s, D=d, Dv=dv, B=HIRES_BATCH,
                           dtype=str(dtype).removeprefix("torch."),
                           launches=n, ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by=("bytes" if t_bytes >= t_ops
                                     else "operations"),
                           fp32_err=w[kname],
                           bf16_abs_err=w["bf16_abs"][kname],
                           bf16_err_over_plain=w["bf16_over_plain"][kname])
                rows.setdefault((kname, family), []).append(row)
                log(f"[routes time] {family} {kname} H={ROUTES_HEADS} S={s} "
                    f"D={d} Dv={dv} B={HIRES_BATCH} {row['dtype']} (x{n}): "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"{row['bound_ms'] / ms:.2%} of bound; on {name} ({smi})")
            del args, g, o, m, lse, delta, dssum, calls, q, k, v
            torch.cuda.empty_cache()
    wide_kernels = []
    meta = {
        "fwd_res": ("hires_attention_fwd_res", kh.SOURCE,
                    kh.REPLACES_FWD_RES),
        "dq": ("hires_attention_dq", kh.BWD_SOURCE, kh.REPLACES_DQ),
        "dkv": ("hires_attention_dkv", kh.BWD_SOURCE, kh.REPLACES_DKV),
        "fwd_only": ("hires_attention_fwd_only", kh.SOURCE,
                     kh.REPLACES_FWD_ONLY),
    }
    for (key, family), r in sorted(rows.items()):
        kname, source, replaces = meta[key]
        t_bytes = sum(x["launches"] * x["bound_ms"] for x in r
                      if x["bound_by"] == "bytes")
        t_ops = sum(x["launches"] * x["bound_ms"] for x in r
                    if x["bound_by"] == "operations")
        # The error against the plain version on the same inputs: fp32 for
        # the CUDA-core kernels, bf16 for the wide ones (bf16 only).
        err = "bf16_abs_err" if family == "wide" else "fp32_err"
        wide_kernels.append({
            "name": f"{kname}_{family}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(x[err] for x in r),
            "max_abs_err_of": r[0]["dtype"] if family == "wide" else
            "float32",
            "ms": sum(x["launches"] * x["ms"] for x in r),
            "plain_ms": sum(x["launches"] * x["plain_ms"] for x in r),
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches_by_path": {}, "per_shape": r})
    # What the card makes of the wide kernels (the forward's and the dq
    # pass's shared memory grow with D): registers, spills, shared memory,
    # CTAs per SM; a wide kernel that spills fails the run.
    occupancy = {d: kh.wide_occupancy(d) for d in sorted(
        {d for _, d, _ in ROUTES_LAYERS if d > kh.TC_SLICE})}
    for d, occ in occupancy.items():
        for kname, o in occ.items():
            log(f"[routes] D={d} {kname}: {o['registers']} registers, spill "
                f"{o['spill_bytes']} bytes, {o['smem_bytes']} bytes of shared "
                f"memory a CTA, {o['ctas_per_sm']} CTAs per SM")
            if o["spill_bytes"] or o["ctas_per_sm"] < 1:
                raise AssertionError(f"routes: {kname} at D={d}: {o}")
    # The fp32 CUDA-core kernels (the fp32 route's, cp.async staging) as
    # the card makes them; one that spills fails the run, and so does the
    # dk/dv kernel at NV 1 short of the two CTAs an SM it is cut for.
    cc_occupancy = kh.cuda_core_occupancy()
    for kname, o in cc_occupancy.items():
        log(f"[routes] {kname}: {o['registers']} registers, spill "
            f"{o['spill_bytes']} bytes, {o['smem_bytes']} bytes of shared "
            f"memory a CTA, {o['ctas_per_sm']} CTAs per SM")
        want = 2 if kname == "hires_dkv_kernel<float, 1>" else 1
        if o["spill_bytes"] or o["ctas_per_sm"] < want:
            raise AssertionError(f"routes: {kname}: {o}")
    for k in wide_kernels:
        if k["name"].endswith("_cuda_core"):
            stem = {"dq": ("hires_dq_kernel", "hires_dm_ssum_kernel"),
                    "dkv": ("hires_dkv_kernel",)}.get(k["name"].split("_")[2],
                                   ("hires_attention_kernel",))
            k["occupancy"] = {n: o for n, o in cc_occupancy.items()
                              if n.startswith(stem)}
        if k["name"].endswith("_wide"):
            stem = {"dkv": "hires_dkv_wide_bf16_kernel",
                    "dq": "hires_dq_wide_bf16_kernel"}.get(
                k["name"].split("_")[2], "hires_attention_wide_bf16_kernel")
            flag = {"hires_attention_fwd_res_wide": ", 1>",
                    "hires_attention_fwd_only_wide": ", 0>"}.get(k["name"],
                                                                 ">")
            k["occupancy_by_D"] = {
                str(d): {n: o for n, o in occ.items()
                         if n.startswith(stem) and n.endswith(flag)}
                for d, occ in occupancy.items()}
    metrics["time_seconds"] = time.time() - t0

    # (b) chunked against xla, forced, at S 1024, D = Dv 512, H 6, B 16.
    t0 = time.time()
    b, h, s, d = ROUTES_COMPARE
    x = route_inputs(torch, (b, h, s, s, d, 0, d), dev, seed=1600)
    g = torch.from_numpy(np.random.default_rng(1601).standard_normal(
        (b, h, s, d)).astype(np.float32)).to(dev)
    x16 = {k: (t.to(bf16) if t.dim() == 4 else t) for k, t in x.items()}
    names = ("out", "q", "k", "v", "w1", "b1", "w2", "b2")

    def fwd_bwd(inputs, dtype):
        leaves = {k: t.detach().requires_grad_() for k, t in inputs.items()}
        out = route_call(ops, leaves, dtype, True)
        out.backward(g.to(out.dtype))
        return [out.detach()] + [leaves[k].grad for k in names[1:]]

    with ops.attention_impl("xla"):
        ref = fwd_bwd({k: t.float() for k, t in x16.items()}, f32)
    compare = {}
    for route in ("chunked", "xla"):
        with ops.attention_impl(route):
            chunk = ops.pick_route(b, h, s, s, d, d, bf16)[1]
            zero_counts()
            res = fwd_bwd(x16, bf16)
            torch.cuda.synchronize()
            if counts() != {f"route:{route}": 1}:
                raise AssertionError(f"routes (b) {route}: {counts()}")
            res = [t.float() for t in res]
            fwd_bwd(x16, bf16)   # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: fwd_bwd(x16, bf16), reps=3,
                         warmup=0)
            peak = torch.cuda.max_memory_allocated() - base
        compare[route] = {"chunk": chunk, "ms_fwd_bwd": ms,
                          "peak_mem_above_inputs_gib": peak / 2**30,
                          "errors": {n: norm_err(t, r) for n, t, r in
                                     zip(names, res, ref)},
                          "result": res}
        log(f"[routes] (b) {route} (chunk {chunk}) B={b} H={h} S={s} D=Dv={d} "
            f"bf16 forward + backward: {ms:.3f} ms on the card, peak memory "
            f"{peak / 2**30:.3f} GiB above the inputs, on {name} ({smi})")
    for n, c, xl, r in zip(names, compare["chunked"].pop("result"),
                           compare["xla"].pop("result"), ref):
        ec, ex = norm_err(c, r), norm_err(xl, r)
        if ec > 2 * ex + 1e-6 or ex > 2 * ec + 1e-6:
            raise AssertionError(f"routes (b) {n}: chunked error {ec:.3e}, "
                                 f"xla {ex:.3e} of the fp32 value")
        compare.setdefault("chunked_vs_xla", {})[n] = norm_err(c, xl)
    log("[routes] (b) chunked and xla within twice each other's bf16 error "
        "of the fp32 route: " + ", ".join(
            f"{n} {compare['chunked']['errors'][n]:.2e}/"
            f"{compare['xla']['errors'][n]:.2e}" for n in names)
        + "; chunked vs xla: " + ", ".join(
            f"{n} {v:.2e}" for n, v in compare["chunked_vs_xla"].items()))
    # The hires kernels on the same inputs (the route 'auto' takes here).
    zero_counts()
    hk = fwd_bwd(x16, bf16)
    torch.cuda.synchronize()
    if counts() != {"fused_hires_attention": 1, "hires_dq": 1,
                    "hires_weight_grads": 1, "hires_dkv": 1}:
        raise AssertionError(f"routes (b) hires: {counts()}")
    hires_ms = cuda_ms(torch, lambda: fwd_bwd(x16, bf16), reps=3, warmup=1)
    compare["hires_kernels"] = {
        "ms_fwd_bwd": hires_ms,
        "errors": {n: norm_err(t.float(), r) for n, t, r in
                   zip(names, hk, ref)}}
    log(f"[routes] (b) the hires kernels on the same inputs, 'auto' (the "
        "wide forward, dq and dk/dv kernels): "
        f"{hires_ms:.3f} ms forward + backward; bf16 errors of the "
        "fp32 route: " + ", ".join(
            f"{n} {v:.2e}" for n, v in
            compare["hires_kernels"]["errors"].items()))
    metrics["chunked_vs_xla"] = compare
    metrics["compare_seconds"] = time.time() - t0
    del x, x16, g, ref, hk
    torch.cuda.empty_cache()

    # (c) hires-cls-1024 at heads=6, full width.
    t0 = time.time()
    cfg = get_config("hires-cls-1024")
    mcfg, model = create_vit("hires-cls-1024", seed=cfg.init_seed,
                             device="cuda", heads=ROUTES_HEADS)
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    shapes: dict = {}
    for _, bcfg in mcfg.backbone_cfg().block_configs():
        for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(), bcfg.cross_cfg()):
            dd = (v.head_dim_content + v.head_dim_rope) if v.reduce \
                else v.head_dim
            key = (v.seq_len_new, dd, v.head_dim)
            shapes[key] = shapes.get(key, 0) + 1
    per_forward = [families(s_, dd, dv, bf16, pass_of)
                   for (s_, dd, dv), n in shapes.items() for _ in range(n)]
    derived = [{k: sum(f[j].get(k, 0) for f in per_forward) for k in want}
               for j, want in enumerate((ROUTES_CUDA_CORE, ROUTES_WIDE))]
    if shapes != ROUTES_LAYERS or derived != [ROUTES_CUDA_CORE, ROUTES_WIDE]:
        raise AssertionError(f"routes: hires-cls-1024 at heads="
                             f"{ROUTES_HEADS} has shapes {shapes}, expected "
                             f"{ROUTES_LAYERS}; CUDA-core and wide launches "
                             f"{derived}, expected {ROUTES_CUDA_CORE}, "
                             f"{ROUTES_WIDE}")
    log(f"[routes] (c) hires-cls-1024 at heads={ROUTES_HEADS}: attention "
        f"shapes (S, D, Dv): layers = {shapes}; model and power iterations "
        f"{time.time() - t0:.1f} s")
    trainee = copy.deepcopy(model)
    by_path: dict = {}

    def split(got, got_stages, cc, wd):
        """Launches and stage launches by wrapper, the hires wrappers'
        CUDA-core and wide calls apart (`<wrapper>:cuda_core`,
        `<wrapper>:wide`): every hires call of a path makes the same stage
        launches on every family."""
        launches = by_family(got, cc, wd)
        stage = dict(got_stages)
        for suffix, part in ((":cuda_core", cc), (":wide", wd)):
            for k, n in part.items():
                per_call = got_stages.get(k, 0) // got[k]
                if got_stages.get(k, 0) != per_call * got[k]:
                    raise AssertionError(f"routes {k}: {got_stages.get(k)} "
                                         f"stage launches over {got[k]} "
                                         "calls")
                if per_call:
                    stage[k] -= per_call * n
                    stage[k + suffix] = per_call * n
        return {"launches": launches,
                "stages": {k: n for k, n in stage.items() if n}}

    def want_families(names):
        """ROUTES_CUDA_CORE and ROUTES_WIDE of `names`, zeros left out."""
        return tuple({k: n for k, n in table.items() if k in names and n}
                     for table in (ROUTES_CUDA_CORE, ROUTES_WIDE))

    by_path["routes_limits"] = {"launches": limits_launches, "stages": {}}

    rng = np.random.default_rng(1700)
    images = rng.integers(0, 256, (ROUTES_TRAIN_BATCH, cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    pred = Predictor(model, crop=cfg.crop, dtype=bf16)
    zero_counts()
    labels, probs = pred.classify(images[:HIRES_BATCH])
    got, got_stages, cc, wd = counts(), stages(), cuda_core(), wide()
    log(f"[routes] (c) classify B={HIRES_BATCH} bf16: launches {got}, of them "
        f"on the CUDA-core kernels {cc} and on the wide kernels {wd}, stage "
        f"launches {got_stages}")
    want_stages = {"fused_attention_forward":
                   HIRES_STAGES_PER_CALL["fwd_only"]
                   * ROUTES_CLASSIFY_LAUNCHES["fused_attention_forward"]}
    want_cc, want_wd = want_families(("fused_attention_forward",))
    if (got != ROUTES_CLASSIFY_LAUNCHES or got_stages != want_stages
            or (cc, wd) != (want_cc, want_wd)):
        raise AssertionError(f"routes classify: expected "
                             f"{ROUTES_CLASSIFY_LAUNCHES}, {want_stages}, "
                             f"{want_cc} on CUDA cores, {want_wd} on the "
                             f"wide kernels; got {got}, {got_stages}, {cc}, "
                             f"{wd}")
    if labels.shape != (HIRES_BATCH, 5) or not np.isfinite(probs).all():
        raise AssertionError("routes classify: bad shape or non-finite")
    by_path["routes_classify"] = split(got, got_stages, cc, wd)
    p32 = Predictor(pred.model, crop=cfg.crop, dtype=f32)
    zero_counts()
    l_gpu, kl_gpu = p32.predict(images[:1])
    got, cc = counts(), cuda_core()
    n_fwd = ROUTES_CLASSIFY_LAUNCHES["fused_attention_forward"]
    if got.get("fused_attention_forward") != n_fwd or wide() \
            or cc != {"fused_attention_forward": n_fwd}:
        raise AssertionError(f"routes fp32 predict: {got}, CUDA-core {cc}, "
                             f"wide {wide()}")
    by_path["routes_predict_fp32"] = split(got, stages(), cc, {})
    t1 = time.perf_counter()
    p_cpu = Predictor(copy.deepcopy(pred.model).cpu(), crop=cfg.crop,
                      dtype=f32)
    l_cpu, kl_cpu = p_cpu.predict(images[:1])
    cpu_s = time.perf_counter() - t1
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(kl_gpu.cpu(), kl_cpu, rtol=1e-3, atol=0.0)
    log(f"[routes] (c) fp32 card vs CPU logits (1 image): max abs diff "
        f"{max_err(l_gpu.cpu(), l_cpu):.3e} (|logits| max "
        f"{float(l_cpu.abs().max()):.3e}); KL {float(kl_gpu):.6f} vs "
        f"{float(kl_cpu):.6f}; the CPU forward took {cpu_s:.1f} s")
    del p_cpu, p32
    pred.classify(images[:HIRES_BATCH])   # warm
    torch.cuda.synchronize()
    reps = 2
    t1 = time.perf_counter()
    for _ in range(reps):
        pred.classify(images[:HIRES_BATCH])
    elapsed = time.perf_counter() - t1
    serve = {"batch": HIRES_BATCH, "dtype": "bfloat16",
             "images_per_s": reps * HIRES_BATCH / elapsed}
    log(f"[routes time] classify B={HIRES_BATCH} bf16, heads="
        f"{ROUTES_HEADS}: {serve['images_per_s']:.3f} images/s, on {name} "
        f"({smi})")
    del pred, model
    torch.cuda.empty_cache()

    soft = rng.random((ROUTES_TRAIN_BATCH, cfg.model.out_features)).astype(
        np.float32)
    batch = {"image": images, "label": soft / soft.sum(-1, keepdims=True)}
    tx = make_optimizer(
        base_lr=cfg.lr * ROUTES_TRAIN_BATCH / cfg.global_batch_size,
        weight_decay=cfg.weight_decay, b1=cfg.beta1, b2=cfg.beta2,
        epochs=cfg.epochs, steps_per_epoch=1000, clip_norm=cfg.clip_norm,
        eta_min=cfg.eta_min, schedule=cfg.schedule,
        decoupled_wd=cfg.decoupled_wd)
    state = create_train_state(trainee, tx, seed=0)
    train_step = make_train_step(
        mcfg, tx, "cls", dtype=bf16, remat=True, microbatches=1,
        preprocess=lambda gen, bt: {
            "image": eval_preprocess(bt["image"], crop=cfg.crop),
            "label": bt["label"]})
    b_ = ROUTES_TRAIN_BATCH
    want_cc, want_wd = want_families(("fused_hires_attention", "hires_dq",
                                      "hires_dkv"))
    step_ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(ROUTES_TRAIN_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        got, cc, wd = counts(), cuda_core(), wide()
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        log(f"[routes] (c) training step {i} B={b_} bf16 remat: loss "
            f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.4f}, "
            f"{step_ms[-1]:.1f} ms, launches {got}, of them on the CUDA-core "
            f"kernels {cc} and on the wide kernels {wd}")
        if got != ROUTES_STEP_LAUNCHES or (cc, wd) != (want_cc, want_wd):
            raise AssertionError(f"routes training step {i}: expected "
                                 f"{ROUTES_STEP_LAUNCHES}, {want_cc} on CUDA "
                                 f"cores, {want_wd} on the wide kernels; got "
                                 f"{got}, {cc}, {wd}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"routes step {i}: {m}")
        if i == 0:
            by_path["routes_train_step_0"] = split(got, stages(), cc, wd)
            dead = [k for k, p_ in trainee.named_parameters()
                    if p_.grad is None or not torch.isfinite(p_.grad).all()
                    or float(p_.grad.abs().max()) == 0.0]
            if dead:
                raise AssertionError(f"routes: parameters with no, "
                                     f"non-finite or zero gradient: {dead}")
    train = {"batch": b_, "dtype": "bfloat16", "remat": True,
             "ms_per_step": step_ms[-1], "first_step_ms": step_ms[0],
             "images_per_s": b_ / step_ms[-1] * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "losses": losses, "launches_per_step": ROUTES_STEP_LAUNCHES}
    log(f"[routes time] training B={b_} bf16 remat, heads={ROUTES_HEADS}: "
        f"{step_ms[-1]:.1f} ms a step (first {step_ms[0]:.1f}), "
        f"{train['images_per_s']:.3f} images/s, peak memory "
        f"{train['peak_mem_gib']:.3f} GiB, on {name} ({smi})")
    del state, train_step, trainee, tx
    torch.cuda.empty_cache()
    metrics.update(serve=serve, train=train, shapes={
        str(k): n for k, n in shapes.items()}, cpu_forward_s=cpu_s,
        seconds=time.time() - t_phase)
    log(f"[routes] phase 15 in {metrics['seconds']:.1f} s on {name} ({smi})")
    return by_path, metrics, wide_kernels


def main() -> int:
    if not (ROOT / "calm_vit_dte_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(calm_vit_dte_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke test runs "
              "only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from calm_vit_dte_tpu_torch.kernels import _build
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.data.augment import eval_preprocess
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.ops.variational import noise_override
    from calm_vit_dte_tpu_torch.serve import (
        WARMUP_POWER_ITERATIONS,
        Predictor,
    )
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    t_start = time.time()

    # 1. probe
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    nvcc_version = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_state = f"imports, version {triton.__version__}"
    except ImportError as exc:
        triton_state = f"does not import ({exc})"
    log(f"[probe] device {name!r}, count {count}; nvidia-smi: {smi}")
    log(f"[probe] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[probe] nvcc: {nvcc_version}; triton {triton_state}")
    native_state = native_probe()
    from calm_vit_dte_tpu_torch.tools import time_conv as tconv

    CARD["sms"], CARD["clock_hz"] = tconv.card_clock()
    log(f"[probe] {CARD['sms']} SMs, SM clock at most "
        f"{CARD['clock_hz'] / 1e6:.0f} MHz: the conv kernels' CUDA-core "
        f"floor is lane-ops per pixel x pixels / (SMs x 128 x clock), with "
        f"lane-ops per pixel {tconv.LANE_OPS} in bf16 and "
        f"{tconv.LANE_OPS_F32} in fp32 (tools/time_conv.py)")

    # 2. build
    t0 = time.time()
    logs = _build.build(["axial_attention", "axial_attention_bwd",
                         "conv_residual", "conv_residual_bwd",
                         "hires_attention", "hires_attention_bwd",
                         "relayout"])
    log(f"[build] {len(logs)} sources built in {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for src, text in logs.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"[build] {src}: {len(regs)} kernel instantiations, "
            f"{min(regs)}-{max(regs)} registers, largest spill "
            f"{max(spills)} bytes")
        for kname, kregs, kspill in kernel_registers(text):
            if any(k in kname for k in TENSOR_CORE_KERNELS
                   + CUDA_CORE_KERNELS):
                log(f"[build] {src}: {kname}: {kregs} registers, spill "
                    f"{kspill} bytes")
            if kspill and any(k in kname for k in NO_SPILL_KERNELS):
                raise AssertionError(f"{src}: {kname} spills {kspill} bytes")
    # The fp32 rope route's kernels as the card reports them: its own, the
    # strided product, and the CUDA-core hires kernels it runs; a spill, or
    # no CTA an SM, fails the run.
    for kname, o in ka.f32_occupancy().items():
        log(f"[build] fp32 rope route: {kname}: {o['registers']} registers, "
            f"spill {o['spill_bytes']} bytes, {o['smem_bytes']} bytes of "
            f"shared memory a CTA, {o['ctas_per_sm']} CTAs per SM")
        if o["spill_bytes"] or o["ctas_per_sm"] < 1:
            raise AssertionError(f"fp32 rope route: {kname} spills "
                                 f"{o['spill_bytes']} bytes, "
                                 f"{o['ctas_per_sm']} CTAs per SM")
    # Every conv kernel instantiation as the card reports it; each, fp32
    # and bf16, must keep the CTAs an SM its launch bound asks for, with no
    # spill (csrc/conv_residual{,_bwd}.cu notes).
    want_ctas = {kc.KERNEL_NAMES[(dt, what)]: n
                 for dt, by_kernel in kc.MIN_CTAS.items()
                 for what, n in by_kernel.items()}
    for kname, o in kc.card_occupancy().items():
        log(f"[build] conv: {kname}: {o['registers']} registers, spill "
            f"{o['spill_bytes']} bytes, {o['smem_bytes']} bytes of shared "
            f"memory a CTA, {o['ctas_per_sm']} CTAs per SM")
        if kname in want_ctas and (o["ctas_per_sm"] < want_ctas[kname]
                                   or o["spill_bytes"]):
            raise AssertionError(f"{kname}: {o['ctas_per_sm']} CTAs per SM "
                                 f"(want {want_ctas[kname]}), spill "
                                 f"{o['spill_bytes']} bytes")

    # 3. kernel vs plain at every flagship shape (and imagenet-cls-256's)
    cfg = get_config("imagenet-cls-224")
    attn_shapes, conv_sizes = flagship_shapes(cfg.model)
    cfg256 = get_config("imagenet-cls-256")
    attn256, conv256 = flagship_shapes(cfg256.model)
    log(f"[check] attention shapes (S, Dc, Dr, Dv): launches = "
        f"{attn_shapes}; conv S: launches = {conv_sizes}; imagenet-cls-256: "
        f"{attn256}, conv {conv256}")
    per_attn: dict[tuple, dict] = {}
    check_shapes = sorted(attn_shapes, reverse=True) + sorted(attn256,
                                                              reverse=True)
    # The wrapper's shared-memory helpers (which the CPU tests hold to the
    # 232,448-byte limit) against the sizes the C launches use.
    for s, dc, dr, dv in check_shapes:
        for use_mask in (True, False):
            want = {"forward": (ka.smem_bytes(s, dc + dr, dv, use_mask),
                                ka.fwd_kv_stages(s, dc + dr, dv, use_mask)),
                    "rows": ka.bwd_rows_smem_bytes(s, dc + dr, dv, use_mask),
                    "keys": ka.bwd_keys_smem_bytes(s, dc + dr, dv, use_mask)}
            got = ka.card_layout(s, dc + dr, dv, use_mask)
            if got != want:
                raise AssertionError(f"shared memory at S={s}, D={dc + dr}, "
                                     f"Dv={dv}, mask {use_mask}: the C "
                                     f"launch sizes {got}, the wrapper {want}")
    log("[check] bf16 rope kernels' shared memory: the wrapper's helpers "
        "equal the C launches' at every shape, mask on and off; forward K/V "
        "stages (S: stages, with the mask): " + ", ".join(
            f"{s}: {ka.fwd_kv_stages(s, dc + dr, dv)}"
            for s, dc, dr, dv in check_shapes if dc))
    for i, (s, dc, dr, dv) in enumerate(check_shapes):
        args = attn_inputs(torch, CHECK_BATCH, s, dc, dr, dv, dev, f32,
                           seed=i)
        kw = dict(scale=1.0 / (dc + dr) ** 0.5)
        out = ka.fused_rope_attention(*args, dtype=f32, **kw)
        ref = ka.fused_rope_attention_plain(*args, dtype=f32, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
        a16 = cast(torch, args, bf16)
        errs = {}
        for use_mask in (True, False):
            p16 = ka.fused_rope_attention_plain(*a16, dtype=bf16,
                                                use_mask=use_mask, **kw)
            ref16 = ka.fused_rope_attention_plain(*cast(torch, a16, f32),
                                                  dtype=f32,
                                                  use_mask=use_mask, **kw)
            k16 = ka.fused_rope_attention(*a16, dtype=bf16,
                                          use_mask=use_mask, **kw)
            e_k, e_p = max_err(k16, ref16), max_err(p16, ref16)
            if not e_k <= 2 * e_p:
                raise AssertionError(
                    f"attention S={s} Dc={dc} use_mask={use_mask}: bf16 "
                    f"kernel error {e_k} > 2 x plain bf16 {e_p}")
            errs[use_mask] = (e_k, e_p)
        per_attn[(s, dc, dr, dv)] = {"fp32_err": max_err(out, ref),
                                     "bf16_err": errs[True][0],
                                     "plain_bf16_err": errs[True][1]}
        log(f"[check] attention S={s} Dc={dc} Dr={dr} Dv={dv}: fp32 max "
            f"err {max_err(out, ref):.3e}; bf16 err kernel "
            f"{errs[True][0]:.3e} vs plain {errs[True][1]:.3e} (mask off "
            f"{errs[False][0]:.3e} vs {errs[False][1]:.3e})")
    # The conv kernels' launches in both compute types against the
    # wrapper's helpers (which the CPU tests hold to the sources' notes),
    # and the bf16 GELU's error.
    for s in sorted(set(conv_sizes) | set(conv256), reverse=True):
        for dt in (f32, bf16):
            want = {what: (*kc.fwd_grid(CHECK_BATCH, s, dt, save),
                           kc.THREADS,
                           kc.fwd_smem(dt, save) - kc._FWD_WEIGHTS_SMEM)
                    for what, save in (("forward", False),
                                       ("forward with residuals", True))}
            want["backward"] = (*kc.bwd_grid(CHECK_BATCH, s), kc.THREADS,
                                kc.bwd_smem())
            want["bwd_rows"] = math.prod(kc.bwd_grid(CHECK_BATCH, s))
            got = kc.card_geometry(CHECK_BATCH, s, dt)
            if got != want:
                raise AssertionError(f"conv geometry at S={s}, {dt}: the C "
                                     f"launches {got}, the wrapper {want}")
    grid = torch.linspace(-10.0, 10.0, 2**20 + 1, device=dev)
    erf_err = max_err(kc.erf_bf16_probe(grid)[0],
                      torch.erf(grid * 0.7071067811865476))
    if not erf_err <= kc.ERF_BF16_MAX_ERR:
        raise AssertionError(f"bf16 conv erf error {erf_err:.3e} > "
                             f"{kc.ERF_BF16_MAX_ERR}")
    log(f"[check] conv kernels' grids, threads, shared memory and partial "
        f"rows, fp32 and bf16, equal the wrapper's helpers at every conv S; "
        f"the bf16 erf within {erf_err:.3e} of erff over [-10, 10] (bound "
        f"{kc.ERF_BF16_MAX_ERR})")
    del grid
    per_conv: dict[int, dict] = {}
    for i, s in enumerate(sorted(set(conv_sizes) | set(conv256),
                                 reverse=True)):
        args = conv_inputs(torch, CHECK_BATCH, s, dev, f32, seed=100 + i)
        out = kc.fused_conv_residual(*args, dtype=f32)
        if not torch.equal(out, kc.fused_conv_residual(*args, dtype=f32)):
            raise AssertionError(f"conv S={s}: two fp32 launches differ")
        ref = kc.fused_conv_residual_plain(*args, dtype=f32)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
        a16 = (args[0].to(bf16),) + args[1:]
        k16 = kc.fused_conv_residual(*a16, dtype=bf16)
        if not torch.equal(k16, kc.fused_conv_residual(*a16, dtype=bf16)):
            raise AssertionError(f"conv S={s}: two bf16 launches differ")
        p16 = kc.fused_conv_residual_plain(*a16, dtype=bf16)
        ref16 = kc.fused_conv_residual_plain(a16[0].float(), *args[1:],
                                             dtype=f32)
        e_k, e_p = max_err(k16, ref16), max_err(p16, ref16)
        if not e_k <= 2 * e_p:
            raise AssertionError(f"conv S={s}: bf16 kernel error {e_k} > "
                                 f"2 x plain bf16 {e_p}")
        per_conv[s] = {"fp32_err": max_err(out, ref), "bf16_err": e_k,
                       "plain_bf16_err": e_p}
        log(f"[check] conv S={s}: fp32 max err {max_err(out, ref):.3e}; "
            f"bf16 err kernel {e_k:.3e} vs plain {e_p:.3e}, two launches "
            "bit-identical in each type")

    # The attention kernels with no rope half (Dr = 0: the function of the
    # JAX package's `_make_fused`), which `ops.attention.masked_attention`
    # reaches; and the backward at every flagship shape and at Dr = 0.
    no_rope_shapes = [(224, 56, 0, 56), (80, 20, 0, 20)]
    per_no_rope: dict[tuple, dict] = {}
    for i, (s, dc, dr, dv) in enumerate(no_rope_shapes):
        args = attn_inputs(torch, CHECK_BATCH, s, dc, dr, dv, dev, f32,
                           seed=400 + i)
        worst32 = worst16 = worst_p = 0.0
        for use_mask in (True, False):
            kw = dict(scale=1.0 / dc ** 0.5, use_mask=use_mask)
            out = ka.fused_rope_attention(*args, dtype=f32, **kw)
            ref = ka.fused_rope_attention_plain(*args, dtype=f32, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
            a16 = cast(torch, args, bf16)
            p16 = ka.fused_rope_attention_plain(*a16, dtype=bf16, **kw)
            ref16 = ka.fused_rope_attention_plain(*cast(torch, a16, f32),
                                                  dtype=f32, **kw)
            e_p = max_err(p16, ref16)
            e_k = max_err(ka.fused_rope_attention(*a16, dtype=bf16, **kw),
                          ref16)
            if not e_k <= 2 * e_p:
                raise AssertionError(
                    f"attention S={s} Dr=0 use_mask={use_mask}: bf16 kernel "
                    f"error {e_k} > 2 x plain bf16 {e_p}")
            worst16, worst_p = max(worst16, e_k), max(worst_p, e_p)
            worst32 = max(worst32, max_err(out, ref))
        per_no_rope[(s, dc, dr, dv)] = {
            "fp32_err": worst32, "bf16_err": worst16,
            "plain_bf16_err": worst_p}
        log(f"[check] attention S={s} D={dc} Dr=0 (mask on and off): fp32 "
            f"max err {worst32:.3e}; bf16 err kernels {worst16:.3e}, plain "
            f"{worst_p:.3e}")

    per_bwd: dict[tuple, dict] = {}
    bwd_shapes = check_shapes + no_rope_shapes
    for i, (s, dc, dr, dv) in enumerate(bwd_shapes):
        args = attn_inputs(torch, CHECK_BATCH, s, dc, dr, dv, dev, f32,
                           seed=500 + i)
        g = grad_like(torch, CHECK_BATCH, s, dv, dev, f32, seed=600 + i)
        scale = 1.0 / (dc + dr) ** 0.5
        n0 = ka.fused_rope_attention_bwd.launches
        with_mask = check_attention_bwd(torch, ka, args, g, scale, True)
        no_mask = check_attention_bwd(torch, ka, args, g, scale, False)
        if ka.fused_rope_attention_bwd.launches != n0 + 6:
            raise AssertionError("the backward wrapper did not count its "
                                 "launches")
        per_bwd[(s, dc, dr, dv)] = {
            "fp32_err": max(with_mask[1], no_mask[1]),
            "fp32_norm_err": max(with_mask[0], no_mask[0]),
            "bf16_err": with_mask[2], "plain_bf16_err": with_mask[3]}
        log(f"[check] attention backward S={s} Dc={dc} Dr={dr} Dv={dv}: "
            f"fp32 worst gradient error {with_mask[0]:.3e} of its largest "
            f"value (mask off {no_mask[0]:.3e}); bf16 worst {with_mask[2]:.3e}"
            f" vs plain {with_mask[3]:.3e} (mask off {no_mask[2]:.3e} vs "
            f"{no_mask[3]:.3e}); bf16 twice bit-identical")

    # The autograd Function (both kernels) against torch autograd of the
    # plain forward: an independent check of the backward's formulas.
    s, dc, dr, dv = 80, 10, 10, 20
    args = attn_inputs(torch, 2, s, dc, dr, dv, dev, f32, seed=700)
    g = grad_like(torch, 2, s, dv, dev, f32, seed=701)

    def autograd_of(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, scale=1.0 / (dc + dr) ** 0.5, dtype=f32).backward(g)
        return [a.grad for a in leaves]

    worst = max(norm_err(x, y) for x, y in zip(
        autograd_of(ka.fused_rope_attention),
        autograd_of(ka.fused_rope_attention_plain)))
    if not worst <= BWD_FP32_LIMIT:
        raise AssertionError(f"Function vs autograd of the plain forward: "
                             f"worst gradient error {worst:.3e}")
    log(f"[check] attention Function vs torch autograd of the plain forward "
        f"(S={s}, Dc={dc}, Dr={dr}): worst gradient error {worst:.3e} of its "
        "largest value")

    # The fp32 route (CUDA cores) against its plain versions at B = 1, 2
    # and 8: every flagship and imagenet-cls-256 shape, Dr = 0 and a shape
    # with odd Dc and Dv that only fp32 takes, mask on and off; each call's
    # stage launches exact and its hires calls' shared memory a CTA the
    # helpers' (`ka.f32_smem_bytes`); at B = 8 the backward launched twice,
    # bit for bit.
    f32_shapes = check_shapes + no_rope_shapes + [F32_ODD_SHAPE]
    per_f32: dict[tuple, dict] = {}
    for bi, b in enumerate(F32_CHECK_BATCHES):
        worst_f = worst_b = 0.0
        for i, (s, dc, dr, dv) in enumerate(f32_shapes):
            args = attn_inputs(torch, b, s, dc, dr, dv, dev, f32,
                               seed=800 + 50 * bi + i)
            g = grad_like(torch, b, s, dv, dev, f32, seed=900 + 50 * bi + i)
            for use_mask in (True, False):
                what = (f"fp32 route B={b} S={s} Dc={dc} Dr={dr} Dv={dv} "
                        f"mask={use_mask}")
                kw = dict(scale=1.0 / (dc + dr) ** 0.5, dtype=f32,
                          use_mask=use_mask)
                zero_rope_counts(ka)
                out = ka.fused_rope_attention(*args, **kw)
                got = ka.fused_rope_attention_bwd(g, *args, **kw)
                torch.cuda.synchronize()
                rope_counts(ka, what, True, use_mask)
                want_smem = ka.f32_smem_bytes(s, dc + dr, dv)
                got_smem = dict(ka.fused_rope_attention_bwd.f32_smem_bytes)
                if (got_smem != want_smem or ka.fused_rope_attention
                        .f32_smem_bytes["forward"] != want_smem["forward"]):
                    raise AssertionError(f"{what}: shared memory a CTA "
                                         f"{got_smem}, the helpers "
                                         f"{want_smem}")
                ref = ka.fused_rope_attention_plain(*args, **kw)
                torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
                refs = ka.fused_rope_attention_bwd_plain(g, *args, **kw)
                worst = 0.0
                for gname, x, y in zip(GRAD_NAMES, got, refs):
                    if (x is None) != (y is None):
                        raise AssertionError(f"{what}: {gname} present on "
                                             "one side only")
                    if x is None:
                        continue
                    if x.shape != y.shape or x.dtype != y.dtype:
                        raise AssertionError(f"{what}: {gname} shape or "
                                             "dtype differs")
                    e = norm_err(x, y)
                    if not e <= BWD_FP32_LIMIT:
                        raise AssertionError(f"{what}: {gname} error {e:.3e} "
                                             f"of its largest value > "
                                             f"{BWD_FP32_LIMIT}")
                    worst = max(worst, e)
                if b == CHECK_BATCH:
                    again = ka.fused_rope_attention_bwd(g, *args, **kw)
                    for gname, x, y in zip(GRAD_NAMES, got, again):
                        if x is not None and not torch.equal(x, y):
                            raise AssertionError(f"{what}: {gname} differs "
                                                 "between two launches")
                row = per_f32.setdefault((s, dc, dr, dv), {
                    "fp32_fwd_err": 0.0, "fp32_bwd_norm_err": 0.0})
                row["fp32_fwd_err"] = max(row["fp32_fwd_err"],
                                          max_err(out, ref))
                row["fp32_bwd_norm_err"] = max(row["fp32_bwd_norm_err"],
                                               worst)
                worst_f = max(worst_f, max_err(out, ref))
                worst_b = max(worst_b, worst)
            del args, g, out, got, refs
        log(f"[check] fp32 rope route B={b}, {len(f32_shapes)} shapes (the "
            f"flagship's, imagenet-cls-256's, Dr = 0, odd Dc and Dv "
            f"{F32_ODD_SHAPE}), mask on and off: forward max err "
            f"{worst_f:.3e} (rtol 2e-4 / atol 2e-5), worst gradient "
            f"{worst_b:.3e} of its largest value (limit {BWD_FP32_LIMIT}); "
            f"stage launches {ka.f32_stage_launches(True)} a call with the "
            f"mask, {ka.f32_stage_launches(False)} without; shared memory "
            "a CTA the helpers'"
            + ("; the backward twice bit-identical" if b == CHECK_BATCH
               else ""))

    # The CUDA-core dk/dv kernel alone at the same shapes (D = Dc + Dr, not
    # padded: the odd shape takes the register path), B=2, mask on and off,
    # against hires_dkv_plain; two launches bit for bit.
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    worst_dkv = 0.0
    for i, (s, dc, dr, dv) in enumerate(f32_shapes):
        for use_mask in (True, False):
            worst_dkv = max(worst_dkv, check_dkv_shape(
                torch, ka, kh, "float32", H, s, dc + dr, dv, use_mask,
                seed=1000 + 2 * i))
    log(f"[check] CUDA-core dk/dv kernel at the {len(f32_shapes)} fp32 "
        f"shapes, B={HIRES_CHECK_BATCH}, mask on and off: worst {worst_dkv:.3e}"
        f" of the largest value (limit {BWD_FP32_LIMIT}), two launches the "
        "same bits")

    # 4. the main path through the user's entry points
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TIME_BATCH, cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    pred = Predictor.fresh("imagenet-cls-224", seed=0, device="cuda")
    ka.fused_rope_attention.launches = 0
    ka.fused_rope_attention.stage_launches = 0
    kc.fused_conv_residual.launches = 0
    labels, probs = pred.classify(images)
    main_launches = {"attention": ka.fused_rope_attention.launches,
                     "conv": kc.fused_conv_residual.launches}
    # One prologue beside each bf16 forward, as the C entry reports.
    stage_by_path = {"classify": ka.fused_rope_attention.stage_launches}
    if stage_by_path["classify"] != main_launches["attention"]:
        raise AssertionError(f"classify: {stage_by_path['classify']} "
                             f"forward prologues for "
                             f"{main_launches['attention']} forwards")
    log(f"[serve] classify B={TIME_BATCH} bf16: launches {main_launches}, "
        f"top-5 of image 0 {labels[0].tolist()} p={probs[0].tolist()}")
    if main_launches != {"attention": 24, "conv": 8}:
        raise AssertionError(f"expected 24 attention + 8 conv launches, got "
                             f"{main_launches}")
    if labels.shape != (TIME_BATCH, 5) or not np.isfinite(probs).all() \
            or not (np.diff(probs, axis=-1) <= 0).all():
        raise AssertionError("classify: bad shape, non-finite or unsorted "
                             "top-k probabilities")
    logits, kl = pred.predict(images)
    if not (torch.isfinite(logits).all() and torch.isfinite(kl)):
        raise AssertionError("classify: non-finite bf16 logits or KL")

    p32 = Predictor(pred.model, crop=cfg.crop, dtype=f32)
    zero_rope_counts(ka)
    l_gpu, kl_gpu = p32.predict(images[:2])
    got32 = rope_counts(ka, "fp32 predict", True)
    if (got32["attention_fwd"], got32["attention_bwd"]) != (24, 0):
        raise AssertionError(f"fp32 predict: rope launches {got32}")
    # The fp32 paths' rope launches (the CUDA-core route), by path.
    f32_paths = {"predict_fp32_card_vs_cpu": got32}
    p_cpu = Predictor(copy.deepcopy(pred.model).cpu(), crop=cfg.crop,
                      dtype=f32)
    l_cpu, kl_cpu = p_cpu.predict(images[:2])
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(kl_gpu.cpu(), kl_cpu, rtol=1e-3, atol=0.0)
    log(f"[serve] fp32 card vs CPU logits: max abs diff "
        f"{max_err(l_gpu.cpu(), l_cpu):.3e} (|logits| max "
        f"{float(l_cpu.abs().max()):.3e}); KL {float(kl_gpu):.6f} vs "
        f"{float(kl_cpu):.6f}")
    del p_cpu

    reg = Predictor.fresh("imagenet-reg-224", seed=0, device="cuda")
    ka.fused_rope_attention.launches = 0
    kc.fused_conv_residual.launches = 0
    recon = reg.reconstruct(images[:CHECK_BATCH])
    reg_launches = {"attention": ka.fused_rope_attention.launches,
                    "conv": kc.fused_conv_residual.launches}
    log(f"[serve] reconstruct B={CHECK_BATCH} bf16: launches {reg_launches},"
        f" shape {recon.shape}, range [{recon.min():.4f}, "
        f"{recon.max():.4f}]")
    if reg_launches != {"attention": 24, "conv": 9}:
        raise AssertionError(f"expected 24 attention + 9 conv launches, got "
                             f"{reg_launches}")
    if recon.shape != (CHECK_BATCH, 224, 224, 3) or not (
            np.isfinite(recon).all() and recon.min() >= 0
            and recon.max() <= 1):
        raise AssertionError("reconstruct: bad shape or values outside [0,1]")
    del reg

    # imagenet-cls-256: its shapes sit at every limit of the rope route.
    pred256 = Predictor.fresh("imagenet-cls-256", seed=0, device="cuda")
    images256 = np.random.default_rng(256).integers(
        0, 256, (TIME_BATCH, cfg256.image_size, cfg256.image_size, 3),
        dtype=np.uint8)
    ka.fused_rope_attention.launches = 0
    kc.fused_conv_residual.launches = 0
    labels256, probs256 = pred256.classify(images256)
    cls256_launches = {"attention": ka.fused_rope_attention.launches,
                       "conv": kc.fused_conv_residual.launches}
    if cls256_launches != {"attention": 24, "conv": 8}:
        raise AssertionError(f"imagenet-cls-256 classify: expected 24 + 8 "
                             f"launches, got {cls256_launches}")
    if labels256.shape != (TIME_BATCH, 5) or not np.isfinite(probs256).all():
        raise AssertionError("imagenet-cls-256 classify: bad shape or "
                             "non-finite probabilities")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        pred256.classify(images256)
    cls256_img_s = 3 * TIME_BATCH / (time.perf_counter() - t0)
    log(f"[serve] imagenet-cls-256 classify B={TIME_BATCH} bf16: launches "
        f"{cls256_launches}, {cls256_img_s:.2f} images/s, top-5 of image 0 "
        f"{labels256[0].tolist()}")
    del pred256

    # 5. the training path: a trainer that takes a few steps
    TRAIN_STEPS = 6
    soft = rng.random((TIME_BATCH, cfg.model.out_features)).astype(np.float32)
    soft[np.arange(TIME_BATCH), rng.integers(0, cfg.model.out_features,
                                             TIME_BATCH)] += 50.0
    train_batch = {"image": images,
                   "label": soft / soft.sum(-1, keepdims=True)}

    def preprocess(generator, batch):
        # The training augmentations are not ported yet: center crop and
        # normalize on the device, as serving does.
        return {"image": eval_preprocess(batch["image"], crop=cfg.crop),
                "label": batch["label"]}

    def optimizer():
        # The config's lr belongs to its global batch of 1936; one card at
        # B=128 takes it scaled linearly with the batch.
        return make_optimizer(
            base_lr=cfg.lr * TIME_BATCH / cfg.global_batch_size,
            weight_decay=cfg.weight_decay, b1=cfg.beta1,
            b2=cfg.beta2, epochs=cfg.epochs, steps_per_epoch=1000,
            clip_norm=cfg.clip_norm, eta_min=cfg.eta_min,
            schedule=cfg.schedule, decoupled_wd=cfg.decoupled_wd)

    def counts():
        return {"attention_fwd": ka.fused_rope_attention.launches,
                "attention_bwd": ka.fused_rope_attention_bwd.launches,
                "conv": kc.fused_conv_residual.launches}

    def zero_counts():
        ka.fused_rope_attention.launches = 0
        ka.fused_rope_attention_bwd.launches = 0
        ka.fused_rope_attention.stage_launches = 0
        ka.fused_rope_attention_bwd.stage_launches = 0
        kc.fused_conv_residual.launches = 0

    _, model = create_vit("imagenet-cls-224", seed=cfg.init_seed,
                          device="cuda")
    with torch.no_grad():   # converge u/v as Predictor.fresh does
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    start_model = copy.deepcopy(model)
    tx = optimizer()
    state = create_train_state(model, tx, seed=0)
    train_step = make_train_step(cfg.model, tx, "cls", dtype=bf16,
                                 remat=cfg.remat, preprocess=preprocess,
                                 microbatches=1)
    uv0 = {k: v.clone() for k, v in model.named_buffers()
           if k.endswith(("weight_u", "weight_v"))}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    train_losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, train_batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        train_losses.append(m["loss"])
        per_step = {k: v - before[k] for k, v in counts().items()}
        log(f"[train] step {i}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.4f}, kl {m['kl']:.6f}, accuracy "
            f"{m['accuracy']:.4f}, {step_ms[-1]:.1f} ms, launches {per_step}")
        if per_step != {"attention_fwd": 24, "attention_bwd": 24, "conv": 0}:
            raise AssertionError(
                f"expected 24 forward + 24 backward attention launches and "
                f"no fused-conv launch per training step, got {per_step}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0 and np.isfinite(m["kl"])):
            raise AssertionError(f"step {i}: non-finite loss, kl or "
                                 f"grad_norm, or zero grad_norm: {m}")
        if i == 0:
            dead = [k for k, p_ in model.named_parameters()
                    if p_.grad is None or not torch.isfinite(p_.grad).all()
                    or float(p_.grad.abs().max()) == 0.0]
            if dead:
                raise AssertionError(f"parameters with no, non-finite or "
                                     f"zero first-step gradient: {dead}")
            n_params = sum(p_.numel() for p_ in model.parameters())
            log(f"[train] every one of {len(list(model.parameters()))} "
                f"parameter tensors ({n_params / 1e6:.2f}M values) has a "
                "finite nonzero gradient, inv_freq of both RoPEs and the "
                "mask MLP included")
    train_launches = counts()
    train_stages = rope_counts(ka, "train", False)["stages"]
    stage_by_path[f"train_{TRAIN_STEPS}_steps"] = train_stages["attention_fwd"]
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{train_losses}")
    if state.step != TRAIN_STEPS or state.opt_state.count != TRAIN_STEPS:
        raise AssertionError("a training step was skipped")
    unchanged = [k for k, v in model.named_buffers()
                 if k in uv0 and torch.equal(v, uv0[k])]
    if unchanged:
        raise AssertionError(f"u/v buffers not updated: {unchanged[:5]}")
    steady_ms = float(np.mean(step_ms[1:]))
    train_img_s = TIME_BATCH / steady_ms * 1e3
    log(f"[train] B={TIME_BATCH} bf16 remat={cfg.remat} microbatches=1: "
        f"{steady_ms:.1f} ms per step (steps 1-{TRAIN_STEPS - 1}; first "
        f"{step_ms[0]:.1f}), {train_img_s:.2f} images/s, peak memory "
        f"{train_peak_gib:.3f} GiB, on {name} ({smi})")

    zero_counts()
    ev = make_eval_step(cfg.model, "cls", dtype=bf16)(
        state, {"image": eval_preprocess(
            torch.from_numpy(images).to(dev), crop=cfg.crop),
            "label": train_batch["label"].argmax(-1)})
    eval_launches = counts()
    stage_by_path["eval_step"] = rope_counts(
        ka, "eval step", False)["stages"]["attention_fwd"]
    log(f"[train] eval step on the trained state: {int(ev['correct'])} of "
        f"{int(ev['total'])} correct, kl {float(ev['kl']):.6f}, launches "
        f"{eval_launches}")
    if eval_launches != {"attention_fwd": 24, "attention_bwd": 0, "conv": 8}:
        raise AssertionError(f"eval step: expected 24 + 8 launches, got "
                             f"{eval_launches}")
    if not torch.isfinite(ev["kl"]):
        raise AssertionError("eval step: non-finite KL")

    # One fp32 step on 2 images, card vs CPU: same weights, same injected
    # noise.
    small = {k: v[:2] for k, v in train_batch.items()}
    sides = {}
    zero_rope_counts(ka)
    for side, remat in (("cuda", True), ("cpu", False)):
        m_side = copy.deepcopy(start_model).to(side)
        tx_side = optimizer()
        step_side = make_train_step(cfg.model, tx_side, "cls", dtype=f32,
                                    remat=remat, preprocess=preprocess)
        t0 = time.perf_counter()
        with noise_override(NoiseSeq()):
            _, m = step_side(create_train_state(m_side, tx_side, seed=0),
                             small)
        sides[side] = ({k: float(v) for k, v in m.items()},
                       {k: p_.grad.cpu() for k, p_ in
                        m_side.named_parameters()})
        log(f"[train] fp32 step on 2 images on {side} (remat={remat}): "
            f"{sides[side][0]}, {time.perf_counter() - t0:.1f} s")
        del m_side
    f32_paths["train_step_fp32_card_vs_cpu"] = got32 = rope_counts(
        ka, "fp32 step", True)
    if (got32["attention_fwd"], got32["attention_bwd"]) != (24, 24):
        raise AssertionError(f"fp32 step: rope launches {got32}")
    (m_gpu, g_gpu), (m_cpu, g_cpu) = sides["cuda"], sides["cpu"]
    np.testing.assert_allclose(m_gpu["loss"], m_cpu["loss"], rtol=2e-4)
    np.testing.assert_allclose(m_gpu["grad_norm"], m_cpu["grad_norm"],
                               rtol=2e-3)
    worst = ("", 0.0)
    for k, want in g_cpu.items():
        top = max(float(want.abs().max()), 1e-12)
        torch.testing.assert_close(g_gpu[k], want, rtol=5e-3,
                                   atol=2e-4 * top, msg=lambda m_, k=k:
                                   f"gradient of {k}: {m_}")
        worst = max(worst, (k, max_err(g_gpu[k], want) / top),
                    key=lambda t: t[1])
    log(f"[train] fp32 card vs CPU: loss {m_gpu['loss']:.6f} vs "
        f"{m_cpu['loss']:.6f}; {len(g_cpu)} gradient leaves within rtol 5e-3 "
        f"/ atol 2e-4 of each leaf's largest value; worst {worst[0]} at "
        f"{worst[1]:.3e} of its largest value")
    del sides, g_gpu, g_cpu, start_model

    # One bf16 training step of imagenet-cls-256 at B=128.
    _, model256 = create_vit("imagenet-cls-256", seed=cfg256.init_seed,
                             device="cuda")
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model256, training=True)
    soft256 = np.random.default_rng(257).random(
        (TIME_BATCH, cfg256.model.out_features)).astype(np.float32)
    tx256 = optimizer()
    state256 = create_train_state(model256, tx256, seed=0)
    step256 = make_train_step(
        cfg256.model, tx256, "cls", dtype=bf16, remat=cfg256.remat,
        preprocess=lambda gen, b_: {
            "image": eval_preprocess(b_["image"], crop=cfg256.crop),
            "label": b_["label"]})
    zero_counts()
    t0 = time.perf_counter()
    state256, m256 = step256(state256, {
        "image": images256, "label": soft256 / soft256.sum(-1, keepdims=True)})
    torch.cuda.synchronize()
    step256_ms = (time.perf_counter() - t0) * 1e3
    launches256 = counts()
    bad = [k for k, p_ in model256.named_parameters()
           if p_.grad is None or not torch.isfinite(p_.grad).all()]
    if (launches256 != {"attention_fwd": 24, "attention_bwd": 24, "conv": 0}
            or not np.isfinite(float(m256["loss"])) or bad):
        raise AssertionError(f"imagenet-cls-256 step: launches "
                             f"{launches256}, loss {float(m256['loss'])}, "
                             f"non-finite gradients {bad[:5]}")
    log(f"[train] imagenet-cls-256 bf16 step B={TIME_BATCH}: loss "
        f"{float(m256['loss']):.6f}, grad_norm "
        f"{float(m256['grad_norm']):.4f}, every gradient finite, launches "
        f"{launches256}, {step256_ms:.1f} ms (first step)")
    del model256, state256, step256, tx256
    torch.cuda.empty_cache()

    # 6. timing at B=128 bf16. The shapes with Dr = 0 and those of
    # imagenet-cls-256 are not on the flagship's path (launches 0): they
    # time the `_make_fused` case and the other config.
    attn_rows, bwd_rows, conv_rows = [], [], []
    conv_floor = 0.0   # per flagship forward, for the log
    timed = [(shape, attn_shapes[shape], per_attn[shape], None)
             for shape in sorted(attn_shapes, reverse=True)]
    timed += [(shape, 0, per_attn[shape], attn256[shape])
              for shape in sorted(attn256, reverse=True)]
    timed += [(shape, 0, per_no_rope[shape], None)
              for shape in no_rope_shapes]
    for i, ((s, dc, dr, dv), launches, errs, l256) in enumerate(timed):
        args = attn_inputs(torch, TIME_BATCH, s, dc, dr, dv, dev, bf16,
                           seed=200 + i)
        g = grad_like(torch, TIME_BATCH, s, dv, dev, bf16, seed=250 + i)
        kw = dict(scale=1.0 / (dc + dr) ** 0.5, dtype=bf16)
        extra = {} if l256 is None else {"config": "imagenet-cls-256",
                                          "launches_cls256": l256}
        # plain, kernel, kernel, plain: both read twice in one call
        plain_a = cuda_ms(torch,
                          lambda: ka.fused_rope_attention_plain(*args, **kw),
                          3, warmup=1)
        ms_a = cuda_ms(torch, lambda: ka.fused_rope_attention(*args, **kw),
                       10)
        ms_b = cuda_ms(torch, lambda: ka.fused_rope_attention(*args, **kw),
                       10)
        plain_b = cuda_ms(torch,
                          lambda: ka.fused_rope_attention_plain(*args, **kw),
                          3, warmup=0)
        ms, plain = min(ms_a, ms_b), min(plain_a, plain_b)
        t_bytes, t_ops = attn_bound(TIME_BATCH, s, dc, dr, dv, 2)
        row = dict(S=s, Dc=dc, Dr=dr, Dv=dv, launches=launches, ms=ms,
                   plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   ms_reads=[ms_a, ms_b], plain_ms_reads=[plain_a, plain_b],
                   **extra, **errs)
        attn_rows.append(row)
        log(f"[time] attention S={s} Dc={dc} Dr={dr} Dv={dv}: kernel "
            f"{ms:.4f} ms ({ms_a:.4f}, {ms_b:.4f}), plain {plain:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / ms:.1%} of bound")
        plain_a = cuda_ms(torch, lambda: ka.fused_rope_attention_bwd_plain(
            g, *args, **kw), 2, warmup=1)
        ms_a = cuda_ms(torch, lambda: ka.fused_rope_attention_bwd(
            g, *args, **kw), 5, warmup=1)
        ms_b = cuda_ms(torch, lambda: ka.fused_rope_attention_bwd(
            g, *args, **kw), 5, warmup=0)
        plain_b = cuda_ms(torch, lambda: ka.fused_rope_attention_bwd_plain(
            g, *args, **kw), 2, warmup=0)
        ms, plain = min(ms_a, ms_b), min(plain_a, plain_b)
        t_bytes, t_ops = attn_bwd_bound(TIME_BATCH, s, dc, dr, dv, 2)
        row = dict(S=s, Dc=dc, Dr=dr, Dv=dv, launches=launches, ms=ms,
                   plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   ms_reads=[ms_a, ms_b], plain_ms_reads=[plain_a, plain_b],
                   **extra, **per_bwd[(s, dc, dr, dv)])
        bwd_rows.append(row)
        log(f"[time] attention backward S={s} Dc={dc} Dr={dr} Dv={dv}: "
            f"kernel {ms:.4f} ms ({ms_a:.4f}, {ms_b:.4f}), plain "
            f"{plain:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {row['bound_ms'] / ms:.1%} of bound")
        del args, g
    for name_, rows_ in (("forward", attn_rows), ("backward", bwd_rows)):
        k_sum = sum(r["launches"] * r["ms"] for r in rows_)
        p_sum = sum(r["launches"] * r["plain_ms"] for r in rows_)
        b_sum = sum(r["launches"] * r["bound_ms"] for r in rows_)
        log(f"[time] rope attention {name_}, flagship sum over one "
            f"{'forward' if name_ == 'forward' else 'step'}: kernel "
            f"{k_sum:.3f} ms, plain {p_sum:.3f} ms, bound {b_sum:.4f} ms "
            f"({b_sum / k_sum:.1%} of bound); on {name} ({smi})")
        if not k_sum < p_sum:
            log(f"[time] NOTE: the rope attention {name_} kernel is slower "
                f"than its plain version in this call")
    # The fp32 route (CUDA cores) at B = 8, where the card-vs-CPU and DP/TP
    # paths run it: each flagship shape's forward and backward against the
    # plain version (plain, kernel, kernel, plain) beside the fp32 bound
    # (fp32 at PEAK_FP32_FLOPS).
    f32_time = {"forward": [], "backward": []}
    for i, (s, dc, dr, dv) in enumerate(sorted(attn_shapes, reverse=True)):
        args = attn_inputs(torch, CHECK_BATCH, s, dc, dr, dv, dev, f32,
                           seed=1000 + i)
        g = grad_like(torch, CHECK_BATCH, s, dv, dev, f32, seed=1050 + i)
        kw = dict(scale=1.0 / (dc + dr) ** 0.5, dtype=f32)
        for name_, kern, plain_fn, bound_fn in (
                ("forward", lambda: ka.fused_rope_attention(*args, **kw),
                 lambda: ka.fused_rope_attention_plain(*args, **kw),
                 attn_bound),
                ("backward", lambda: ka.fused_rope_attention_bwd(g, *args,
                                                                 **kw),
                 lambda: ka.fused_rope_attention_bwd_plain(g, *args, **kw),
                 attn_bwd_bound)):
            plain_a = cuda_ms(torch, plain_fn, 5, warmup=1)
            ms_a = cuda_ms(torch, kern, 10)
            ms_b = cuda_ms(torch, kern, 10)
            plain_b = cuda_ms(torch, plain_fn, 5, warmup=0)
            t_bytes, t_ops = bound_fn(CHECK_BATCH, s, dc, dr, dv, 4,
                                      PEAK_FP32_FLOPS)
            row = dict(S=s, Dc=dc, Dr=dr, Dv=dv,
                       launches=attn_shapes[(s, dc, dr, dv)],
                       ms=min(ms_a, ms_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations",
                       ms_reads=[ms_a, ms_b],
                       plain_ms_reads=[plain_a, plain_b])
            f32_time[name_].append(row)
            log(f"[time] fp32 rope {name_} B={CHECK_BATCH} S={s} Dc={dc} "
                f"Dr={dr} Dv={dv}: kernel {row['ms']:.4f} ms ({ms_a:.4f}, "
                f"{ms_b:.4f}), plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / row['ms']:.1%} of bound")
        del args, g
    f32_sums = {}
    for name_, rows_ in f32_time.items():
        f32_sums[name_] = {
            "batch": CHECK_BATCH, "dtype": "float32",
            "sources": list(ka.F32_SOURCES),
            "ms": sum(r["launches"] * r["ms"] for r in rows_),
            "plain_ms": sum(r["launches"] * r["plain_ms"] for r in rows_),
            "bound_ms": sum(r["launches"] * r["bound_ms"] for r in rows_),
            "per_shape": rows_}
        x = f32_sums[name_]
        log(f"[time] fp32 rope attention {name_} B={CHECK_BATCH}, flagship "
            f"sum over one {'forward' if name_ == 'forward' else 'step'}: "
            f"kernel {x['ms']:.3f} ms, plain {x['plain_ms']:.3f} ms, bound "
            f"{x['bound_ms']:.4f} ms ({x['bound_ms'] / x['ms']:.2%} of "
            f"bound); on {name} ({smi})")
    for s in sorted(conv_sizes, reverse=True):
        args = conv_inputs(torch, TIME_BATCH, s, dev, bf16, seed=300 + s)
        ms = cuda_ms(torch, lambda: kc.fused_conv_residual(*args,
                                                           dtype=bf16), 10)
        plain = cuda_ms(torch, lambda: kc.fused_conv_residual_plain(
            *args, dtype=bf16), 3, warmup=1)
        t_bytes, t_ops = conv_bound(TIME_BATCH, s, 2)
        floor = conv_floor_ms("fwd", TIME_BATCH, s)
        conv_floor += conv_sizes[s] * floor
        row = dict(S=s, launches=conv_sizes[s], ms=ms, plain_ms=plain,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   **per_conv[s])
        conv_rows.append(row)
        log(f"[time] conv S={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / ms:.1%} of bound; CUDA-core floor "
            f"{floor:.4f} ms, {floor / ms:.1%} of it")
        del args
    log(f"[time] conv forward, flagship sum over one forward: kernel "
        f"{sum(r['launches'] * r['ms'] for r in conv_rows):.3f} ms, plain "
        f"{sum(r['launches'] * r['plain_ms'] for r in conv_rows):.3f} ms, "
        f"bound {sum(r['launches'] * r['bound_ms'] for r in conv_rows):.4f} "
        f"ms, CUDA-core floor {conv_floor:.4f} ms; on {name} ({smi})")
    # The fp32 conv kernels at B = 8, where the card-vs-CPU checks and the
    # fp32 eval forwards run them: at every flagship conv S the forward,
    # the forward with residuals and the backward against their plain
    # versions (plain, kernel, kernel, plain). The kernels are timed as
    # CUDA-graph replays (tools/time_conv.py's graph_ms: at B=8 a launch's
    # host work lasts about as long as its kernel), the plain versions with
    # events. Each S's row and the sums per forward or per step (the
    # stages of one flagship forward) go to the kernels line with the fp32
    # bound; the CUDA-core floor (tools/time_conv.py's LANE_OPS_F32) is
    # logged beside them.
    f32_conv = {"fwd": [], "fwd_resid": [], "bwd": []}
    for s in sorted(conv_sizes, reverse=True):
        args = conv_inputs(torch, CHECK_BATCH, s, dev, f32, seed=1300 + s)
        g = torch.from_numpy((np.random.default_rng(1300 + s).standard_normal(
            (CHECK_BATCH, s, s, 3)) * 0.5).astype(np.float32)).to(dev)
        w = args[1:6]
        for key, kern, plain_fn, bound_fn in (
                ("fwd", lambda: kc.fused_conv_residual(*args, dtype=f32),
                 lambda: kc.fused_conv_residual_plain(*args, dtype=f32),
                 conv_bound),
                ("fwd_resid",
                 lambda: kc.conv_residual_fwd_resid(*args, dtype=f32),
                 lambda: kc.conv_residual_fwd_resid_plain(*args, dtype=f32),
                 conv_resid_bound),
                ("bwd", lambda: kc.conv_residual_bwd(args[0], g, *w,
                                                     dtype=f32),
                 lambda: kc.conv_residual_bwd_plain(args[0], g, *w,
                                                    dtype=f32),
                 conv_bwd_bound)):
            plain_a = cuda_ms(torch, plain_fn, 3, warmup=1)
            ms_a = tconv.graph_ms(kern, 5)
            ms_b = tconv.graph_ms(kern, 5)
            plain_b = cuda_ms(torch, plain_fn, 3, warmup=0)
            t_bytes, t_ops = bound_fn(CHECK_BATCH, s, 4, PEAK_FP32_FLOPS)
            row = dict(S=s, ms=min(ms_a, ms_b),
                       plain_ms=min(plain_a, plain_b),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations",
                       ms_reads=[ms_a, ms_b],
                       plain_ms_reads=[plain_a, plain_b])
            f32_conv[key].append(row)
            floor = conv_floor_ms(key, CHECK_BATCH, s, fp32=True)
            log(f"[time] fp32 conv {key} B={CHECK_BATCH} S={s}: kernel "
                f"{row['ms']:.4f} ms ({ms_a:.4f}, {ms_b:.4f}; graph "
                f"replays), plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / row['ms']:.1%} of bound; CUDA-core "
                f"floor {floor:.4f} ms, {floor / row['ms']:.1%} of it")
        del args, g, w
    f32_conv_sums = {}
    for key, rows_ in f32_conv.items():
        x = f32_conv_sums[key] = {
            "batch": CHECK_BATCH, "dtype": "float32",
            **{k: sum(conv_sizes[r["S"]] * r[k] for r in rows_)
               for k in ("ms", "plain_ms", "bound_ms")},
            "per_shape": rows_}
        floor = sum(conv_sizes[r["S"]] * conv_floor_ms(key, CHECK_BATCH,
                                                       r["S"], fp32=True)
                    for r in rows_)
        log(f"[time] fp32 conv {key} B={CHECK_BATCH}, flagship sum over one "
            f"{'forward' if key == 'fwd' else 'step'} "
            f"({sum(conv_sizes.values())} stages): kernel {x['ms']:.4f} ms, "
            f"plain {x['plain_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms "
            f"({x['bound_ms'] / x['ms']:.2%} of bound), CUDA-core floor "
            f"{floor:.4f} ms ({floor / x['ms']:.2%}); on {name} ({smi})")

    pred.classify(images)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.classify(images)   # returns numpy: the device has finished
    elapsed = time.perf_counter() - t0
    img_s = reps * TIME_BATCH / elapsed
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] classify B={TIME_BATCH} bf16: {img_s:.2f} images/s "
        f"({elapsed / reps * 1e3:.2f} ms per call), peak memory "
        f"{peak_gib:.3f} GiB, on {name} ({smi})")

    # 7. trace one classify forward: device time by kernel name, busy share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    attn_cls_ms = sum(e.self_device_time_total for e in events
                      if "rope_attention_fwd" in e.key
                      or "rope_prep_kernel" in e.key) / 1e3
    classify_trace = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "attention_ms": attn_cls_ms}
    log(f"[trace] one classify forward B={TIME_BATCH} bf16 under the "
        f"profiler: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"kernels; rope attention (kernel and prologue) {attn_cls_ms:.2f} ms"
        f", {attn_cls_ms / busy_ms:.1%} of device busy time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[trace] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")

    # ... and one training step: the attention kernels' share of the step.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, train_batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def device_ms(*needles):
        return sum(e.self_device_time_total for e in events
                   if any(n in e.key for n in needles)) / 1e3

    fwd_ms = device_ms("rope_attention_fwd")
    bwd_ms = device_ms("bwd_rows_kernel", "bwd_keys_kernel",
                       "xty_mma_kernel", "reduce_leading_kernel")
    prep_ms = device_ms("rope_prep_kernel")   # both directions' prologue
    train_trace = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                   "attention_fwd_ms": fwd_ms, "attention_bwd_ms": bwd_ms,
                   "attention_prologue_ms": prep_ms,
                   "attention_share_of_busy":
                       (fwd_ms + bwd_ms + prep_ms) / busy_ms}
    log(f"[trace] one training step B={TIME_BATCH} bf16 under the profiler: "
        f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"kernels; attention forward kernels {fwd_ms:.2f} ms, backward "
        f"kernels {bwd_ms:.2f} ms (rows {device_ms('bwd_rows_kernel'):.2f}"
        f", keys {device_ms('bwd_keys_kernel'):.2f}, weight grads "
        f"{device_ms('xty_mma_kernel'):.2f}, reductions "
        f"{device_ms('reduce_leading_kernel'):.2f}), prologues "
        f"{prep_ms:.2f} ms: {(fwd_ms + bwd_ms + prep_ms) / busy_ms:.1%} of "
        "device busy time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[trace] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")

    # 8. hires-cls-1024, after the flagship's trainer and predictor are gone.
    del state, train_step, model, tx, pred
    torch.cuda.empty_cache()
    hires_kernels, hires = hires_phases(torch, name, smi)

    # 9. the trainer entry point, with the fused conv residual in training;
    # 10. the relayout kernel, the canaries, and serving and evaluating
    # phase 9's checkpoint, in bf16 and int8.
    import shutil
    import tempfile

    keep_ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        trainer_kernels, trainer = trainer_phase(
            torch, name, smi, {"ms_per_step": steady_ms,
                               "images_per_s": train_img_s}, keep_ckpt)
        relayout_kernel, serve_launches, serving = serving_phase(
            torch, name, smi, keep_ckpt)
    finally:
        shutil.rmtree(keep_ckpt, ignore_errors=True)

    # 11. the generated corpus and the native decoder, Encoder8 and
    # CALMLatentDiffusion, and a short training proof.
    torch.cuda.empty_cache()
    proof_launches, proof = proof_phase(torch, name, smi)

    # 12. the JAX package's seed-0 imagenet-reg-224 weights: rebuilt,
    # reconstructed, trained through train_reg.main, saved and served.
    torch.cuda.empty_cache()
    jaxinit_launches, jaxinit = jax_weights_phase(torch, name, smi)

    # 13. data and tensor parallelism: torchrun at world 1, and two ranks
    # over gloo sharing the card.
    torch.cuda.empty_cache()
    parallel_launches, parallel = parallel_phase(torch, name, smi)

    # 14. the ported scripts (tools/), each at a reduced size.
    torch.cuda.empty_cache()
    tools_launches, tools = tools_phase(torch, name, smi)

    # 15. the chunked and xla attention routes: each kernel's limit, the two
    # routes against each other, hires-cls-1024 at heads=6.
    torch.cuda.empty_cache()
    routes_launches, routes, routes_kernels = routes_phase(torch, name, smi)

    def summary(kname, source, replaces, rows, launches):
        t_bytes = sum(r["launches"] * r["bound_ms"] for r in rows
                      if r["bound_by"] == "bytes")
        t_ops = sum(r["launches"] * r["bound_ms"] for r in rows
                    if r["bound_by"] == "operations")
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["fp32_err"] for r in rows),
            "ms": sum(r["launches"] * r["ms"] for r in rows),
            "plain_ms": sum(r["launches"] * r["plain_ms"] for r in rows),
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "per_shape": rows,
        }

    kernels = [
        summary("fused_rope_attention_fwd", ka.SOURCE, ka.REPLACES,
                attn_rows, main_launches["attention"]
                + train_launches["attention_fwd"]
                + eval_launches["attention_fwd"]),
        summary("fused_rope_attention_bwd", ka.BWD_SOURCE, ka.BWD_REPLACES,
                bwd_rows, train_launches["attention_bwd"]),
        summary("fused_conv_residual_fwd", kc.SOURCE, kc.REPLACES,
                conv_rows, main_launches["conv"] + eval_launches["conv"]),
    ]
    kernels[0]["launches_by_path"] = {
        "classify": main_launches["attention"],
        f"train_{TRAIN_STEPS}_steps": train_launches["attention_fwd"],
        "eval_step": eval_launches["attention_fwd"]}
    kernels[0]["no_rope_case_replaces"] = \
        "calm_vit_dte_tpu/kernels/axial_attention.py:530"
    kernels[1]["launches_by_path"] = {
        f"train_{TRAIN_STEPS}_steps": train_launches["attention_bwd"]}
    kernels[1]["no_rope_case_replaces"] = ka.BWD_REPLACES_NO_ROPE
    # The fp32 route: its times at B = 8 (per flagship forward, per step's
    # backward) and its phase 3 errors by shape.
    kernels[0]["fp32_b8"] = f32_sums["forward"]
    kernels[1]["fp32_b8"] = f32_sums["backward"]
    for k in kernels[:2]:
        k["fp32_checks"] = [dict(zip(("S", "Dc", "Dr", "Dv"), shape), **e)
                            for shape, e in per_f32.items()]
    # The launches each call makes beside its kernel, per main path, read
    # after that path with the counters set to 0 before it: the forward's
    # prologue; the backward's prologue, keys kernel, table and weight-grad
    # reductions.
    stage_by_path["serve_evaluate_int8_phase10"] = \
        serve_launches["attention_prologues"]
    kernels[0]["stage_launches_by_path"] = stage_by_path
    kernels[1]["stage_launches_by_path"] = {
        f"train_{TRAIN_STEPS}_steps": train_stages["attention_bwd"]}
    kernels[2]["launches_by_path"] = {
        "classify": main_launches["conv"],
        f"train_{TRAIN_STEPS}_steps": train_launches["conv"],
        "eval_step": eval_launches["conv"]}
    kernels[2]["launches_by_path"][
        f"trainer_{TRAINER_STEPS}_steps_pallas_route"] = \
        trainer["conv_fwd_launches_pallas_route"]
    kernels[2]["launches"] += trainer["conv_fwd_launches_pallas_route"]
    hires_conv = hires.pop("conv_fwd")
    kernels[2]["per_shape"] += hires_conv["rows"]
    kernels[2]["hires_per_forward"] = hires_conv["per_forward"]
    kernels[2]["launches_by_path"].update(hires_conv["launches"])
    kernels[2]["launches"] += sum(hires_conv["launches"].values())
    for k, key in ((kernels[0], "attention"), (kernels[2], "conv")):
        k["launches_by_path"]["serve_evaluate_int8_phase10"] = \
            serve_launches[key]
        k["launches"] += serve_launches[key]
    for path, got in {**f32_paths, **proof_launches, **jaxinit_launches,
                      **parallel_launches}.items():
        for k, key in ((kernels[0], "attention_fwd"),
                       (kernels[1], "attention_bwd"), (kernels[2], "conv")):
            if got.get(key):
                k["launches_by_path"][path] = got[key]
                k["launches"] += got[key]
        for k, key in ((kernels[0], "attention_fwd"),
                       (kernels[1], "attention_bwd")):
            if got["stages"][key]:
                k["stage_launches_by_path"][path] = got["stages"][key]
    kernels += (hires_kernels + routes_kernels + trainer_kernels
                + [relayout_kernel])
    by_name = {k["name"]: k for k in kernels}
    # The fp32 conv kernels' times at B = 8 (per flagship forward, or per
    # step for the forward with residuals and the backward).
    for kname, key in (("fused_conv_residual_fwd", "fwd"),
                       ("conv_residual_fwd_resid", "fwd_resid"),
                       ("conv_residual_bwd", "bwd")):
        by_name[kname]["fp32_b8"] = f32_conv_sums[key]
    for path, got in {**tools_launches, **routes_launches}.items():
        for wrapper, n in got["launches"].items():
            k = by_name.get(TOOLS_KERNEL_NAMES.get(wrapper))
            if k is not None and n:
                k["launches_by_path"][path] = n
                k["launches"] += n
        for wrapper, n in got["stages"].items():
            k = by_name[TOOLS_KERNEL_NAMES[wrapper]]
            k.setdefault("stage_launches_by_path", {})[path] = n
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main "
                                 "path")
    log("[time] kernels' ms, plain_ms and bound_ms are per flagship "
        f"forward (or per training step's backward) at B={TIME_BATCH} bf16: "
        "each shape's time x its launches per forward; launches counts the "
        "main-path runs (launches_by_path); max_abs_err is the fp32 "
        "kernel-vs-plain error at B=8; per_shape rows with launches 0 (Dr = "
        "0) are off the flagship's path and in no sum")
    log(f"[done] {time.time() - t_start:.1f} s")
    log(json.dumps({"classify": {"batch": TIME_BATCH, "dtype": "bfloat16",
                                 "images_per_s": img_s,
                                 "peak_mem_gib": peak_gib,
                                 "trace": classify_trace},
                    "classify_imagenet_cls_256": {
                        "batch": TIME_BATCH, "dtype": "bfloat16",
                        "images_per_s": cls256_img_s},
                    "train": {"batch": TIME_BATCH, "dtype": "bfloat16",
                              "remat": cfg.remat, "microbatches": 1,
                              "ms_per_step": steady_ms,
                              "first_step_ms": step_ms[0],
                              "images_per_s": train_img_s,
                              "peak_mem_gib": train_peak_gib,
                              "losses": train_losses, "trace": train_trace},
                    "hires-cls-1024": hires, "trainer": trainer,
                    "serving": serving, "native_probe": native_state,
                    "proof": proof, "jax_weights": jaxinit,
                    "parallel": parallel, "tools": tools,
                    "routes": routes}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
