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
             from ptxas (the full log stays in build/torch_kernels/); a
             spill in a hires tensor-core kernel fails the run; every conv
             kernel instantiation's registers, spills, shared memory a CTA
             and CTAs per SM as the CUDA runtime reports them (the bf16
             ones must keep the CTAs an SM their launch bounds ask for,
             with no spill);
  3. check   the rope kernels' shared-memory helpers against the sizes the
             C launches use, at every shape below, mask on and off; the
             bf16 conv kernels' grids, threads, shared memory and partial
             rows against the wrapper's helpers at every conv S, and their
             erf within its stated bound of erff over [-10, 10]; then
             every kernel against its plain PyTorch version at every shape
             the flagship and imagenet-cls-256 give it (B=8; the rope
             attention kernels' bf16 route on the tensor cores, with the
             mask on and off). Forward kernels: fp32 at rtol 2e-4
             / atol 2e-5 (the per-layer eval limit of
             tests/test_parity_torch.py), and in bf16 the kernel's max-abs
             error against the fp32 plain version must be at most twice the
             plain bf16 version's (the conv forward's two bf16 launches
             bit-identical); the attention forward also with no rope
             half (Dr = 0), with and without the mask. Attention backward:
             all 13 gradients, fp32 within 1e-4 of each gradient's largest
             value (tighter than the 5e-3 of bench.py's kernel-vs-oracle
             check; nothing in the kernel is atomic), bf16 by the same
             twice-the-plain rule, at every flagship shape and at Dr = 0,
             with and without the mask, the bf16 route bit-identical across
             two launches; and the autograd Function against torch autograd
             of the plain forward;
  4. serve   the flagship through the user's entry points:
             Predictor.fresh("imagenet-cls-224").classify on 128 uint8
             256x256 images in bf16, with exactly 24 attention and 8 conv
             kernel launches; the same weights in fp32 on the card and on
             the CPU (plain versions) for 2 images, logits at rtol 2e-3 /
             atol 2e-4 and KL at rtol 1e-3 (tests/test_parity_full224.py's
             limits); one imagenet-reg-224 reconstruct (24 + 9 launches,
             outputs in [0, 1]); Predictor.fresh("imagenet-cls-256")
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
             tests/test_parity_grad.py); one bf16 imagenet-cls-256 step
             at B=128 (finite loss and gradients, 24 + 24 launches);
  6. time    each kernel and its plain version at every flagship shape
             (the rope attention kernels also at imagenet-cls-256's) at
             B=128 bf16 with CUDA events, plain, kernel, kernel, plain,
             beside its roofline bound (the conv forward also beside its
             CUDA-core floor), and the per-forward and per-step
             sums of the rope attention kernels against their plain
             versions';
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
             error, two bf16 launches of each kernel bit-identical, the
             ablation's FULL bit-identical to the production backward; the
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
             2e-4 (and CALMLatentDiffusion's KL at rtol 1e-3); (c) 100
             overfit steps through tools/train_proof on the flagship (128
             memorize images, B=128, bf16, remat off, evals at 50 and
             100): every loss finite, the last 10 steps' mean below the
             first 10's, exactly 24 + 24 rope launches a step and 24 + 8
             per eval forward, decoded by the native decoder.

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
forward, six per flagship backward); so do the hires kernels' (their
strided products and sums), whose per-shape rows also carry the parts'
device times, the parts' library times and the shared memory per CTA.
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
H = 12
CHECK_BATCH = 8
TIME_BATCH = 128


def log(*args) -> None:
    print(*args, flush=True)


# The card's SM count and SM clock (phase 1), for the conv kernels' CUDA-core
# floor (tools/time_conv.py: LANE_OPS x pixels / (SMs x 128 x clock)).
CARD: dict = {}


def conv_floor_ms(kind, b, s):
    from calm_vit_dte_tpu_torch.tools import time_conv as tconv

    return tconv.floor_ms(kind, b, s, CARD["sms"], CARD["clock_hz"])


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


def grad_like(torch, b, s, dv, device, dtype, seed):
    """An output gradient (B, H, S, Dv) for the attention backward."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((b, H, s, dv)) * 0.3).astype(np.float32)).to(
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


def attn_bound(b, s, dc, dr, dv, itemsize):
    d = dc + dr
    nbytes = (b * H * s * (2 * d + 2 * dv) * itemsize   # q, k, v, out
              + 4 * s * dr * 4                           # cos/sin tables
              + (2 * s * 2 * s + 3 * s) * 4)             # mask weights
    flops = 2 * b * H * s * s * (d + dv) + 4 * b * s * s * 2 * s
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def attn_bwd_bound(b, s, dc, dr, dv, itemsize):
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
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def conv_bound(b, s, itemsize):
    nbytes = 2 * b * s * s * 3 * itemsize + (96 + 32 + 288 + 32 + 96 + 3) * 4
    flops = 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


# The tensor-core kernels whose registers and spills phase 2 prints.
TENSOR_CORE_KERNELS = ("rope_attention_fwd_bf16_kernel", "bwd_rows_kernel",
                       "bwd_keys_kernel", "xty_mma_kernel",
                       "hires_attention_bf16_kernel",
                       "hires_dm_ssum_bf16_kernel", "hires_dq_bf16_kernel",
                       "hires_dkv_bf16_kernel", "gemm_tc_kernel")
# The hires tensor-core kernels, whose ptxas reports must show no spills.
NO_SPILL_KERNELS = ("hires_attention_bf16_kernel",
                    "hires_dm_ssum_bf16_kernel", "hires_dq_bf16_kernel",
                    "hires_dkv_bf16_kernel", "gemm_tc_kernel")


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
            known = [k for k in TENSOR_CORE_KERNELS if k in name]
            targs = re.search(r"I((?:L[ib]\d+E)+)E", name)
            short = (known[0] if known else name) + (
                "<" + ", ".join(re.findall(r"L[ib](\d+)E", targs.group(1)))
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


def hires_inputs(torch, b, s, d, dv, device, dtype, seed, zero_mask=False):
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
    return [n(b, H, s, d, scale=0.3, dt=dtype), n(b, H, s, d, scale=0.3,
                                                  dt=dtype),
            n(b, H, s, dv, scale=0.3, dt=dtype), *w]


def hires_bounds(b, s, d, dv, itemsize):
    """(bytes ms, operations ms) of the four hires kernels at one shape:
    each input read once, each output written once; the operations of the
    products each kernel forms (the mask MLP included)."""
    mlp = 4 * b * s ** 3                       # one (B*S, S) x (S, 2S) product
    qkvo = b * H * s * (2 * d + 2 * dv) * itemsize
    weights = (2 * s * 2 * s + 3 * s) * 4
    sq = b * s * s * 4                          # an fp32 (B, S, S) residual
    vec = b * H * s * 4                         # lse or delta
    work = {
        "fwd_only": (qkvo + weights,
                     2 * b * H * s * s * (d + dv) + 2 * mlp),
        "fwd_res": (qkvo + weights + sq + vec,
                    2 * b * H * s * s * (d + dv) + 2 * mlp),
        "dq": (qkvo + weights + sq + 2 * vec       # q k v g; m lse delta
               + b * H * s * d * itemsize          # dq
               + sq + weights,                     # dssum; weight grads
               2 * b * H * s * s * (2 * d + dv) + 5 * mlp),
        "dkv": (qkvo + b * H * s * (d + dv) * itemsize + 2 * sq + 2 * vec,
                4 * b * H * s * s * (d + dv)),
    }
    return {k: (nb / PEAK_BYTES * 1e3, fl / PEAK_BF16_FLOPS * 1e3)
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


def check_hires_shape(torch, ka, kh, s, d, dv, seed, zero_mask=False):
    """Kernels 1-4 against their plain versions at B=HIRES_CHECK_BATCH:
    fp32 forward (o, m, lse; kernel 4 with the mask on and off) at rtol 2e-4
    / atol 2e-5, fp32 backward within BWD_FP32_LIMIT of each output's
    largest value, bf16 at most twice the plain bf16 version's error.
    Returns the worst errors."""
    f32, bf16 = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    scale = 1.0 / d ** 0.5
    args = hires_inputs(torch, HIRES_CHECK_BATCH, s, d, dv, dev, f32, seed,
                        zero_mask)
    g = grad_like(torch, HIRES_CHECK_BATCH, s, dv, dev, f32, seed + 1)
    kw32, kw16 = dict(scale=scale, dtype=f32), dict(scale=scale, dtype=bf16)
    worst = {"fwd_res": 0.0, "fwd_only": 0.0, "dq": 0.0, "dkv": 0.0,
             "bwd_norm": 0.0, "bf16_ratio": 0.0}

    def bf16_ok(what, got, plain, ref):
        e_k, e_p = norm_err(got, ref), norm_err(plain, ref)
        if not e_k <= 2 * e_p + 1e-6:
            raise AssertionError(f"hires {what} S={s} D={d}: bf16 kernel "
                                 f"error {e_k:.3e} > 2 x plain {e_p:.3e}")
        if e_p > 1e-6:   # where plain bf16 equals plain fp32, no ratio
            worst["bf16_ratio"] = max(worst["bf16_ratio"], e_k / e_p)

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
    p16 = kh.hires_fwd_res_plain(*a16, **kw16)
    r32 = kh.hires_fwd_res_plain(*a32, **kw32)
    for what, x, y, r in zip(("o", "m", "lse"), k16, p16, r32):
        bf16_ok(what, x, y, r)
    for use_mask in (True, False):
        ref = ka.attention_core(*a32, use_mask=use_mask, **kw32)
        bf16_ok("forward-only", kh.fused_attention_forward(
            *a16, use_mask=use_mask, **kw16),
            ka.attention_core(*a16, use_mask=use_mask, **kw16), ref)
    k16 = hires_bwd(kh, a16, g16, p16, scale, bf16, plain=False)
    b16 = hires_bwd(kh, a16, g16, p16, scale, bf16, plain=True)
    r32 = hires_bwd(kh, a32, g16.float(), p16, scale, f32, plain=True)
    for name, x, y, r in zip(HIRES_OUT_NAMES, k16, b16, r32):
        bf16_ok(name, x, y, r)
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
                      for k, v in w.items()}
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


def conv_resid_bound(b, s, itemsize):
    """The forward with residuals: reads x, writes y, h and acc (3 + 3 + 32
    + 32 values per pixel); the forward's operations."""
    nbytes = b * s * s * 70 * itemsize + (96 + 32 + 288 + 32 + 96 + 3) * 4
    flops = 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def conv_bwd_bound(b, s, itemsize):
    """The backward: reads x and g, writes dx (3 values per pixel each) and
    the (32, 24) fp32 weight grads; three times the forward's operations."""
    nbytes = (b * s * s * 9 * itemsize + (96 + 32 + 288 + 32 + 96) * 4
              + 32 * 24 * 4)
    flops = 3 * 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def check_conv_training_kernels(torch, kc, abl, s, seed):
    """The forward with residuals and the backward against their plain
    versions at B=CHECK_BATCH: fp32 forward outputs at rtol 2e-4 / atol
    2e-5, fp32 backward outputs within BWD_FP32_LIMIT of each one's largest
    value, bf16 at most twice the plain bf16 error against the fp32 plain
    version; two bf16 launches of each kernel, and the ablation's FULL and
    the production backward, bit-identical. Returns the worst errors."""
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

    def read_counts(path, want):
        """The path's launches against `want` (attention forward, backward,
        conv forward); the bf16 rope calls' stage launches (one prologue a
        forward, six a flagship backward); no hires or conv training
        kernel."""
        got = {"attention_fwd": ka.fused_rope_attention.launches,
               "attention_bwd": ka.fused_rope_attention_bwd.launches,
               "conv": kc.fused_conv_residual.launches}
        stages = {"attention_fwd": ka.fused_rope_attention.stage_launches,
                  "attention_bwd": ka.fused_rope_attention_bwd.stage_launches}
        others = {w.__name__: w.launches for w in (
            kh.fused_hires_attention, kh.hires_dq, kh.hires_dkv,
            kh.hires_weight_grads, kh.fused_attention_forward,
            kc.conv_residual_fwd_resid, kc.conv_residual_bwd)}
        if got != want or any(others.values()):
            raise AssertionError(f"{path}: launches {got} (want {want}), "
                                 f"other kernels {others}")
        if stages != {"attention_fwd": got["attention_fwd"],
                      "attention_bwd": 6 * got["attention_bwd"]}:
            raise AssertionError(f"{path}: stage launches {stages} for "
                                 f"{got}")
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
            with torch.no_grad():
                card = model(x[:2].to(dev), dtype=f32)
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
        f"lane-ops per pixel {tconv.LANE_OPS} (tools/time_conv.py)")

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
            if any(k in kname for k in TENSOR_CORE_KERNELS):
                log(f"[build] {src}: {kname}: {kregs} registers, spill "
                    f"{kspill} bytes")
            if kspill and any(k in kname for k in NO_SPILL_KERNELS):
                raise AssertionError(f"{src}: {kname} spills {kspill} bytes")
    # Every conv kernel instantiation as the card reports it; the bf16 ones
    # must keep the CTAs an SM their launch bounds ask for, with no spill
    # (csrc/conv_residual{,_bwd}.cu notes).
    want_ctas = {
        "conv_fwd_bf16_kernel<0>": kc.MIN_CTAS_BF16["forward"],
        "conv_fwd_bf16_kernel<1> (save)":
            kc.MIN_CTAS_BF16["forward with residuals"],
        "conv_bwd_bf16_kernel<31>": kc.MIN_CTAS_BF16["backward"]}
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
    # The bf16 conv kernels' launches against the wrapper's helpers (which
    # the CPU tests hold to the sources' notes), and their GELU's error.
    for s in sorted(set(conv_sizes) | set(conv256), reverse=True):
        want = {"forward": (*kc.fwd_bf16_grid(CHECK_BATCH, s),
                            kc.THREADS_BF16,
                            kc.fwd_bf16_smem() - kc._FWD_WEIGHTS_SMEM),
                "backward": (*kc.bwd_bf16_grid(CHECK_BATCH, s),
                             kc.THREADS_BF16, kc.bwd_bf16_smem()),
                "bwd_rows": math.prod(kc.bwd_bf16_grid(CHECK_BATCH, s))}
        got = kc.card_geometry(CHECK_BATCH, s)
        if got != want:
            raise AssertionError(f"conv geometry at S={s}: the C launches "
                                 f"{got}, the wrapper {want}")
    grid = torch.linspace(-10.0, 10.0, 2**20 + 1, device=dev)
    erf_err = max_err(kc.erf_bf16_probe(grid)[0],
                      torch.erf(grid * 0.7071067811865476))
    if not erf_err <= kc.ERF_BF16_MAX_ERR:
        raise AssertionError(f"bf16 conv erf error {erf_err:.3e} > "
                             f"{kc.ERF_BF16_MAX_ERR}")
    log(f"[check] bf16 conv kernels' grids, threads, shared memory and "
        f"partial rows equal the wrapper's helpers at every conv S; their "
        f"erf within {erf_err:.3e} of erff over [-10, 10] (bound "
        f"{kc.ERF_BF16_MAX_ERR})")
    del grid
    per_conv: dict[int, dict] = {}
    for i, s in enumerate(sorted(set(conv_sizes) | set(conv256),
                                 reverse=True)):
        args = conv_inputs(torch, CHECK_BATCH, s, dev, f32, seed=100 + i)
        out = kc.fused_conv_residual(*args, dtype=f32)
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
            "bit-identical")

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
    l_gpu, kl_gpu = p32.predict(images[:2])
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

    def stage_counts(path, launches):
        """Read the stage counters after the path `path`: one prologue per
        bf16 forward, and per flagship backward (rope half and mask) the
        prologue, the keys kernel, the table-grad reduction and the two
        weight-grad products with their reduction."""
        fwd = ka.fused_rope_attention.stage_launches
        bwd = ka.fused_rope_attention_bwd.stage_launches
        if (fwd != launches["attention_fwd"]
                or bwd != 6 * launches["attention_bwd"]):
            raise AssertionError(
                f"{path}: stage launches forward {fwd}, backward {bwd} for "
                f"{launches['attention_fwd']} forwards and "
                f"{launches['attention_bwd']} backwards")
        return fwd, bwd

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
    train_stages = stage_counts("train", train_launches)
    stage_by_path[f"train_{TRAIN_STEPS}_steps"] = train_stages[0]
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
    stage_by_path["eval_step"] = stage_counts("eval step", eval_launches)[0]
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
    # The launches each call makes beside its kernel, per main path, read
    # after that path with the counters set to 0 before it: the forward's
    # prologue; the backward's prologue, keys kernel, table and weight-grad
    # reductions.
    stage_by_path["serve_evaluate_int8_phase10"] = \
        serve_launches["attention_prologues"]
    kernels[0]["stage_launches_by_path"] = stage_by_path
    kernels[1]["stage_launches_by_path"] = {
        f"train_{TRAIN_STEPS}_steps": train_stages[1]}
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
    for path, got in proof_launches.items():
        for k, key in ((kernels[0], "attention_fwd"),
                       (kernels[1], "attention_bwd"), (kernels[2], "conv")):
            if got[key]:
                k["launches_by_path"][path] = got[key]
                k["launches"] += got[key]
        for k, key in ((kernels[0], "attention_fwd"),
                       (kernels[1], "attention_bwd")):
            if got["stages"][key]:
                k["stage_launches_by_path"][path] = got["stages"][key]
    kernels += hires_kernels + trainer_kernels + [relayout_kernel]
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
                    "proof": proof}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
