#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (calm_vit_dte_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (any exception exits non-zero):
  1. probe   card name and count, `nvidia-smi` name/power limit, nvcc,
             whether triton imports;
  2. build   both CUDA kernels with nvcc for sm_90a, in parallel, printing
             the ptxas register/shared-memory/spill lines;
  3. check   every kernel against its plain PyTorch version at every shape
             the flagship forward gives it (B=8): fp32 at rtol 2e-4 /
             atol 2e-5 (the per-layer eval limit of
             tests/test_parity_torch.py), and in bf16 the kernel's max-abs
             error against the fp32 plain version must be at most twice the
             plain bf16 version's;
  4. serve   the flagship through the user's entry points:
             Predictor.fresh("imagenet-cls-224").classify on 128 uint8
             256x256 images in bf16, with exactly 24 attention and 8 conv
             kernel launches; the same weights in fp32 on the card and on
             the CPU (plain versions) for 2 images, logits at rtol 2e-3 /
             atol 2e-4 and KL at rtol 1e-3 (tests/test_parity_full224.py's
             limits); one imagenet-reg-224 reconstruct (24 + 9 launches,
             outputs in [0, 1]);
  5. time    each kernel and its plain version at every flagship shape at
             B=128 bf16 with CUDA events, beside its roofline bound, and
             classify images/s and peak memory at B=128 bf16;
  6. trace   one classify forward under torch.profiler: device busy share
             and the device kernels that take the most time.

Every fp32 comparison runs with torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False, so the plain versions' products
and convolutions are true fp32.

Output: human-readable lines, then the card's `nvidia-smi` name and power
limit, then one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. No single PyTorch call computes either fused
function, so each kernel's library_ms is null.
"""

from __future__ import annotations

import copy
import json
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
    qr, kr = n(b, H, s, dr, scale=0.3), n(b, H, s, dr, scale=0.3)
    v = n(b, H, s, dv, scale=0.3)
    inv = RoPE(dr).inv_freq.detach().to(device)
    cq, sq = rope_tables(inv, s)
    ck, sk = rope_tables(inv * 1.1, s)
    f32 = torch.float32
    return (qc, qr, kc, kr, v, cq, sq, ck, sk,
            n(2 * s, s, scale=0.05, dt=f32), n(2 * s, scale=0.05, dt=f32),
            n(s, 2 * s, scale=0.05, dt=f32), n(s, scale=0.05, dt=f32))


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


def conv_bound(b, s, itemsize):
    nbytes = 2 * b * s * s * 3 * itemsize + (96 + 32 + 288 + 32 + 96 + 3) * 4
    flops = 2 * b * s * s * 32 * 15
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


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
    from calm_vit_dte_tpu_torch.serve import Predictor
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

    # 2. build
    t0 = time.time()
    logs = _build.build(["axial_attention", "conv_residual"])
    log(f"[build] both kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log(f"[build] {src}: {line.strip()[:160]}")

    # 3. kernel vs plain at every flagship shape
    cfg = get_config("imagenet-cls-224")
    attn_shapes, conv_sizes = flagship_shapes(cfg.model)
    log(f"[check] attention shapes (S, Dc, Dr, Dv): launches = "
        f"{attn_shapes}; conv S: launches = {conv_sizes}")
    per_attn: dict[tuple, dict] = {}
    for i, (s, dc, dr, dv) in enumerate(sorted(attn_shapes, reverse=True)):
        args = attn_inputs(torch, CHECK_BATCH, s, dc, dr, dv, dev, f32,
                           seed=i)
        kw = dict(scale=1.0 / (dc + dr) ** 0.5)
        out = ka.fused_rope_attention(*args, dtype=f32, **kw)
        ref = ka.fused_rope_attention_plain(*args, dtype=f32, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
        a16 = cast(torch, args, bf16)
        p16 = ka.fused_rope_attention_plain(*a16, dtype=bf16, **kw)
        ref16 = ka.fused_rope_attention_plain(*cast(torch, a16, f32),
                                              dtype=f32, **kw)
        e_p = max_err(p16, ref16)
        errs = {}
        for tc in (False, True):   # both bf16 kernels, whichever serves
            k16 = ka._launch(*a16, dtype=bf16, use_mask=True,
                             tensor_cores=tc, **kw)
            errs[tc] = max_err(k16, ref16)
            if not errs[tc] <= 2 * e_p:
                raise AssertionError(
                    f"attention S={s} Dc={dc} tensor_cores={tc}: bf16 "
                    f"kernel error {errs[tc]} > 2 x plain bf16 {e_p}")
        e_k = errs[ka.uses_tensor_cores(bf16, s, dc + dr)]
        per_attn[(s, dc, dr, dv)] = {"fp32_err": max_err(out, ref),
                                     "bf16_err": e_k, "plain_bf16_err": e_p}
        log(f"[check] attention S={s} Dc={dc} Dr={dr} Dv={dv}: fp32 max "
            f"err {max_err(out, ref):.3e}; bf16 err CUDA-core kernel "
            f"{errs[False]:.3e}, tensor-core kernel {errs[True]:.3e}, plain "
            f"{e_p:.3e}")
    per_conv: dict[int, dict] = {}
    for i, s in enumerate(sorted(conv_sizes, reverse=True)):
        args = conv_inputs(torch, CHECK_BATCH, s, dev, f32, seed=100 + i)
        out = kc.fused_conv_residual(*args, dtype=f32)
        ref = kc.fused_conv_residual_plain(*args, dtype=f32)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
        a16 = (args[0].to(bf16),) + args[1:]
        k16 = kc.fused_conv_residual(*a16, dtype=bf16)
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
            f"bf16 err kernel {e_k:.3e} vs plain {e_p:.3e}")

    # 4. the main path through the user's entry points
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TIME_BATCH, cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    pred = Predictor.fresh("imagenet-cls-224", seed=0, device="cuda")
    ka.fused_rope_attention.launches = 0
    kc.fused_conv_residual.launches = 0
    labels, probs = pred.classify(images)
    main_launches = {"attention": ka.fused_rope_attention.launches,
                     "conv": kc.fused_conv_residual.launches}
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

    # 5. timing at B=128 bf16
    attn_rows, conv_rows = [], []
    for i, (s, dc, dr, dv) in enumerate(sorted(attn_shapes, reverse=True)):
        args = attn_inputs(torch, TIME_BATCH, s, dc, dr, dv, dev, bf16,
                           seed=200 + i)
        kw = dict(scale=1.0 / (dc + dr) ** 0.5, dtype=bf16)
        plain = cuda_ms(torch,
                        lambda: ka.fused_rope_attention_plain(*args, **kw),
                        3, warmup=1)
        by_path = {tc: cuda_ms(torch, lambda: ka._launch(
            *args, use_mask=True, tensor_cores=tc, **kw), 10)
            for tc in (False, True)}
        served = ka.uses_tensor_cores(bf16, s, dc + dr)
        ms = by_path[served]
        t_bytes, t_ops = attn_bound(TIME_BATCH, s, dc, dr, dv, 2)
        row = dict(S=s, Dc=dc, Dr=dr, Dv=dv,
                   launches=attn_shapes[(s, dc, dr, dv)], ms=ms,
                   plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   tensor_cores=served, cuda_core_ms=by_path[False],
                   tensor_core_ms=by_path[True],
                   **per_attn[(s, dc, dr, dv)])
        attn_rows.append(row)
        log(f"[time] attention S={s} Dc={dc} Dr={dr} Dv={dv}: kernel "
            f"{ms:.4f} ms ({'tensor' if served else 'CUDA'} cores; CUDA-core"
            f" {by_path[False]:.4f}, tensor-core {by_path[True]:.4f}), plain "
            f"{plain:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {row['bound_ms'] / ms:.1%} of bound")
        del args
    for s in sorted(conv_sizes, reverse=True):
        args = conv_inputs(torch, TIME_BATCH, s, dev, bf16, seed=300 + s)
        ms = cuda_ms(torch, lambda: kc.fused_conv_residual(*args,
                                                           dtype=bf16), 10)
        plain = cuda_ms(torch, lambda: kc.fused_conv_residual_plain(
            *args, dtype=bf16), 3, warmup=1)
        t_bytes, t_ops = conv_bound(TIME_BATCH, s, 2)
        row = dict(S=s, launches=conv_sizes[s], ms=ms, plain_ms=plain,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   **per_conv[s])
        conv_rows.append(row)
        log(f"[time] conv S={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / ms:.1%} of bound")
        del args

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

    # 6. trace one classify forward: device time by kernel name, busy share
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
    log(f"[trace] one classify forward B={TIME_BATCH} bf16 under the "
        f"profiler: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[trace] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")

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
                attn_rows, main_launches["attention"]),
        summary("fused_conv_residual_fwd", kc.SOURCE, kc.REPLACES,
                conv_rows, main_launches["conv"]),
    ]
    log("[time] kernels' ms, plain_ms and bound_ms are per flagship "
        f"forward at B={TIME_BATCH} bf16 (each shape's time x its launches)"
        "; max_abs_err is the fp32 kernel-vs-plain error at B=8")
    log(f"[done] {time.time() - t_start:.1f} s")
    log(json.dumps({"classify": {"batch": TIME_BATCH, "dtype": "bfloat16",
                                 "images_per_s": img_s,
                                 "peak_mem_gib": peak_gib}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
