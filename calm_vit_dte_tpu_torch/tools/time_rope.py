"""Time the rope attention kernels on the card at a config's shapes.

For every attention shape (S, Dc, Dr, Dv) of one forward of each config it
times the forward (`fused_rope_attention`) and the backward
(`fused_rope_attention_bwd`) at B=128 in bf16 (or the --dtype given: fp32
runs the CUDA-core kernels) on random inputs from a seed, with CUDA events
(median of the repetitions), beside each call's bound (the larger of its
bytes over the HBM rate and its operations over the compute type's peak,
as chip_smoke.py counts them), and prints one JSON line per shape, then
one per config with the sums weighted by the launches per forward (per
training step for the backward), the card's name and its power limit.

    python -m calm_vit_dte_tpu_torch.tools.time_rope \\
        [--config imagenet-cls-224 ...] [--batch 128] [--reps 20] \\
        [--dtype bfloat16|float32]

It times the package found first on `sys.path`. To compare two versions of
the kernels on one card in one run, start it from each checkout's root in
turn (each builds its own kernels under its own `build/`), for example old,
new, new, old.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.ops.rope import RoPE, rope_tables
from calm_vit_dte_tpu_torch.utils.configs import get_config


def attention_shapes(model_cfg) -> dict[tuple, int]:
    """{(S, Dc, Dr, Dv): launches} of one forward of the model."""
    shapes: dict[tuple, int] = {}
    for _, bcfg in model_cfg.backbone_cfg().block_configs():
        for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(), bcfg.cross_cfg()):
            dc = v.head_dim_content if v.reduce else 0
            dr = v.head_dim_rope if v.reduce else v.head_dim
            key = (v.seq_len_new, dc, dr, v.head_dim)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # H100 SXM dense bf16 tensor cores
              torch.float32: 67e12}     # H100 SXM fp32 outside them


def bounds_ms(b, h, s, dc, dr, dv, dtype) -> tuple[float, float]:
    """(forward, backward) least ms: the larger of bytes over the HBM rate
    and operations over `dtype`'s peak. The forward reads q, k, v, the
    tables and the mask weights and writes o; the backward also reads g
    and writes dq in the compute type, dk, dv in fp32 and the table and
    weight grads, with three times the forward's operations."""
    d, item = dc + dr, torch.finfo(dtype).bits // 8
    small = 4 * s * dr * 4 + (2 * s * 2 * s + 3 * s) * 4
    flops = 2 * b * h * s * s * (d + dv) + 4 * b * s * s * 2 * s
    fwd = max((b * h * s * (2 * d + 2 * dv) * item + small) / PEAK_BYTES,
              flops / PEAK_FLOPS[dtype])
    bwd = max((b * h * s * (2 * d + 2 * dv) * item + b * h * s * d * item
               + b * h * s * (d + dv) * 4 + 2 * small) / PEAK_BYTES,
              3 * flops / PEAK_FLOPS[dtype])
    return fwd * 1e3, bwd * 1e3


def _inputs(b, h, s, dc, dr, dv, seed, dt=torch.bfloat16):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3, dt=dt):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device="cuda", dtype=dt)

    tables = [None] * 4
    if dr:
        inv = RoPE(dr).inv_freq.detach().cuda()
        tables = [*rope_tables(inv, s), *rope_tables(inv * 1.1, s)]
    f32 = torch.float32
    args = (n(b, h, s, dc) if dc else None, n(b, h, s, dr) if dr else None,
            n(b, h, s, dc) if dc else None, n(b, h, s, dr) if dr else None,
            n(b, h, s, dv), *tables, n(2 * s, s, scale=0.05, dt=f32),
            n(2 * s, scale=0.05, dt=f32), n(s, 2 * s, scale=0.05, dt=f32),
            n(s, scale=0.05, dt=f32))
    return args, n(b, h, s, dv)


def _median_ms(fn, reps: int) -> float:
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+", default=["imagenet-cls-224"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_rope needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dtype = getattr(torch, args.dtype)
    for name in args.config:
        mcfg = get_config(name).model
        sums = {"forward_ms": 0.0, "backward_ms": 0.0,
                "forward_bound_ms": 0.0, "backward_bound_ms": 0.0}
        for i, ((s, dc, dr, dv), launches) in enumerate(
                sorted(attention_shapes(mcfg).items(), reverse=True)):
            x, g = _inputs(args.batch, mcfg.heads, s, dc, dr, dv, seed=i,
                           dt=dtype)
            kw = dict(scale=1.0 / (dc + dr) ** 0.5, dtype=dtype)
            fb, bb = bounds_ms(args.batch, mcfg.heads, s, dc, dr, dv, dtype)
            with torch.no_grad():
                fwd = _median_ms(lambda: ka.fused_rope_attention(*x, **kw),
                                 args.reps)
                bwd = _median_ms(
                    lambda: ka.fused_rope_attention_bwd(g, *x, **kw),
                    args.reps)
            for key, x_ in (("forward_ms", fwd), ("backward_ms", bwd),
                            ("forward_bound_ms", fb),
                            ("backward_bound_ms", bb)):
                sums[key] += launches * x_
            print(json.dumps({"config": name, "shape": [s, dc, dr, dv],
                              "dtype": args.dtype, "launches": launches,
                              "forward_ms": fwd, "backward_ms": bwd,
                              "forward_bound_ms": fb,
                              "backward_bound_ms": bb}), flush=True)
            del x, g
        print(json.dumps({"config": name, "batch": args.batch,
                          "dtype": args.dtype,
                          "per_forward": sums["forward_ms"],
                          "per_step_backward": sums["backward_ms"],
                          "bound_per_forward": sums["forward_bound_ms"],
                          "bound_per_step_backward":
                              sums["backward_bound_ms"],
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
