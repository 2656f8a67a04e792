"""Time the long-sequence (hires) attention kernels on the card at
`hires-cls-1024`'s shapes, by part, beside their library yardsticks.

For every kernel shape (S, D, Dv) of one hires forward it times, at B=8
bf16 on random inputs from a seed, with CUDA events (median of the
repetitions): the forward with residuals (`hires_fwd_res`), the
forward-only kernel (`fused_attention_forward`, also with the mask off:
the attention kernel alone), the dq pass with its weight-grad reduction
(`hires_dq`) and the dk/dv pass (`hires_dkv`). A
torch.profiler trace of each call splits its device time by the kernels it
launched (the attention tiles, the strided product, the sums; a trace that
saw none of them is taken again, and the row says how many traces it
took), and beside the parts it times the single PyTorch calls that compute
them, which the port never calls: `scaled_dot_product_attention` with the
mask m as an additive bias (the attention tiles of the forward) and
`torch.matmul` at the shapes of the strided product's ssum, h1, m
(forward) and h1, dh1, dssum, dW1, dW2 (dq pass), and of the dk/dv pass's
four products per (batch, head). With --step it builds the model and
traces one bf16 training step at B=8, split by the same kernel families.
It prints one JSON line per shape, then the sums weighted by the launches
per hires forward (per training step for the passes of the backward),
with the card's name and power limit.

    python -m calm_vit_dte_tpu_torch.tools.time_hires [--batch 8] \\
        [--reps 5] [--step] [--no-yardsticks]

It times the package found first on `sys.path`: to compare two versions of
the kernels on one card in one run, start it from each checkout's root in
turn (each builds its own kernels under its own `build/`), for example old,
new, new, old. Kernel families are matched by name, old and new.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
from calm_vit_dte_tpu_torch.utils.configs import get_config

H = 12

# Kernel families of the hires route, by (demangled) kernel name: the fp32
# and first-design bf16 kernels and the tensor-core ones.
PARTS = {
    "attention forward": ("hires_attention_kernel",
                          "hires_attention_bf16_kernel"),
    "dm/ssum": ("hires_dm_ssum_kernel", "hires_dm_ssum_bf16_kernel"),
    "dq": ("hires_dq_kernel", "hires_dq_bf16_kernel"),
    "dk/dv": ("hires_dkv_kernel", "hires_dkv_bf16_kernel"),
    "strided product": ("namespace)::gemm_kernel", "gemm_tc_kernel"),
    "weight-grad partial sums": ("sum_partials_kernel",),
    "bias-grad sums": ("colsum_kernel", "sum_splits_kernel"),
}


def kernel_shapes(model_cfg) -> dict[tuple, int]:
    """{(S, D, Dv): launches} of one forward on the hires route (the
    rotation and the content++rope concat run in torch, so D = Dc + Dr)."""
    shapes: dict[tuple, int] = {}
    for _, bcfg in model_cfg.backbone_cfg().block_configs():
        for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(), bcfg.cross_cfg()):
            d = (v.head_dim_content + v.head_dim_rope) if v.reduce \
                else v.head_dim
            key = (v.seq_len_new, d, v.head_dim)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def inputs(b: int, s: int, d: int, dv: int, seed: int, dtype=torch.bfloat16):
    """(q, k, v, w1, b1, w2, b2) on the card and g = dL/do: q, k, v, g of
    order 0.3 in `dtype`, the fp32 mask weights scaled so that the mask's
    hidden layer and m are of order one."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale, dt=torch.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device="cuda", dtype=dt)

    args = (n(b, H, s, d, scale=0.3, dt=dtype), n(b, H, s, d, scale=0.3,
                                                  dt=dtype),
            n(b, H, s, dv, scale=0.3, dt=dtype),
            n(2 * s, s, scale=0.2 / s ** 0.5), n(2 * s, scale=0.1),
            n(s, 2 * s, scale=(2 * s) ** -0.5), n(s, scale=0.1))
    return args, n(b, H, s, dv, scale=0.3, dt=dtype)


def median_ms(fn, reps: int) -> float:
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


def split(events, counts: dict | None = None) -> dict[str, float]:
    """Device ms of each part (PARTS) and of everything else, from a
    profiler's key_averages(); `counts`, if given, receives each part's
    number of kernel launches."""
    out = dict.fromkeys(PARTS, 0.0)
    out["other"] = 0.0
    for e in events:
        if e.device_type.name != "CUDA":
            continue
        part = next((p for p, needles in PARTS.items()
                     if any(n in e.key for n in needles)), "other")
        out[part] += e.self_device_time_total / 1e3
        if counts is not None:
            counts[part] = counts.get(part, 0) + e.count
    return out


TRACE_TRIES = 4


def parts_ms(fn, reps: int) -> tuple[dict[str, float], int]:
    """(device ms per call of each part of `fn`, the traces taken), from a
    trace of `reps` calls. A kernel launched as a trace starts can be
    missed, so the calls are counted, not assumed: each call launches its
    kernel families at least once and some exactly once, so the smallest
    launch count of a family is the number of calls the trace saw. A trace
    that saw none of the kernels is taken again, up to TRACE_TRIES traces
    in all; if none saw them the parts are {} (not measured). Parts `fn`
    does not launch are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts: dict[str, int] = {}
        total = split(prof.key_averages(), counts)
        calls = min((n for p, n in counts.items() if p != "other"),
                    default=0)
        if calls:
            return {k: v / calls for k, v in total.items() if v > 0}, tries
    return {}, TRACE_TRIES


def yardsticks(args, reps: int) -> dict[str, float]:
    """ms of the PyTorch calls that compute the parts, on the same inputs:
    SDPA with m as an additive bias (bf16), torch.matmul at the shapes of
    ssum (heads folded into the contraction), h1, m, dh1, dssum, dW1 and dW2,
    and per (batch, head) at the dk/dv pass's four products, k q^T, v g^T,
    p^T g and ds^T q (a random g and a random (S, S) tile for p^T, ds^T)."""
    q, k, v, w1, _, w2, _ = args
    b, _, s, d = q.shape
    dt = q.dtype
    m = torch.randn(b, 1, s, s, device="cuda", dtype=dt)
    g = torch.randn_like(v)
    x_ss = torch.randn(b, H, s, s, device="cuda", dtype=dt)   # p^T, ds^T
    qf = q.transpose(1, 2).reshape(b, s, H * d).contiguous()
    kf = k.transpose(1, 2).reshape(b, s, H * d).transpose(1, 2).contiguous()
    x_s = torch.randn(b * s, s, device="cuda", dtype=dt)       # ssum, dm
    x_2s = torch.randn(b * s, 2 * s, device="cuda", dtype=dt)  # a, dh1
    w1c, w2c = w1.to(dt), w2.to(dt)
    calls = {
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=m),
        "matmul ssum": lambda: torch.matmul(qf, kf),
        "matmul h1": lambda: torch.matmul(x_s, w1c.t()),
        "matmul m": lambda: torch.matmul(x_2s, w2c.t()),
        "matmul dh1": lambda: torch.matmul(x_s, w2c),
        "matmul dssum": lambda: torch.matmul(x_2s, w1c),
        "matmul dW1": lambda: torch.matmul(x_2s.t(), x_s),
        "matmul dW2": lambda: torch.matmul(x_s.t(), x_2s),
        "matmul k q^T": lambda: torch.matmul(k, q.transpose(-1, -2)),
        "matmul v g^T": lambda: torch.matmul(v, g.transpose(-1, -2)),
        "matmul p^T g": lambda: torch.matmul(x_ss, g),
        "matmul ds^T q": lambda: torch.matmul(x_ss, q),
    }
    with torch.no_grad():
        return {name: median_ms(fn, reps) for name, fn in calls.items()}


def time_shape(b: int, s: int, d: int, dv: int, seed: int, reps: int,
               plain: bool = False, with_yardsticks: bool = True) -> dict:
    """Times of the four kernels (and, with `plain`, their plain versions),
    their parts and the yardsticks at one shape."""
    from calm_vit_dte_tpu_torch.kernels.axial_attention import attention_core

    args, g = inputs(b, s, d, dv, seed)
    kw = dict(scale=d ** -0.5, dtype=torch.bfloat16)
    q, k, v, w1, b1, w2, _ = args
    with torch.no_grad():
        o, m, lse = kh.hires_fwd_res_plain(*args, **kw)
        delta = (g.float() * o.float()).sum(-1)
        dssum = kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2,
                                  **kw)[1]
        calls = {
            "fwd_res": (lambda: kh.hires_fwd_res(*args, **kw),
                        lambda: kh.hires_fwd_res_plain(*args, **kw)),
            "fwd_only": (lambda: kh.fused_attention_forward(*args, **kw),
                         lambda: attention_core(*args, use_mask=True, **kw)),
            "dq": (lambda: kh.hires_dq(q, k, v, g, m, lse, delta, w1, b1, w2,
                                       **kw),
                   lambda: kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1,
                                             b1, w2, **kw)),
            "dkv": (lambda: kh.hires_dkv(q, k, v, g, m, lse, delta, dssum,
                                         **kw),
                    lambda: kh.hires_dkv_plain(q, k, v, g, m, lse, delta,
                                               dssum, **kw)),
        }
        row = {"shape": [s, d, dv]}
        for name, (kern, ref) in calls.items():
            parts, traces = parts_ms(kern, 3)
            row[name] = {"ms": median_ms(kern, reps), "parts_ms": parts,
                         "traces": traces}
            if plain:
                row[name]["plain_ms"] = median_ms(ref, max(2, reps // 2))
        # The attention kernel alone, without the mask: no strided product
        # and no reads of m.
        row["fwd_only_mask_off_ms"] = median_ms(
            lambda: kh.fused_attention_forward(*args, use_mask=False, **kw),
            reps)
        if with_yardsticks:
            row["yardsticks_ms"] = yardsticks(args, reps)
    return row


def trace_step(batch: int) -> dict:
    """One bf16 training step of hires-cls-1024 at `batch` (remat, after a
    warm step), traced: wall ms, device busy ms and its split by part."""
    from torch.profiler import ProfilerActivity, profile

    from calm_vit_dte_tpu_torch.data.augment import eval_preprocess
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.train.step import make_train_step

    cfg = get_config("hires-cls-1024")
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                          dtype=np.uint8)
    soft = rng.random((batch, cfg.model.out_features)).astype(np.float32)
    batch_ = {"image": images, "label": soft / soft.sum(-1, keepdims=True)}
    _, model = create_vit("hires-cls-1024", seed=cfg.init_seed,
                          device="cuda")
    tx = make_optimizer(base_lr=cfg.lr * batch / cfg.global_batch_size,
                        weight_decay=cfg.weight_decay, b1=cfg.beta1,
                        b2=cfg.beta2, epochs=cfg.epochs, steps_per_epoch=1000,
                        clip_norm=cfg.clip_norm, eta_min=cfg.eta_min,
                        schedule=cfg.schedule, decoupled_wd=cfg.decoupled_wd)
    state = create_train_state(model, tx, seed=0)
    step = make_train_step(
        cfg.model, tx, "cls", dtype=torch.bfloat16, remat=cfg.remat,
        preprocess=lambda gen, b: {
            "image": eval_preprocess(b["image"], crop=cfg.crop),
            "label": b["label"]}, microbatches=1)
    state, _ = step(state, batch_)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch_)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = split(prof.key_averages())
    return {"wall_ms": wall, "device_busy_ms": sum(parts.values()),
            "parts_ms": parts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--no-yardsticks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_hires needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    shapes = kernel_shapes(get_config("hires-cls-1024").model)
    sums = {k: 0.0 for k in ("fwd_res", "fwd_only", "dq", "dkv")}
    for i, ((s, d, dv), n) in enumerate(sorted(shapes.items(),
                                               reverse=True)):
        row = time_shape(args.batch, s, d, dv, seed=900 + i, reps=args.reps,
                         with_yardsticks=not args.no_yardsticks)
        row["launches"] = n
        for k in sums:
            sums[k] += n * row[k]["ms"]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    out = {"batch": args.batch, "per_hires_step_or_forward_ms": sums,
           "card": smi}
    if args.step:
        out["train_step"] = trace_step(args.batch)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
