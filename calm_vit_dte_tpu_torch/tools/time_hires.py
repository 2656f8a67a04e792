"""Time the long-sequence (hires) attention kernels on the card at
`hires-cls-1024`'s shapes, by part, beside their library yardsticks.

For every kernel shape (S, D, Dv) of one hires forward it times, at B=8
in bf16 (or the --dtype given) on random inputs from a seed, with CUDA
events (median of the repetitions), beside each call's bound (`bound_ms`):
the forward with residuals (`hires_fwd_res`), the
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
four products per (batch, head). With --heads N the model's heads are
N (`create_vit(..., heads=N)`: at 6, head dims 512, 416, 320, 224), and
with --trace-dir DIR each call at the widest shape is traced once more:
the chrome trace goes to DIR and the row lists that call's kernels by
name, launches and device ms. With --step it builds the model and traces
one bf16 training step at B=8, split by the same kernel families. It
prints one JSON line per shape, then the sums weighted by the launches
per hires forward (per training step for the passes of the backward),
with the card's name and power limit.

    python -m calm_vit_dte_tpu_torch.tools.time_hires [--batch 8] \\
        [--heads 12] [--dtype bfloat16|float32] [--plain] [--reps 5] \\
        [--step] [--no-yardsticks] [--trace-dir DIR] [--config NAME] \\
        [--shape S D DV ...]

--config times the hires kernels at another config's attention shapes
(D = Dc + Dr, q and k as if rotated), e.g. imagenet-cls-224's, where the
rope kernels run them on the model's path.

With --dtype float32 every pass runs the CUDA-core kernels (the card-vs-CPU
checks' route), and the yardsticks run in fp32 too; --step always traces the
model's bf16 training step.

It times the package found first on `sys.path`: to compare two versions of
the kernels on one card in one run, start it from each checkout's root in
turn (each builds its own kernels under its own `build/`), for example old,
new, new, old. Kernel families are matched by name, old and new; the
script uses no name the older packages lack. Each call's row carries a
digest of its outputs (`digest`), equal where two versions agree bit for
bit. --shape S D DV (repeatable) times those shapes, one launch each,
instead of the config's.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
from calm_vit_dte_tpu_torch.utils.configs import get_config

H = 12   # hires-cls-1024's heads; --heads overrides
PEAK_FLOPS = {torch.bfloat16: 989e12,  # H100 SXM dense bf16 tensor cores
              torch.float32: 67e12}    # H100 SXM fp32 outside them
PEAK_BYTES = 3.35e12                   # H100 SXM HBM3

# Kernel families of the hires route, by (demangled) kernel name: the fp32
# and first-design bf16 kernels and the tensor-core ones, the wide ones
# (D or Dv past 256) included.
PARTS = {
    "attention forward": ("hires_attention_kernel",
                          "hires_attention_bf16_kernel",
                          "hires_attention_wide_bf16_kernel"),
    "dm/ssum": ("hires_dm_ssum_kernel", "hires_dm_ssum_bf16_kernel"),
    "dq": ("hires_dq_kernel", "hires_dq_bf16_kernel",
           "hires_dq_wide_bf16_kernel"),
    "dk/dv": ("hires_dkv_kernel", "hires_dkv_bf16_kernel",
              "hires_dkv_wide_bf16_kernel"),
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


def inputs(b: int, s: int, d: int, dv: int, seed: int, dtype=torch.bfloat16,
           heads: int = H):
    """(q, k, v, w1, b1, w2, b2) on the card and g = dL/do: q, k, v, g of
    order 0.3 in `dtype`, the fp32 mask weights scaled so that the mask's
    hidden layer and m are of order one."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale, dt=torch.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device="cuda", dtype=dt)

    args = (n(b, heads, s, d, scale=0.3, dt=dtype),
            n(b, heads, s, d, scale=0.3, dt=dtype),
            n(b, heads, s, dv, scale=0.3, dt=dtype),
            n(2 * s, s, scale=0.2 / s ** 0.5), n(2 * s, scale=0.1),
            n(s, 2 * s, scale=(2 * s) ** -0.5), n(s, scale=0.1))
    return args, n(b, heads, s, dv, scale=0.3, dt=dtype)


def bound_ms(b: int, h: int, s: int, d: int, dv: int, dtype) -> dict:
    """The least ms the card could take for each call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its products' operations (the mask MLP's included) over the
    compute type's peak (bf16 tensor cores, or fp32 outside them)."""
    item = torch.finfo(dtype).bits // 8
    mlp = 4 * b * s ** 3                       # one (B*S, S) x (S, 2S) product
    qkvo = b * h * s * (2 * d + 2 * dv) * item
    weights = (2 * s * 2 * s + 3 * s) * 4
    sq, vec = b * s * s * 4, b * h * s * 4      # an fp32 (B, S, S); lse
    attn = 2 * b * h * s * s * (d + dv)
    work = {"fwd_only": (qkvo + weights, attn + 2 * mlp),
            "fwd_res": (qkvo + weights + sq + vec, attn + 2 * mlp),
            "dq": (qkvo + weights + 2 * sq + 2 * vec + b * h * s * d * item
                   + weights, 2 * b * h * s * s * (2 * d + dv) + 5 * mlp),
            "dkv": (qkvo + b * h * s * (d + dv) * item + 2 * sq + 2 * vec,
                    2 * attn)}
    return {k: max(nb / PEAK_BYTES, fl / PEAK_FLOPS[dtype]) * 1e3
            for k, (nb, fl) in work.items()}


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


def part_of(kernel: str) -> str:
    """The part (PARTS) of a kernel by its demangled name, or "other"."""
    return next((p for p, needles in PARTS.items()
                 if any(n in kernel for n in needles)), "other")


def split(events, counts: dict | None = None) -> dict[str, float]:
    """Device ms of each part (PARTS) and of everything else, from a
    profiler's key_averages(); `counts`, if given, receives each part's
    number of kernel launches."""
    out = dict.fromkeys(PARTS, 0.0)
    out["other"] = 0.0
    for e in events:
        if e.device_type.name != "CUDA":
            continue
        part = part_of(e.key)
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


def trace_call(fn, path: pathlib.Path) -> list[dict]:
    """One traced call of `fn` (after a warm one): its chrome trace written
    to `path`, and its kernels and copies by name with their launches and
    device ms, the largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    rows = [{"name": e.key, "launches": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r["device_ms"])


def yardsticks(args, reps: int) -> dict[str, float]:
    """ms of the PyTorch calls that compute the parts, on the same inputs:
    SDPA with m as an additive bias (bf16), torch.matmul at the shapes of
    ssum (heads folded into the contraction), h1, m, dh1, dssum, dW1 and dW2,
    and per (batch, head) at the dk/dv pass's four products, k q^T, v g^T,
    p^T g and ds^T q (a random g and a random (S, S) tile for p^T, ds^T)."""
    q, k, v, w1, _, w2, _ = args
    b, h, s, d = q.shape
    dt = q.dtype
    m = torch.randn(b, 1, s, s, device="cuda", dtype=dt)
    g = torch.randn_like(v)
    x_ss = torch.randn(b, h, s, s, device="cuda", dtype=dt)   # p^T, ds^T
    qf = q.transpose(1, 2).reshape(b, s, h * d).contiguous()
    kf = k.transpose(1, 2).reshape(b, s, h * d).transpose(1, 2).contiguous()
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
               plain: bool = False, with_yardsticks: bool = True,
               heads: int = H, trace_dir: pathlib.Path | None = None,
               dtype=torch.bfloat16) -> dict:
    """Times of the four kernels (and, with `plain`, their plain versions),
    their parts and the yardsticks at one shape in `dtype`; with
    `trace_dir`, one traced call of each (`trace_call`)."""
    from calm_vit_dte_tpu_torch.kernels.axial_attention import attention_core

    args, g = inputs(b, s, d, dv, seed, dtype=dtype, heads=heads)
    kw = dict(scale=d ** -0.5, dtype=dtype)
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
        row = {"shape": [s, d, dv], "heads": heads,
               "dtype": str(dtype).removeprefix("torch.")}
        bounds = bound_ms(b, heads, s, d, dv, dtype)
        for name, (kern, ref) in calls.items():
            parts, traces = parts_ms(kern, 3)
            row[name] = {"ms": median_ms(kern, reps), "parts_ms": parts,
                         "traces": traces, "bound_ms": bounds[name],
                         "digest": digest(kern())}
            if plain:
                row[name]["plain_ms"] = median_ms(ref, max(2, reps // 2))
            if trace_dir is not None:
                path = trace_dir / f"{name}_H{heads}_S{s}_D{d}_Dv{dv}.json"
                row[name]["trace"] = {"file": str(path),
                                      "kernels": trace_call(kern, path)}
        # The attention kernel alone, without the mask: no strided product
        # and no reads of m.
        row["fwd_only_mask_off_ms"] = median_ms(
            lambda: kh.fused_attention_forward(*args, use_mask=False, **kw),
            reps)
        if with_yardsticks:
            row["yardsticks_ms"] = yardsticks(args, reps)
    return row


def digest(outputs) -> str:
    """sha256 of a call's output tensors' bytes, in order: equal where two
    versions of the kernels agree bit for bit on the same inputs."""
    h = hashlib.sha256()
    for t in outputs if isinstance(outputs, (tuple, list)) else (outputs,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def trace_step(batch: int, heads: int = H) -> dict:
    """One bf16 training step of hires-cls-1024 with `heads` heads at
    `batch` (remat, after a warm step), traced: wall ms, device busy ms and
    its split by part."""
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
    model_cfg, model = create_vit("hires-cls-1024", seed=cfg.init_seed,
                                  device="cuda", heads=heads)
    tx = make_optimizer(base_lr=cfg.lr * batch / cfg.global_batch_size,
                        weight_decay=cfg.weight_decay, b1=cfg.beta1,
                        b2=cfg.beta2, epochs=cfg.epochs, steps_per_epoch=1000,
                        clip_norm=cfg.clip_norm, eta_min=cfg.eta_min,
                        schedule=cfg.schedule, decoupled_wd=cfg.decoupled_wd)
    state = create_train_state(model, tx, seed=0)
    step = make_train_step(
        model_cfg, tx, "cls", dtype=torch.bfloat16, remat=cfg.remat,
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
    ap.add_argument("--heads", type=int, default=H)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--plain", action="store_true",
                    help="also time each pass's plain PyTorch version")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--no-yardsticks", action="store_true")
    ap.add_argument("--trace-dir", type=pathlib.Path, default=None,
                    help="trace each call at the widest shape into DIR")
    ap.add_argument("--config", default="hires-cls-1024",
                    help="the config whose attention shapes to time")
    ap.add_argument("--shape", type=int, nargs=3, action="append",
                    metavar=("S", "D", "DV"), default=None,
                    help="time this (S, D, Dv) once instead of the "
                         "config's shapes (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_hires needs a CUDA card")
    dtype = getattr(torch, args.dtype)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    shapes = ({tuple(x): 1 for x in args.shape} if args.shape else
              kernel_shapes(dataclasses.replace(
                  get_config(args.config).model, heads=args.heads)))
    widest = max(shapes, key=lambda k: (k[1], k[2]))
    sums = {k: 0.0 for k in ("fwd_res", "fwd_only", "dq", "dkv")}
    bound_sums, plain_sums = dict.fromkeys(sums, 0.0), dict.fromkeys(sums, 0.0)
    for i, ((s, d, dv), n) in enumerate(sorted(shapes.items(),
                                               reverse=True)):
        row = time_shape(args.batch, s, d, dv, seed=900 + i, reps=args.reps,
                         plain=args.plain,
                         with_yardsticks=not args.no_yardsticks,
                         heads=args.heads, dtype=dtype,
                         trace_dir=(args.trace_dir if (s, d, dv) == widest
                                    else None))
        row["launches"] = n
        for k in sums:
            sums[k] += n * row[k]["ms"]
            bound_sums[k] += n * row[k]["bound_ms"]
            plain_sums[k] += n * row[k].get("plain_ms", 0.0)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    out = {"config": args.config, "batch": args.batch, "heads": args.heads,
           "dtype": args.dtype,
           "per_hires_step_or_forward_ms": sums,
           "bound_per_hires_step_or_forward_ms": bound_sums, "card": smi}
    if args.plain:
        out["plain_per_hires_step_or_forward_ms"] = plain_sums
    if args.step:
        out["train_step"] = trace_step(args.batch, args.heads)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
