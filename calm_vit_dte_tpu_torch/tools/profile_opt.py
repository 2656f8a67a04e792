"""The optimizer's share of a training step: `train/optim.py::FusedAdamW`
timed alone on the flagship's parameters.

Port of scripts/profile_opt.py, which timed the JAX package's optax
variants and the step's grad_norm metric on flagship-sized trees. Here the
flagship's 42.58M parameters (every tensor of `create_vit`'s model) get
constant gradients (1e-4, as in the script); each variant runs --reps times
after --warmup, and is timed twice on the card: `event_ms`, the median span
between two CUDA events around one call, which is the call's wall time on
the stream, its host gaps included (launches, the host read of the norm);
and `busy_ms`, the device's busy time a call, the sum of the device time of
the kernels and copies in a torch.profiler trace of --reps calls, with
`device_ops`, the kernels and copies a call:

  fused_adamw_fp32        `FusedAdamW.update`, the production step's call:
                          the clip's global norm, its one host read, then
                          the moments and parameters (fp32 moments);
  fused_adamw_bf16        the same with moments stored in bf16
                          (moment_dtype, the hires memory mode);
  global_norm             the clip's global norm and its host read alone;
  apply_fp32, apply_bf16  `FusedAdamW.apply`: the update without the
                          global norm (the clip scale from a given norm);
  torch_adamw_fused       yardstick only, on no path of the port:
                          torch.optim.AdamW(fused=True), and with
  torch_clip_adamw_fused  torch.nn.utils.clip_grad_norm_ before it.

Beside them, the flagship's bf16 training step (`make_train_step` at
--step-batch, the config's remat, a resident synthetic batch) timed the
same two ways, and the optimizer's share of it by each. Writes
profile_opt.json under --out (docs/evidence/torch_h100 by default) with the
card's `nvidia-smi` name and power limit. Runs on the card unless
`--device cpu`, where the times are the host clock's (`host_ms`) and no
device figure is written.

    python -m calm_vit_dte_tpu_torch.tools.profile_opt [--reps 20]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from calm_vit_dte_tpu_torch.tools._common import OUT


def time_ms(fn, dev: torch.device, reps: int, warmup: int) -> float:
    """Median ms of one `fn()`: the span between CUDA events around each
    call on the card (host gaps included), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def busy_ms(fn, reps: int) -> dict:
    """{"busy_ms": the device's busy ms a call of `fn`, "device_ops": the
    kernels and copies a call}, from a torch.profiler trace of `reps` calls
    of an `fn` that `time_ms` has warmed (both None if the trace saw no
    device work: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    if not events:
        return {"busy_ms": None, "device_ops": None}
    return {"busy_ms": sum(e.self_device_time_total for e in events)
            / 1e3 / reps,
            "device_ops": sum(e.count for e in events) / reps}


def optimizer_variants(params: list[torch.Tensor], cfg) -> dict:
    """name -> a call of one optimizer step on `params` (in place)."""
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer

    grads = [torch.full_like(p, 1e-4) for p in params]
    out = {}
    for tag, mdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                            cfg.epochs, 1000, cfg.clip_norm, cfg.eta_min,
                            moment_dtype=mdt)
        st = tx.init(params)
        out[f"fused_adamw_{tag}"] = (
            lambda tx=tx, st=st: tx.update(params, grads, st))
        out[f"apply_{tag}"] = (
            lambda tx=tx, st=st: tx.apply(params, grads, st, 0.5))
        if tag == "fp32":
            out["global_norm"] = (
                lambda tx=tx: float(tx.global_norm(grads)))
    if params[0].is_cuda:
        copies = [p.detach().clone().requires_grad_() for p in params]
        for c, g in zip(copies, grads):
            c.grad = g.clone()
        adamw = torch.optim.AdamW(copies, lr=cfg.lr, betas=(cfg.beta1,
                                                            cfg.beta2),
                                  eps=1e-8, weight_decay=cfg.weight_decay,
                                  fused=True)
        out["torch_adamw_fused"] = adamw.step

        def clip_adamw():
            torch.nn.utils.clip_grad_norm_(copies, cfg.clip_norm,
                                           foreach=True)
            adamw.step()

        out["torch_clip_adamw_fused"] = clip_adamw
    return out


def step_ms(config: str, batch: int, dev: torch.device, reps: int) -> dict:
    """The flagship's bf16 training step: its median ms (`ms`: CUDA events
    on the card, the host clock on the CPU) and, on the card, its busy
    ms."""
    from calm_vit_dte_tpu_torch.data.pipeline import make_cls_preprocess
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.train.step import make_train_step
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    cfg = get_config(config)
    _, model = create_vit(config, seed=0, device=dev)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                        cfg.epochs, 1000)
    holder = {"state": create_train_state(model, tx, seed=1)}
    fn = make_train_step(cfg.model, tx, "cls", dtype=torch.bfloat16,
                         remat=cfg.remat,
                         preprocess=make_cls_preprocess(
                             cfg.model.out_features, cfg.crop))
    rng = np.random.default_rng(0)
    size = cfg.image_size
    b = {"image": torch.from_numpy(rng.integers(
             0, 256, (batch, size, size, 3), dtype=np.uint8)).to(dev),
         "label": torch.from_numpy(rng.integers(
             0, cfg.model.out_features, (batch,), dtype=np.int32)).to(dev)}

    def one():
        holder["state"], _ = fn(holder["state"], b)

    out = {"config": config, "batch": batch, "remat": cfg.remat,
           "dtype": "bfloat16", "ms": time_ms(one, dev, reps, warmup=1)}
    if dev.type == "cuda":
        out.update(busy_ms(one, reps))
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--step-batch", type=int, default=128)
    ap.add_argument("--step-reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.tools._common import card, write_json
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    _, model = create_vit(args.config, seed=0, device=dev)
    params = [p.detach() for p in model.parameters()]
    n_params = sum(p.numel() for p in params)
    n_tensors = len(params)
    print(f"{n_tensors} tensors, {n_params / 1e6:.2f}M params", flush=True)
    key = "event_ms" if dev.type == "cuda" else "host_ms"
    rows = {}
    for name, fn in optimizer_variants(params, cfg).items():
        rows[name] = {key: time_ms(fn, dev, args.reps, args.warmup)}
        if dev.type == "cuda":
            rows[name].update(busy_ms(fn, args.reps))
        print(f"{name:28s} " + ", ".join(
            f"{k} {v:.3f}" for k, v in rows[name].items()
            if v is not None), flush=True)
    del model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    step = step_ms(args.config, args.step_batch, dev, args.step_reps)
    print(f"{args.config} bf16 training step B={args.step_batch}: "
          f"{step['ms']:.2f} ms, busy {step.get('busy_ms')} ms", flush=True)
    share = rows["fused_adamw_fp32"][key] / step["ms"]
    busy = rows["fused_adamw_fp32"].get("busy_ms")
    out = {"config": args.config, "n_params": n_params,
           "n_tensors": n_tensors, "reps": args.reps, "timing": key,
           "variants": rows, "step": {**step, "timing": key},
           "optimizer_share_of_step": share,
           "optimizer_busy_share_of_step":
               busy / step["busy_ms"] if busy and step.get("busy_ms")
               else None,
           "card": card(dev), "device": dev.type,
           "torch": torch.__version__, "ts": time.time()}
    write_json(args.out, "profile_opt.json", out)
    return out


if __name__ == "__main__":
    main()
