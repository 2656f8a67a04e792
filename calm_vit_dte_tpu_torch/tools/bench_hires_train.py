"""hires-cls-1024 training on one card: byte accounting, the production step,
and the largest batch that fits.

Port of scripts/bench_hires_train.py, with its arguments, defaults and
summary fields. The 935.57M-parameter model's training state is counted
first (`accounting`, the JAX script's arithmetic unchanged: fp32 master,
the two AdamW moments at --moment-dtype, a bf16 parameter copy, fp32
gradients), and printed against the card's memory
(`torch.cuda.mem_get_info`). Then the production step runs at --batch:
`make_train_step` (bf16 compute, remat, cls preprocessing on the card,
--microbatch) with `train/optim.py::FusedAdamW` storing its moments at
--moment-dtype, on a resident synthetic batch, recording ms per step,
images/s, the peak of `torch.cuda.max_memory_allocated` and the hires
kernels' launches per step. `--search-max-batch` then finds the largest
batch whose first step fits (doubling from 8, then bisecting to within
2).

Writes hires_train_<moment dtype>.json under --out
(docs/evidence/torch_h100 by default) with the card's `nvidia-smi` name
and power limit. A failed step is written into the JSON as the JAX
script does, and the tool then exits non-zero. Runs on the card unless
`--device cpu` (with --config tiny-cls, for the tests).

    python -m calm_vit_dte_tpu_torch.tools.bench_hires_train [--batch 2] \\
        [--steps 5] [--microbatch 1] [--moment-dtype bf16|fp32] \\
        [--search-max-batch]
"""

from __future__ import annotations

import argparse
import math
import time

from calm_vit_dte_tpu_torch.tools._common import OUT

SEARCH_START, SEARCH_STEP = 8, 2   # --search-max-batch: from 8, to within 2


def accounting(n_params: int, batch: int, moment_bytes: int) -> dict:
    gb = 1 << 30
    acct = {
        "n_params": n_params,
        "master_fp32_gb": round(4 * n_params / gb, 2),
        "adam_moments_gb": round(2 * moment_bytes * n_params / gb, 2),
        "bf16_param_copy_gb": round(2 * n_params / gb, 2),
        "grads_fp32_gb": round(4 * n_params / gb, 2),
    }
    acct["states_total_gb"] = round(
        acct["master_fp32_gb"] + acct["adam_moments_gb"]
        + acct["bf16_param_copy_gb"] + acct["grads_fp32_gb"], 2)
    return acct


class _Run:
    """The model, optimizer and step of one configuration; `step(batch)`
    runs one synchronised step and returns its host seconds and loss."""

    def __init__(self, args, dev):
        import torch

        from calm_vit_dte_tpu_torch.data.pipeline import make_cls_preprocess
        from calm_vit_dte_tpu_torch.models.factory import create_vit
        from calm_vit_dte_tpu_torch.train.optim import make_optimizer
        from calm_vit_dte_tpu_torch.train.state import create_train_state
        from calm_vit_dte_tpu_torch.train.step import make_train_step
        from calm_vit_dte_tpu_torch.utils.configs import get_config

        self.torch, self.dev = torch, dev
        self.cfg = cfg = get_config(args.config)
        mdt = torch.bfloat16 if args.moment_dtype == "bf16" else torch.float32
        _, model = create_vit(args.config, seed=0, device=dev)
        self.n_params = sum(p.numel() for p in model.parameters())
        tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                            epochs=cfg.epochs, steps_per_epoch=100,
                            moment_dtype=mdt)
        self.state = create_train_state(model, tx, seed=1)
        self.step_fn = make_train_step(
            cfg.model, tx, cfg.task, dtype=torch.bfloat16, remat=True,
            preprocess=make_cls_preprocess(cfg.model.out_features, cfg.crop),
            microbatches=args.microbatch)

    def batch(self, n: int) -> dict:
        import numpy as np

        rng = np.random.default_rng(0)
        size = self.cfg.image_size
        torch = self.torch
        return {"image": torch.from_numpy(rng.integers(
                    0, 256, (n, size, size, 3), dtype=np.uint8)).to(self.dev),
                "label": torch.from_numpy(rng.integers(
                    0, self.cfg.model.out_features, (n,),
                    dtype=np.int32)).to(self.dev)}

    def step(self, batch) -> tuple[float, float]:
        from calm_vit_dte_tpu_torch.tools._common import sync

        sync(self.dev)
        t0 = time.perf_counter()
        self.state, m = self.step_fn(self.state, batch)
        loss = float(m["loss"])   # waits for the card
        sync(self.dev)
        return time.perf_counter() - t0, loss


def search_max_batch(run: _Run, start: int, step: int,
                     limit: int = 4096) -> dict:
    """The largest batch whose first training step fits on the card:
    double from `start` until a step runs out of memory, then bisect to
    `step`. Returns {"max_batch_fits", "first_oom_batch", "trials"}."""
    torch = run.torch
    trials = []

    def fits(b: int) -> bool:
        batch = None
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(run.dev)
            batch = run.batch(b)
            secs, loss = run.step(batch)
            trials.append({"batch": b, "fits": True, "step_s": secs,
                           "loss": loss, "peak_gib":
                           torch.cuda.max_memory_allocated(run.dev) / 2**30})
            return True
        except torch.cuda.OutOfMemoryError as e:
            trials.append({"batch": b, "fits": False,
                           "error": str(e).splitlines()[0][:300]})
            return False
        finally:
            del batch
            for p in run.state.model.parameters():
                p.grad = None
            torch.cuda.empty_cache()

    lo, hi = 0, None
    b = start
    while b <= limit:
        if fits(b):
            lo, b = b, 2 * b
        else:
            hi = b
            break
    while hi is not None and hi - lo > step:
        mid = (lo + hi) // 2 // step * step
        if mid <= lo:
            break
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return {"max_batch_fits": lo, "first_oom_batch": hi, "trials": trials}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--moment-dtype", default="bf16",
                    choices=["bf16", "fp32"])
    ap.add_argument("--search-max-batch", action="store_true",
                    help="after the steps, find the largest batch that fits")
    ap.add_argument("--config", default="hires-cls-1024")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    import json

    import torch

    from calm_vit_dte_tpu_torch.tools._common import (
        card,
        launches_since,
        write_json,
    )
    from calm_vit_dte_tpu_torch.utils.device import resolve_device
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    dev = resolve_device(args.device)
    summary = {"config": args.config, "batch": args.batch,
               "microbatch": args.microbatch,
               "moment_dtype": args.moment_dtype, "ts": time.time(),
               "card": card(dev), "torch": torch.__version__}
    try:
        run = _Run(args, dev)
        acct = accounting(run.n_params, args.batch,
                          2 if args.moment_dtype == "bf16" else 4)
        summary["accounting"] = acct
        if dev.type == "cuda":
            free, total = torch.cuda.mem_get_info(dev)
            summary["card_memory_gib"] = {"total": total / 2**30,
                                          "free_after_init": free / 2**30}
            print(f"byte accounting ({card(dev)['nvidia_smi']}, "
                  f"{total / 2**30:.1f} GiB; {free / 2**30:.1f} GiB free "
                  f"with the state allocated):", json.dumps(acct, indent=1),
                  flush=True)
        batch = run.batch(args.batch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        first_s, loss = run.step(batch)
        print(f"step 1 ok: loss={loss:.4f} (first step {first_s:.1f}s)",
              flush=True)
        times, losses = [], [loss]
        for i in range(args.steps - 1):
            secs, loss = run.step(batch)
            times.append(secs)
            losses.append(loss)
            print(f"step {i + 2}: loss={loss:.4f} {secs * 1e3:.0f} ms",
                  flush=True)
        launches = launches_since(before)
        p50 = sorted(times)[len(times) // 2] if times else None
        card_run = dev.type == "cuda"   # no device figures from a CPU run
        summary.update(
            status="trained",
            loss_last=losses[-1], losses=losses,
            first_step_s=round(first_s, 3) if card_run else None,
            p50_step_s=round(p50, 4) if p50 and card_run else None,
            img_per_s=round(args.batch / p50, 2) if p50 and card_run
            else None,
            kernel_launches_per_step={k: n / args.steps
                                      for k, n in launches.items()})
        if card_run:
            summary["hbm_peak_gb"] = round(
                torch.cuda.max_memory_allocated(dev) / 2**30, 3)
            summary["hbm_limit_gb"] = round(
                torch.cuda.mem_get_info(dev)[1] / 2**30, 2)
        if not all(map(math.isfinite, losses)):
            raise FloatingPointError(f"non-finite loss: {losses}")
        if args.search_max_batch:
            if not card_run:
                raise ValueError("--search-max-batch needs the card")
            del batch
            summary["max_batch"] = search_max_batch(run, SEARCH_START,
                                                    SEARCH_STEP)
            print(f"largest batch that fits: "
                  f"{summary['max_batch']['max_batch_fits']}", flush=True)
    except Exception as e:
        summary.update(status="failed",
                       error=f"{type(e).__name__}: {str(e)[:2000]}")
        write_json(args.out, f"hires_train_{args.moment_dtype}.json",
                   summary)
        raise
    write_json(args.out, f"hires_train_{args.moment_dtype}.json", summary)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("accounting", "max_batch")}, indent=1))
    return summary


if __name__ == "__main__":
    main()
