"""Full-val-scale evaluation bench: `evaluate()` over 50,000 JPEGs on disk.

Port of scripts/bench_eval_50k.py, with its arguments, defaults and
summary fields. It runs the port's production `train/evaluate.py::
evaluate` (BatchLoader + ShardedSampler + the native JPEG decoder +
pad_last masking + the bf16 eval forward of a frozen Predictor) over a
staged ImageNet-val-sized corpus (100 classes x 500 JPEGs at 256 px, the
val split of tools/soak.py::stage_corpus, seed 7: the JAX script's bytes),
and records the sustained images/s, the wall time and where it went:
`loader_wait_s` (the loop waiting for the next decoded batch) and
`device_s` (upload, the forward, and the argmax read back, which waits for
the card), with their shares of the wall. The model is a fresh init
(the checkpoint directory does not exist): a throughput bench, not an
accuracy one.

Writes eval_50k.json under --out (docs/evidence/torch_h100 by default)
with the card's `nvidia-smi` name and power limit. Runs on the card unless
`--device cpu`.

    python -m calm_vit_dte_tpu_torch.tools.bench_eval_50k [--batch 128] \\
        [--max-batches N] [--stage-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time

from calm_vit_dte_tpu_torch.tools._common import OUT, REPO

VAL_CORPUS = REPO / ".eval50k_corpus"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--per-class", type=int, default=500)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--stage-only", action="store_true")
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--corpus", type=pathlib.Path, default=VAL_CORPUS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


# Seconds by which the loader wait and the device time may pass the wall
# they are measured inside (separate clock reads).
SLACK_S = 0.01


def accounting_fault(exact: dict) -> str | None:
    """Why the loader wait and the device seconds do not fit in the wall
    (within SLACK_S), or None; `exact` is `evaluate`'s stats_out["exact_s"],
    the unrounded seconds. The rounded keys cannot be compared so: rounding
    each to 0.01 s can put their sum a whole 0.01 above the rounded wall
    when the intervals nest, and then float error decides (0.02 + 0.05 >
    0.06 + 0.01)."""
    if exact["loader_wait"] + exact["device"] > exact["wall"] + SLACK_S:
        return (f"loader wait {exact['loader_wait']!r} s + device "
                f"{exact['device']!r} s exceed the wall {exact['wall']!r} s")
    return None


def main(argv: list[str] | None = None) -> dict | None:
    args = parse_args(argv)

    from calm_vit_dte_tpu_torch.tools.soak import stage_corpus

    t0 = time.time()
    stage_corpus(args.corpus, args.classes, args.per_class, args.img_size,
                 split="val")
    stage_s = time.time() - t0
    if args.stage_only:
        return None

    from calm_vit_dte_tpu_torch.data import native
    from calm_vit_dte_tpu_torch.tools._common import (
        card,
        launches_since,
        write_json,
    )
    from calm_vit_dte_tpu_torch.train.evaluate import evaluate
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.device import resolve_device
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config(args.config),
        dataset_root=str(args.corpus),
        global_batch_size=args.batch,
        checkpoint_dir=str(REPO / ".eval50k_nonexistent_ckpt"))

    stats: dict = {}
    before = launch_counts()
    t0 = time.time()
    acc = evaluate(cfg, max_batches=args.max_batches, stats_out=stats,
                   device=dev)
    summary = {
        "corpus_images": args.classes * args.per_class,
        "batch": args.batch,
        "top1": round(acc, 4),  # fresh init: a throughput bench
        **stats,
        "loader_share": round(stats["loader_wait_s"] / stats["wall_s"], 3),
        "device_share": round(stats["device_s"] / stats["wall_s"], 3),
        "total_wall_s": round(time.time() - t0, 1),
        "ts": time.time(),
        "stage_s": round(stage_s, 1),
        "config": args.config,
        "card": card(dev),
        "host_cores": os.cpu_count(),
        "num_workers": cfg.num_workers,
        # The loader's decoder, decided per process as data/loader.py does.
        "decoder": "pillow" if (os.environ.get("CALM_NATIVE_DECODE") == "0"
                                or native.unavailable_reason()) else "native",
        "native_libjpeg": native.libjpeg(),
        "kernel_launches": launches_since(before),
    }
    write_json(args.out, "eval_50k.json", summary)
    fault = accounting_fault(stats["exact_s"])
    if fault:
        raise SystemExit(f"eval_50k: {fault}")
    return summary


if __name__ == "__main__":
    main()
