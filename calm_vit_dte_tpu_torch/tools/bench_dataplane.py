"""End-to-end data-plane benchmark: decode rates, then the production loader
feeding the real flagship train step from disk.

Port of scripts/bench_dataplane.py, with its arguments, defaults and JSON
fields. On an on-disk JPEG corpus (data/corpus.py's learnable corpus: no
network, so procedural JPEGs stand in for staged ImageNet; they are real
libjpeg work at the same sizes) it measures:

  1. standalone decode + resize throughput: the native decoder
     (data/native.py over native/decoder.cpp) at 1, 2 and 4 threads, and
     Pillow, in images/s and MB/s (best of --repeat);
  2. integrated training throughput: the port's ImageFolderDataset,
     ShardedSampler, BatchLoader and the trainer's pinned side-stream
     device feed, feeding `make_train_step` (the flagship, bf16, remat off,
     `make_cls_preprocess` on the card) from disk, against the same step on
     one resident synthetic batch, and the loader alone with no device
     work. The card is synchronised before every clock read, and each rate
     is the median of --chains chains of --steps steps, all three taken in
     one process: the host clock varies between calls. The from-disk run
     also records the host ms a step waits for its next decoded batch: a
     from-disk step slower than the resident one with no wait is the
     decode threads taking the host from the step's launches, not a
     loader that falls behind;
  3. a stall analysis: the host's per-core decode rate against the card's
     consumption rate, and the host cores the loader needs to keep it fed.

It records which decoder served the loader's batches (`decoder`,
`pillow_images`: Pillow taking over would hide the native decoder), the
kernels launched on the from-disk run, and the card's `nvidia-smi` name and
power limit. Writes dataplane.json under --out (docs/evidence/torch_h100
by default; never the JAX package's docs/evidence/dataplane.json). Runs on
the card unless `--device cpu`.

    python -m calm_vit_dte_tpu_torch.tools.bench_dataplane [--images 512] \\
        [--steps 12]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from calm_vit_dte_tpu_torch.tools._common import OUT, REPO

DEFAULT_ROOT = REPO / ".dataplane_corpus"
CORPUS_SIZE = 384   # the JAX script's corpus: make_corpus's default size


def bench_standalone(paths: list[str], size: int, threads: list[int],
                     repeat: int = 3) -> dict:
    from PIL import Image

    from calm_vit_dte_tpu_torch.data import native

    total_bytes = sum(os.path.getsize(p) for p in paths)
    out: dict = {"n_images": len(paths), "decode_size": size,
                 "mean_jpeg_kb": round(total_bytes / len(paths) / 1024, 1)}
    if native.available():
        for nt in threads:
            times = []
            for _ in range(repeat):
                t0 = time.perf_counter()
                _, ok = native.decode_resize_batch(paths, size, n_threads=nt)
                times.append(time.perf_counter() - t0)
            if not ok.all():
                raise RuntimeError("native decode failures in the corpus")
            dt = min(times)
            out[f"native_{nt}t_img_per_s"] = round(len(paths) / dt, 1)
            out[f"native_{nt}t_mb_per_s"] = round(total_bytes / dt / 1e6, 1)
    else:
        out["native"] = "unavailable"
        out["native_reason"] = native.unavailable_reason()

    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        for p in paths:
            with Image.open(p) as im:
                im = im.convert("RGB").resize((size, size), Image.BILINEAR)
                np.asarray(im)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    out["pil_img_per_s"] = round(len(paths) / dt, 1)
    out["pil_mb_per_s"] = round(total_bytes / dt / 1e6, 1)
    return out


def _epochs(loader, sampler):
    """The loader's batches over as many epochs as the caller takes."""
    epoch = 0
    while True:
        sampler.set_epoch(epoch)
        yield from loader
        epoch += 1


def bench_integrated(root, batch: int, steps: int, config: str,
                     dev: torch.device, chains: int = 3) -> dict:
    """Production loader feeding the production step from disk vs the same
    step on one resident synthetic batch, and the loader alone."""
    from calm_vit_dte_tpu_torch.data.loader import (
        BatchLoader,
        ImageFolderDataset,
    )
    from calm_vit_dte_tpu_torch.data.pipeline import make_cls_preprocess
    from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.tools._common import (
        launches_since,
        median_chain_s,
        peak_gib,
        reset_peak,
        sync,
    )
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.train.step import make_train_step
    from calm_vit_dte_tpu_torch.train.trainer import _DeviceFeed
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    cfg = get_config(config)
    size = cfg.image_size
    n_classes = cfg.model.out_features
    _, model = create_vit(config, seed=0, device=dev)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                        cfg.epochs, steps_per_epoch=1000)
    holder = {"state": create_train_state(model, tx, seed=1)}
    step_fn = make_train_step(cfg.model, tx, "cls", dtype=torch.bfloat16,
                              remat=False,
                              preprocess=make_cls_preprocess(n_classes,
                                                             cfg.crop))
    losses: list[torch.Tensor] = []

    def step(b):
        holder["state"], m = step_fn(holder["state"], b)
        losses.append(m["loss"].detach())

    # The synthetic resident batch (what a resident-batch bench times).
    rng = np.random.default_rng(0)
    syn = {"image": torch.from_numpy(rng.integers(
               0, 256, (batch, size, size, 3), dtype=np.uint8)).to(dev),
           "label": torch.from_numpy(rng.integers(
               0, n_classes, (batch,), dtype=np.int32)).to(dev)}
    reset_peak(dev)
    step(syn)   # warm-up: allocations, cuBLAS handles, kernel loads
    syn_s = median_chain_s(lambda: step(syn), dev, chains, steps)

    ds = ImageFolderDataset(root, split="train", size=size)
    sampler = ShardedSampler(len(ds), 1, 0, seed=0)

    # The loader alone (no device work): the pipe's ceiling.
    loader = BatchLoader(ds, sampler, batch, num_workers=cfg.num_workers)
    it = _epochs(loader, sampler)
    next(it)   # the workers spin up; not counted
    loader_s = median_chain_s(lambda: next(it), dev, chains, steps)
    it.close()

    # The loader from disk feeding the card through the trainer's feed:
    # the next batch pinned and copied on a side stream during the step.
    feed = _DeviceFeed(dev)
    it = _epochs(BatchLoader(ds, sampler, batch,
                             num_workers=cfg.num_workers), sampler)
    pending = {"batch": feed.put(next(it))}
    waited = []   # host seconds each step waited for the loader

    def disk_step():
        b = feed.ready(pending["batch"])
        t0 = time.perf_counter()
        host_batch = next(it)
        waited.append(time.perf_counter() - t0)
        pending["batch"] = feed.put(host_batch)
        step(b)

    disk_step()   # the first batch: not counted
    sync(dev)
    before = launch_counts()
    n0 = len(losses)
    waited.clear()
    real_s = median_chain_s(disk_step, dev, chains, steps)
    launches = launches_since(before)
    disk_steps = len(losses) - n0
    loss = torch.stack(losses).float().cpu()
    syn_ips, real_ips = batch / syn_s, batch / real_s
    return {"batch": batch, "steps": steps, "chains": chains,
            "synthetic_img_per_s": round(syn_ips, 1),
            "loader_only_img_per_s": round(batch / loader_s, 1),
            "real_loader_img_per_s": round(real_ips, 1),
            "ratio": round(real_ips / syn_ips, 3),
            "synthetic_ms_per_step": syn_s * 1e3,
            "real_loader_ms_per_step": real_s * 1e3,
            "real_loader_wait_ms_per_step": float(np.mean(waited)) * 1e3,
            "config": config, "remat": False, "dtype": "bfloat16",
            "losses_finite": bool(torch.isfinite(loss).all()),
            "peak_mem_gib": peak_gib(dev),
            "decoder": ds.decoder, "decoder_reason": ds.decoder_reason,
            "pillow_images": ds.pillow_images,
            "disk_steps": disk_steps,
            "kernel_launches": launches,
            "kernel_launches_per_step": {k: n / disk_steps
                                         for k, n in launches.items()}}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=512,
                    help="standalone decode sample size")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--skip-integrated", action="store_true",
                    help="standalone decode numbers only (no device step)")
    ap.add_argument("--n-train", type=int, default=2048,
                    help="the corpus's train images (val: a quarter)")
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=3,
                    help="standalone decode: best of this many passes")
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from calm_vit_dte_tpu_torch.data import native
    from calm_vit_dte_tpu_torch.data.corpus import make_corpus
    from calm_vit_dte_tpu_torch.tools._common import card, write_json
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    make_corpus(args.root, n_train=args.n_train, n_val=args.n_train // 4,
                num_classes=10, size=CORPUS_SIZE, mode="learnable", seed=12)
    size = get_config(args.config).image_size

    base = os.path.join(args.root, "train")
    paths = sorted(os.path.join(base, c, f) for c in sorted(os.listdir(base))
                   for f in sorted(os.listdir(os.path.join(base, c))))
    paths = paths[:args.images]
    cores = os.cpu_count() or 1
    result = {"host_cores": cores,
              "standalone": bench_standalone(paths, size, threads=[1, 2, 4],
                                             repeat=args.repeat)}
    print(result["standalone"], flush=True)

    if not args.skip_integrated:
        result["integrated"] = bench_integrated(
            args.root, args.batch, args.steps, args.config, dev,
            chains=args.chains)
        print({k: v for k, v in result["integrated"].items()
               if "launches" not in k}, flush=True)

        # Stall analysis: cores needed for the decode pool to match the
        # card's synthetic consumption rate.
        best_1t = max(result["standalone"].get("native_1t_img_per_s", 0.0),
                      result["standalone"]["pil_img_per_s"])
        syn = result["integrated"]["synthetic_img_per_s"]
        result["stall_analysis"] = {
            "per_core_decode_img_per_s": best_1t,
            "chip_demand_img_per_s": syn,
            "cores_needed_to_feed_chip": round(syn / best_1t, 1),
            "host_bound": result["integrated"]["ratio"] < 0.95,
        }
        print(result["stall_analysis"], flush=True)

    result.update(card=card(dev), device=dev.type,
                  torch=torch.__version__, native_libjpeg=native.libjpeg(),
                  corpus={"root": str(args.root), "n_train": args.n_train,
                          "mode": "learnable", "seed": 12,
                          "size": CORPUS_SIZE})
    write_json(args.out, "dataplane.json", result)
    integ = result.get("integrated")
    if integ is not None and not (
            integ["losses_finite"] and all(np.isfinite(
                [integ["synthetic_img_per_s"], integ["real_loader_img_per_s"],
                 integ["loader_only_img_per_s"]]))):
        raise SystemExit("dataplane: a loss or a rate is not finite")
    return result


if __name__ == "__main__":
    main()
