"""The trainer: data plane, model, optimizer, step, checkpoints.

JAX counterpart: calm_vit_dte_tpu/train/trainer.py, in the same order:
sampler and loader, the model from `init_seed` (optional warm start),
AdamW with the config's schedule, the train state and its restore, the
on-device preprocessing, the step, a SIGTERM flag that checkpoints and
returns, and the epoch loop (restarted at `step // steps_per_epoch` on
resume) with a checkpoint, the epoch-stats line and, for `reg`, sample PNGs
at each epoch's end. Workload parity with the reference trainers:
per-epoch sampler reshuffle with seed 2006, bf16 compute, AdamW(3.1e-3, wd
0.02, betas .9/.98), clip 1.0, per-epoch cosine to 1e-6, chief-only logging
every 100 steps.

Host to device: the next uint8 batch is pinned and copied on a side stream
while the current step runs (the JAX prefetch's counterpart); the step's
stream waits for the copy before it reads the batch.

Left out, having no single-card counterpart: the multi-host init, the
persistent compilation cache and the compile barrier (JAX :59-139), and the
mesh: `mesh_model` other than 1 raises until the parallel slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import signal
import time

import numpy as np
import torch

from calm_vit_dte_tpu_torch.data.loader import (
    BatchLoader,
    ImageFolderDataset,
    SyntheticDataset,
)
from calm_vit_dte_tpu_torch.data.pipeline import (
    make_cls_preprocess,
    make_reg_preprocess,
)
from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)
from calm_vit_dte_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    warm_start_params,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.samples import save_samples
from calm_vit_dte_tpu_torch.train.state import TrainState, create_train_state
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TrainConfig
from calm_vit_dte_tpu_torch.utils.device import resolve_device
from calm_vit_dte_tpu_torch.utils.logging import MetricLogger, is_chief


def build_dataset(cfg: TrainConfig, split: str = "train"):
    if cfg.dataset_root == "synthetic" or not os.path.isdir(cfg.dataset_root):
        if cfg.dataset_root != "synthetic" and is_chief():
            print(f"dataset root {cfg.dataset_root} not found; "
                  "falling back to synthetic data", flush=True)
        return SyntheticDataset(n=max(4 * cfg.global_batch_size, 1024),
                                num_classes=cfg.model.out_features
                                if cfg.task == "cls" else 1000,
                                size=cfg.image_size)
    return ImageFolderDataset(cfg.dataset_root, split=split,
                              size=cfg.image_size)


class _DeviceFeed:
    """Moves host batches to the device. On the card: pinned, copied on a
    side stream; `ready` makes the current stream wait for the copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, host_batch: dict | None) -> dict | None:
        if host_batch is None:
            return None
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in host_batch.items()}
        if self.stream is None:
            return {k: v.to(self.device) for k, v in tensors.items()}
        with torch.cuda.stream(self.stream):
            return {k: v.pin_memory().to(self.device, non_blocking=True)
                    for k, v in tensors.items()}

    def ready(self, batch: dict) -> dict:
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for v in batch.values():
                v.record_stream(current)
        return batch


def train(cfg: TrainConfig, max_steps: int | None = None,
          device: str | torch.device = "cuda") -> TrainState:
    """Train `cfg` for its epochs (or `max_steps` steps) on `device`,
    resuming from `cfg.checkpoint_dir` when it holds a checkpoint. Returns
    the final state."""
    dev = resolve_device(device)
    if cfg.mesh_model != 1:
        raise NotImplementedError(
            f"mesh_model={cfg.mesh_model}: tensor parallelism is not ported "
            "yet; the port trains on one card (mesh_model=1)")
    dataset = build_dataset(cfg)
    sampler = ShardedSampler(len(dataset), 1, 0, seed=cfg.sampler_seed)
    loader = BatchLoader(dataset, sampler, cfg.global_batch_size,
                         num_workers=cfg.num_workers)
    steps_per_epoch = max(1, loader.steps_per_epoch())

    _, model = create_vit(cfg.name, seed=cfg.init_seed, device=dev,
                          **dataclasses.asdict(cfg.model))
    if cfg.warm_start:
        try:
            warm_start_params(cfg.warm_start, model)
            if is_chief():
                print(f"warm-started from {cfg.warm_start}", flush=True)
        except (OSError, RuntimeError, ValueError) as e:
            if is_chief():   # the reference's try/except warm start
                print(f"no warm start ({e}); training fresh", flush=True)

    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                        cfg.epochs, steps_per_epoch, cfg.clip_norm,
                        cfg.eta_min, schedule=cfg.schedule,
                        lr_step_size=cfg.lr_step_size,
                        lr_gamma=cfg.lr_gamma,
                        decoupled_wd=cfg.decoupled_wd)
    state = create_train_state(model, tx, seed=cfg.init_seed + 1)
    if restore_checkpoint(cfg.checkpoint_dir, state) is not None \
            and is_chief():
        print(f"resumed from step {state.step}", flush=True)

    preprocess = (make_cls_preprocess(cfg.model.out_features, cfg.crop)
                  if cfg.task == "cls" else make_reg_preprocess(cfg.crop))
    step_fn = make_train_step(cfg.model, tx, cfg.task, dtype=torch.bfloat16,
                              remat=cfg.remat, preprocess=preprocess,
                              microbatches=cfg.microbatch)

    # Preemption: checkpoint on SIGTERM, then return cleanly.
    stop_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        stop_requested["flag"] = True

    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous = None   # not the main thread: no handler
    try:
        return _loop(cfg, state, step_fn, loader, sampler, steps_per_epoch,
                     max_steps, stop_requested, _DeviceFeed(dev))
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _loop(cfg, state, step_fn, loader, sampler, steps_per_epoch, max_steps,
          stop_requested, feed) -> TrainState:
    logger = MetricLogger(cfg.log_every)
    start_epoch = state.step // steps_per_epoch
    total = 0
    t_start = time.time()
    last_batch = None
    for epoch in range(start_epoch, cfg.epochs):
        sampler.set_epoch(epoch)
        epoch_t0 = time.time()
        epoch_tick0 = len(logger.step_times)
        it = iter(loader)
        batch = feed.put(next(it, None))
        i = 0
        metrics = None
        while batch is not None:
            batch = feed.ready(batch)
            # The next copy is issued before the step, so it overlaps the
            # step's kernels.
            next_batch = feed.put(next(it, None))
            state, metrics = step_fn(state, batch)
            last_batch, batch = batch, next_batch
            logger.tick()
            logger.log(epoch, i, metrics)
            i += 1
            total += 1
            if stop_requested["flag"]:
                save_checkpoint(cfg.checkpoint_dir, state)
                if is_chief():
                    print(f"SIGTERM: checkpointed at step {state.step}; "
                          "exiting", flush=True)
                return state
            if max_steps is not None and total >= max_steps:
                break
        save_checkpoint(cfg.checkpoint_dir, state)
        if is_chief():
            print(f"checkpoint saved at step {state.step}", flush=True)
            if cfg.epoch_stats_path:
                _write_epoch_stats(cfg, logger, epoch, i, epoch_t0,
                                   epoch_tick0, metrics)
            if (cfg.task == "reg" and cfg.save_samples_dir
                    and last_batch is not None):
                _dump_samples(cfg, state, last_batch)
        if max_steps is not None and total >= max_steps:
            break
    if is_chief():
        p50 = logger.p50_step_time()
        p50 = p50 if p50 else float("nan")
        print(f"Time taken: {time.time() - t_start:.1f}s, p50 step: "
              f"{p50:.4f}s, {cfg.global_batch_size / p50:.2f} images/s at "
              "p50", flush=True)
    return state


def _write_epoch_stats(cfg: TrainConfig, logger: MetricLogger, epoch: int,
                       steps: int, epoch_t0: float, epoch_tick0: int,
                       metrics) -> None:
    """One JSONL line per epoch boundary: timing, throughput, peak RSS."""
    wall = time.time() - epoch_t0
    times = logger.step_times[epoch_tick0:]
    p50 = float(np.percentile(times, 50)) if times else None
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    row = {
        "epoch": epoch,
        "steps": steps,
        "wall_s": round(wall, 2),
        "p50_step_s": round(p50, 4) if p50 is not None else None,
        "steps_per_s": round(steps / wall, 4) if wall > 0 else None,
        "img_per_s": round(steps * cfg.global_batch_size / wall, 1)
        if wall > 0 else None,
        "rss_mb": round(rss_mb, 1),
        "loss": float(metrics["loss"]) if metrics else None,
        "ts": time.time(),
    }
    with open(cfg.epoch_stats_path, "a") as f:
        f.write(json.dumps(row) + "\n")


@torch.no_grad()
def _dump_samples(cfg: TrainConfig, state: TrainState, batch: dict) -> None:
    """The eval-normalized bf16 forward (the function the eval step runs) on
    the batch, augmented with a generator seeded 0, written as PNGs."""
    model = state.model
    gen = torch.Generator(state.device).manual_seed(0)
    proc = make_reg_preprocess(cfg.crop)(gen, batch)
    was_training = model.training
    model.eval()
    try:
        with prenormalized_scope(normalize_tree(model, training=False)):
            tokens, _ = model(proc["image"], dtype=torch.bfloat16)
    finally:
        model.train(was_training)
    save_samples(tokens, cfg.save_samples_dir)
