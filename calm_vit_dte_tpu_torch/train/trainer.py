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

Across processes (torchrun: one process a card with NCCL, or processes on
the CPU with gloo), the counterparts of the JAX trainer's :59-168:
  * multi-host init: `maybe_init_distributed` reads torchrun's RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. Where the JAX
    trainer goes on single-process after a failed init, this one raises:
    N processes that each believe they are alone would train N models and
    overwrite each other's checkpoints;
  * the persistent compilation cache: each host's local rank 0 builds the
    CUDA kernels while its other ranks wait (`kernels/_build.py`);
  * the compile barrier: a barrier before the first step;
  * the mesh: `make_mesh(model=cfg.mesh_model)`; the sampler shards over
    the data ranks and each rank loads `global_batch_size // D` rows; the
    initial state (fresh, warm-started or restored) is rank 0's on every
    rank, then each rank keeps its tensor-parallel shards
    (`train.state.place_state`);
  * the SIGTERM flag is agreed by all ranks each step, so every rank
    enters the checkpoint's collective at the same step.
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
import torch.distributed as dist

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
from calm_vit_dte_tpu_torch.kernels import _build
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)
from calm_vit_dte_tpu_torch.parallel.mesh import (
    any_rank,
    host_local_batch_size,
    make_mesh,
)
from calm_vit_dte_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    warm_start_params,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.samples import save_samples
from calm_vit_dte_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    full_weights,
    place_state,
)
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TrainConfig
from calm_vit_dte_tpu_torch.utils.device import resolve_device
from calm_vit_dte_tpu_torch.utils.logging import MetricLogger, is_chief
from calm_vit_dte_tpu_torch.utils.profiling import launch_counts


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


def maybe_init_distributed(device: torch.device) -> torch.device:
    """Join the torch.distributed world torchrun describes in the
    environment (NCCL on `cuda:LOCAL_RANK`, gloo on the CPU) and return
    this rank's device; without WORLD_SIZE, return `device` and stay one
    process. An init that fails raises."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    try:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", world_size=int(env["WORLD_SIZE"]),
            rank=int(env["RANK"]))
    except (KeyError, RuntimeError, ValueError) as exc:
        raise RuntimeError(
            f"torch.distributed init failed ({exc!r}); not training as a "
            "single process, which would write the checkpoints of the "
            "others") from exc
    return device


def train(cfg: TrainConfig, max_steps: int | None = None,
          device: str | torch.device = "cuda") -> TrainState:
    """Train `cfg` for its epochs (or `max_steps` steps) on `device`,
    resuming from `cfg.checkpoint_dir` when it holds a checkpoint. Returns
    the final state (this rank's, under torchrun)."""
    dev = maybe_init_distributed(resolve_device(device))
    mesh = make_mesh(model=cfg.mesh_model)
    if dev.type == "cuda" and dist.is_initialized():
        _build.build_once_per_host(_build.sources())
    dataset = build_dataset(cfg)
    sampler = ShardedSampler(len(dataset), mesh.data, mesh.data_rank,
                             seed=cfg.sampler_seed)
    loader = BatchLoader(dataset, sampler,
                         host_local_batch_size(cfg.global_batch_size, mesh),
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
    place_state(state, mesh, cfg.tp_min_shard_dim)

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
    if dist.is_initialized():
        dist.barrier()    # every rank enters the first step together
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
        launches0 = launch_counts()
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
            stop = stop_requested["flag"]
            if state.mesh is not None:   # agreed, so all ranks save
                stop = any_rank(stop, state.device)
            if stop:
                save_checkpoint(cfg.checkpoint_dir, state)
                if is_chief():
                    print(f"SIGTERM: checkpointed at step {state.step}; "
                          "exiting", flush=True)
                return state
            if max_steps is not None and total >= max_steps:
                break
        save_checkpoint(cfg.checkpoint_dir, state)
        dump = (cfg.task == "reg" and cfg.save_samples_dir
                and last_batch is not None)
        # The full weights for the samples: a collective under TP.
        weights = full_weights(state) if dump else None
        if is_chief():
            print(f"checkpoint saved at step {state.step}", flush=True)
            if cfg.epoch_stats_path:
                _write_epoch_stats(cfg, logger, epoch, i, epoch_t0,
                                   epoch_tick0, metrics, launches0)
            if dump:
                _dump_samples(cfg, state, last_batch, weights)
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
                       metrics, launches0: dict[str, int]) -> None:
    """One JSONL line per epoch boundary: timing, throughput, peak RSS, and
    the kernels this process launched in the epoch."""
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
        "kernel_launches": {k: n - launches0[k] for k, n in
                            launch_counts().items() if n > launches0[k]},
        "ts": time.time(),
    }
    with open(cfg.epoch_stats_path, "a") as f:
        f.write(json.dumps(row) + "\n")


@torch.no_grad()
def _dump_samples(cfg: TrainConfig, state: TrainState, batch: dict,
                  weights: dict | None = None) -> None:
    """The eval-normalized bf16 forward (the function the eval step runs) on
    the batch, augmented with a generator seeded 0, written as PNGs.
    `weights`: the full weights of a tensor-parallel state
    (`full_weights`)."""
    model = state.model
    gen = torch.Generator(state.device).manual_seed(0)
    proc = make_reg_preprocess(cfg.crop)(gen, batch)
    was_training = model.training
    model.eval()
    try:
        with prenormalized_scope(normalize_tree(model, training=False,
                                                weights=weights)):
            tokens, _ = model(proc["image"], dtype=torch.bfloat16)
    finally:
        model.train(was_training)
    save_samples(tokens, cfg.save_samples_dir)
