"""Top-1 evaluation over the validation split.

JAX counterpart: calm_vit_dte_tpu/train/evaluate.py (reference: the eval
branch of CALM_ViT_V2.py:227-240, whose unpacking of the model's
(logits, kl) tuple at :235 is fixed there and here). The model restored
from `cfg.checkpoint_dir` (or the fresh init from `cfg.init_seed`) is
frozen once into a serving Predictor, optionally int8-quantized; a
`pad_last` loader keeps every batch full while each image counts once.
Under torchrun each data rank evaluates its shard of the val split
(`global_batch_size // D` images a batch) and the counts are summed over
the data ranks (JAX evaluate.py:97-99).

    python -m calm_vit_dte_tpu_torch.train.evaluate --config imagenet-cls-224 \
        [--max-batches N] [--quantize int8|int8-wo] [--device cpu] \
        [key=value ...]
    torchrun --nproc_per_node=N -m calm_vit_dte_tpu_torch.train.evaluate ...
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from calm_vit_dte_tpu_torch.data.loader import BatchLoader
from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.parallel.mesh import (
    all_reduce_,
    host_local_batch_size,
    make_mesh,
)
from calm_vit_dte_tpu_torch.serve import Predictor
from calm_vit_dte_tpu_torch.train.checkpoint import restore_checkpoint
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.train.train_cls import (
    _parse_overrides,
    distributed_scope,
)
from calm_vit_dte_tpu_torch.train.trainer import (
    build_dataset,
    maybe_init_distributed,
)
from calm_vit_dte_tpu_torch.utils.configs import TrainConfig, get_config
from calm_vit_dte_tpu_torch.utils.device import resolve_device
from calm_vit_dte_tpu_torch.utils.logging import is_chief


def evaluate(cfg: TrainConfig, max_batches: int | None = None,
             quantize: str | None = None, stats_out: dict | None = None,
             device: str | torch.device = "cuda") -> float:
    """Top-1 accuracy over `cfg`'s val split, the forward in bf16.
    quantize='int8' / 'int8-wo' evaluates through the int8 serving weights
    (quantize.py): the top-1 serving users get. stats_out, if given, is
    filled with wall_s, images, img_per_s, loader_wait_s and device_s
    (seconds rounded to 0.01, the JAX function's keys) and exact_s, the
    same three times unrounded: {"wall", "loader_wait", "device"}."""
    dev = maybe_init_distributed(resolve_device(device))
    mesh = make_mesh(model=cfg.mesh_model)
    chief = is_chief()
    _, model = create_vit(cfg.name, seed=cfg.init_seed, device=dev,
                          **dataclasses.asdict(cfg.model))
    state = create_train_state(model, make_optimizer(cfg.lr, epochs=1,
                                                     steps_per_epoch=1),
                               seed=cfg.init_seed + 1)
    restored = restore_checkpoint(cfg.checkpoint_dir, state) is not None
    if chief and restored:
        print(f"evaluating checkpoint at step {state.step}", flush=True)
    elif chief:
        print("no checkpoint found; evaluating fresh init", flush=True)
    del state
    # Freeze the eval-mode weights once (what serving does), then quantize.
    predictor = Predictor(model.eval(), crop=cfg.crop, dtype=torch.bfloat16,
                          config_name=cfg.name, quantize=quantize)

    dataset = build_dataset(cfg, split="val")
    # Each data rank evaluates its shard; pad_last's valid mask counts
    # each image once over all of them.
    sampler = ShardedSampler(len(dataset), mesh.data, mesh.data_rank,
                             shuffle=False)
    loader = BatchLoader(dataset, sampler,
                         host_local_batch_size(cfg.global_batch_size, mesh),
                         num_workers=cfg.num_workers, pad_last=True)
    correct = total = 0
    loader_wait = device_s = 0.0
    t_start = time.time()
    it = iter(loader)
    for i in range(loader.steps_per_epoch()):
        t = time.time()
        batch = next(it)
        loader_wait += time.time() - t
        t = time.time()
        logits, _ = predictor.predict(batch["image"])
        # .cpu() waits for the card, so device_s holds the forward's device
        # time and not only its launches: keep a synchronising read-back.
        pred = logits.argmax(dim=-1).cpu()
        label = torch.from_numpy(batch["label"]).long()
        valid = torch.from_numpy(batch["valid"])
        device_s += time.time() - t
        correct += int(((pred == label) & valid).sum())
        total += int(valid.sum())
        if chief and i % 10 == 0:
            print(f"Batch {i}, Accuracy: {correct / max(total, 1) * 100}%",
                  flush=True)
        if max_batches is not None and i + 1 >= max_batches:
            break
    if mesh.data > 1:
        counts = torch.tensor([correct, total], dtype=torch.float64,
                              device=dev)
        correct, total = map(int, all_reduce_(counts,
                                              mesh.data_group).tolist())
    acc = correct / max(total, 1)
    if stats_out is not None:
        wall = time.time() - t_start
        stats_out.update(wall_s=round(wall, 2), images=total,
                         img_per_s=round(total / max(wall, 1e-9), 2),
                         loader_wait_s=round(loader_wait, 2),
                         device_s=round(device_s, 2),
                         exact_s={"wall": wall, "loader_wait": loader_wait,
                                  "device": device_s})
    if chief:
        print(f"top-1 accuracy: {acc * 100:.2f}% over {total} images",
              flush=True)
    return acc


def main(argv: list[str] | None = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-wo"],
                    help="evaluate through the int8 serving weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("overrides", nargs="*",
                    help="TrainConfig field overrides, key=value")
    args = ap.parse_args(argv)
    with distributed_scope():
        return evaluate(get_config(args.config,
                                   **_parse_overrides(args.overrides)),
                        max_batches=args.max_batches,
                        quantize=args.quantize, device=args.device)


if __name__ == "__main__":
    main()
