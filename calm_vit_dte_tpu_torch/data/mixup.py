"""Batch-level CutMix / MixUp on the device.

JAX counterpart: calm_vit_dte_tpu/data/mixup.py. The reference uses
torchvision v2 CutMix(num_classes=1000, alpha=1.0) and MixUp(num_classes=
1000, alpha=0.8) under RandomChoice in its collate_fn
(distributed_trainer_cls.py:58-61):
  * each batch applies exactly one of the two, chosen uniformly;
  * the partner is the batch rolled by 1;
  * MixUp: x = lam*x + (1-lam)*roll(x), labels mixed the same way;
  * CutMix: a box (centre uniform over the image, half-extent sqrt(1-lam)/2
    of each side, clipped) is pasted from the rolled batch, and lam is
    recomputed from the clipped box's area;
  * lam ~ Beta(alpha, alpha).

Draws and arithmetic are split as in data/augment.py. The batch-level draws
(choice, lam, r_x, r_y) are host scalars from numpy's Beta and integer
samplers, seeded from the torch.Generator's seed (torch has no Beta sampler
that takes a generator), so the step needs no device sync for them; the
arithmetic runs in fp32 on the images' device, with the box's integers and
lam computed in fp32 as the JAX package computes them. Under data
parallelism (parallel.mesh.batch_shard) the partner is the global batch
rolled by 1: a rank's first row pairs with the previous rank's last.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.parallel.mesh import previous_rows


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    if labels.dim() == 2:
        return labels.float()  # already soft
    return F.one_hot(labels.long(), num_classes).float()


def draw_mix_params(generator: torch.Generator, height: int, width: int,
                    mixup_alpha: float = 0.8,
                    cutmix_alpha: float = 1.0) -> dict:
    """{'cutmix': bool, 'lam': float, 'r_x': int, 'r_y': int} for one batch
    (r_x, r_y only for CutMix)."""
    rng = np.random.default_rng(generator.initial_seed())
    if rng.random() < 0.5:
        return {"cutmix": True, "lam": float(rng.beta(cutmix_alpha,
                                                       cutmix_alpha)),
                "r_x": int(rng.integers(0, width)),
                "r_y": int(rng.integers(0, height))}
    return {"cutmix": False, "lam": float(rng.beta(mixup_alpha, mixup_alpha))}


def mixup(images: torch.Tensor, labels1h: torch.Tensor, lam: float):
    lam_t = torch.tensor(lam, dtype=torch.float32, device=images.device)
    mixed = lam_t * images + (1.0 - lam_t) * previous_rows(images)
    mixed_y = lam_t * labels1h + (1.0 - lam_t) * previous_rows(labels1h)
    return mixed, mixed_y


def cutmix(images: torch.Tensor, labels1h: torch.Tensor, lam: float,
           r_x: int, r_y: int):
    _, h, w, _ = images.shape
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    half_w = int(np.floor(ratio * np.float32(w) / np.float32(2)))
    half_h = int(np.floor(ratio * np.float32(h) / np.float32(2)))
    x1, x2 = np.clip(r_x - half_w, 0, w), np.clip(r_x + half_w, 0, w)
    y1, y2 = np.clip(r_y - half_h, 0, h), np.clip(r_y + half_h, 0, h)
    mixed = images.clone()
    mixed[:, y1:y2, x1:x2, :] = previous_rows(images)[:, y1:y2, x1:x2, :]
    lam_adj = np.float32(1.0) - np.float32((x2 - x1) * (y2 - y1)) / \
        np.float32(w * h)
    lam_t = torch.tensor(float(lam_adj), dtype=torch.float32,
                         device=images.device)
    mixed_y = lam_t * labels1h + (1.0 - lam_t) * previous_rows(labels1h)
    return mixed, mixed_y


def apply_mix(images: torch.Tensor, labels: torch.Tensor, num_classes: int,
              params: dict):
    """CutMix or MixUp as `params` (from `draw_mix_params`) says. Returns
    (images, soft labels (B, num_classes))."""
    labels1h = _one_hot(labels, num_classes)
    if params["cutmix"]:
        return cutmix(images, labels1h, params["lam"], params["r_x"],
                      params["r_y"])
    return mixup(images, labels1h, params["lam"])


def cutmix_or_mixup(generator: torch.Generator, images: torch.Tensor,
                    labels: torch.Tensor, num_classes: int,
                    mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0):
    """RandomChoice([CutMix, MixUp]) per batch. Returns (images, soft
    labels)."""
    _, h, w, _ = images.shape
    return apply_mix(images, labels, num_classes,
                     draw_mix_params(generator, h, w, mixup_alpha,
                                     cutmix_alpha))
