"""Model factory: build a ViT by config name from a seed.

JAX counterpart: calm_vit_dte_tpu/models/factory.py. Weights are drawn from
a torch.Generator seeded with `seed` on the CPU, so a seed gives the same
model on every device; then the model moves to `device`. Loading a .pth or
a checkpoint directory is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from calm_vit_dte_tpu_torch.models.vit import ViT, ViTConfig
from calm_vit_dte_tpu_torch.utils.configs import get_config
from calm_vit_dte_tpu_torch.utils.device import resolve_device


def create_vit(config_name: str = "imagenet-cls-224", seed: int = 0,
               device: str | torch.device = "cuda",
               **model_overrides) -> tuple[ViTConfig, ViT]:
    """Returns (ViTConfig, ViT in eval mode on `device`)."""
    dev = resolve_device(device)
    cfg = get_config(config_name).model
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    model = ViT(cfg, torch.Generator().manual_seed(seed))
    return cfg, model.eval().to(dev)
