"""Model factory: build a ViT by config name, from a seed or from weights.

JAX counterpart: calm_vit_dte_tpu/models/factory.py. Weights are drawn from
a torch.Generator seeded with `seed` on the CPU, so a seed gives the same
model on every device; then the model moves to `device`. `weights` then
replaces them, as the JAX factory's does:
  * a reference-format `.pth` state_dict (the original's names, as the JAX
    package's compat/torch_export.py writes it, or a state_dict of the
    port saved with torch.save): unknown keys raise, missing ones keep
    their init (the JAX importer's strictness);
  * a checkpoint directory: the newest `step_<n>.pt` of the port's trainer,
    or the JAX package's Orbax step directories (compat/orbax.py; reading
    them needs tensorstore). Parameters and spectral-norm u/v are restored,
    every one of them.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from calm_vit_dte_tpu_torch.models.vit import ViT, ViTConfig
from calm_vit_dte_tpu_torch.utils.configs import get_config
from calm_vit_dte_tpu_torch.utils.device import resolve_device


def create_vit(config_name: str = "imagenet-cls-224", seed: int = 0,
               device: str | torch.device = "cuda",
               weights: str | None = None,
               **model_overrides) -> tuple[ViTConfig, ViT]:
    """Returns (ViTConfig, ViT in eval mode on `device`). `weights`: None
    (the seed's init), a `.pth` path or a checkpoint directory."""
    dev = resolve_device(device)
    cfg = get_config(config_name).model
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    model = ViT(cfg, torch.Generator().manual_seed(seed))
    if weights is not None:
        _load_weights(model, weights)
    return cfg, model.eval().to(dev)


def _load_weights(model: ViT, weights: str) -> None:
    if weights.endswith(".pth"):
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        result = model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
        if result.unexpected_keys:
            raise KeyError(f"{weights}: keys the model does not have: "
                           f"{result.unexpected_keys}")
    elif os.path.isdir(weights):
        from calm_vit_dte_tpu_torch.train.checkpoint import model_state_dict

        sd = model_state_dict(weights)
        if sd is None:
            raise FileNotFoundError(f"no checkpoint under {weights}")
        model.load_state_dict(sd)
    else:
        raise ValueError(f"unsupported weights source: {weights}")
