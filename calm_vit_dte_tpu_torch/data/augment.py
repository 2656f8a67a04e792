"""Eval preprocessing on the device: center crop + ImageNet normalize.

JAX counterpart: calm_vit_dte_tpu/data/augment.py::eval_preprocess (the
training augmentations are not ported yet).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def eval_preprocess(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, crop, crop, 3) fp32, normalized."""
    _, h, w, _ = images_u8.shape
    top = (h - crop) // 2
    left = (w - crop) // 2
    img = images_u8[:, top:top + crop, left:left + crop, :].float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std
