"""Preprocessing callables for the train and eval steps.

JAX counterpart: calm_vit_dte_tpu/data/pipeline.py. Raw uint8 batches
cross from the host to the device; crop, jitter, blur, normalize and
CutMix/MixUp run there, at the start of the step
(`train/step.py::make_train_step`'s `preprocess(generator, batch)` hook).
"""

from __future__ import annotations

import torch

from calm_vit_dte_tpu_torch.data.augment import augment_batch, eval_preprocess
from calm_vit_dte_tpu_torch.data.mixup import cutmix_or_mixup


def make_cls_preprocess(num_classes: int, crop: int = 224):
    """Augment + CutMix/MixUp; returns {'image': f32, 'label': soft (B,C)}."""

    def preprocess(generator: torch.Generator, batch: dict) -> dict:
        img = augment_batch(generator, batch["image"], crop=crop)
        img, labels = cutmix_or_mixup(generator, img, batch["label"],
                                      num_classes)
        return {"image": img, "label": labels}

    return preprocess


def make_reg_preprocess(crop: int = 224):
    """Augment only: the reconstruction task has no mixup (reference
    distributed_trainer_reg.py:58)."""

    def preprocess(generator: torch.Generator, batch: dict) -> dict:
        return {"image": augment_batch(generator, batch["image"], crop=crop)}

    return preprocess


def make_eval_preprocess(crop: int = 224):
    """Center crop + normalize; `label` and `valid` (the padding mask of a
    `pad_last` loader) pass through when the batch has them."""

    def preprocess(batch: dict) -> dict:
        out = {"image": eval_preprocess(batch["image"], crop=crop)}
        for key in ("label", "valid"):
            if key in batch:
                out[key] = batch[key]
        return out

    return preprocess
