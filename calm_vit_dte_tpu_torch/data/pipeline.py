"""Preprocessing callables (JAX counterpart:
calm_vit_dte_tpu/data/pipeline.py); this slice ports the eval one."""

from __future__ import annotations

from calm_vit_dte_tpu_torch.data.augment import eval_preprocess


def make_eval_preprocess(crop: int = 224):
    def preprocess(batch: dict) -> dict:
        return {"image": eval_preprocess(batch["image"], crop=crop)}

    return preprocess
