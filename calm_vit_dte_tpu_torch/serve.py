"""Inference / serving entry point.

JAX counterpart: calm_vit_dte_tpu/serve.py. The Predictor
  * spectral-normalizes every weight ONCE at construction (eval-mode sigma
    from the stored u, v, torch's eval behaviour) and keeps it frozen;
  * takes raw uint8 images (B, H, W, 3); center crop + normalize run on the
    device;
  * runs the forward in `dtype` (bf16 by default) on `device` ("cuda" by
    default; raises without a card);
  * answers classify() (top-k) and reconstruct() (sigmoid image).

    from calm_vit_dte_tpu_torch.serve import Predictor
    p = Predictor.fresh("imagenet-cls-224", seed=0)
    labels, probs = p.classify(images_u8)          # (B,256,256,3) uint8

CLI:  python -m calm_vit_dte_tpu_torch.serve --config tiny-cls --device cpu
Not ported yet: save/load of a serving artifact, from_checkpoint, int8.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.data.pipeline import make_eval_preprocess
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import freeze, normalize_tree
from calm_vit_dte_tpu_torch.utils.configs import get_config

# Power iterations run on a fresh model before its eval weights are frozen
# (the JAX package's Predictor.fresh does the same): raw-init u vectors give
# sigma estimates far too small, and the unnormalized 24-layer forward
# overflows at flagship width.
WARMUP_POWER_ITERATIONS = 30


class Predictor:
    def __init__(self, model: ViT, crop: int = 224,
                 dtype: torch.dtype = torch.bfloat16,
                 config_name: str | None = None):
        self.model = model.eval()
        self.cfg = model.cfg
        self.crop = crop
        self.dtype = dtype
        self.config_name = config_name
        self.device = next(model.parameters()).device
        freeze(model)
        self._pre = make_eval_preprocess(crop)

    @classmethod
    def fresh(cls, config: str = "imagenet-cls-224", seed: int = 0,
              device: str | torch.device = "cuda",
              dtype: torch.dtype = torch.bfloat16) -> "Predictor":
        """A model initialized from `seed`, its spectral-norm power iteration
        converged before the eval weights are frozen."""
        _, model = create_vit(config, seed=seed, device=device)
        with torch.no_grad():
            for _ in range(WARMUP_POWER_ITERATIONS):
                normalize_tree(model, training=True)
        return cls(model, crop=get_config(config).crop, dtype=dtype,
                   config_name=config)

    @classmethod
    def from_jax(cls, config: str, params: dict, sn_state: dict,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.bfloat16) -> "Predictor":
        """Serve the JAX package's (params, sn_state), as numpy pytrees."""
        _, model = create_vit(config, device=device)
        model.load_state_dict(state_dict_from_jax(params, sn_state))
        return cls(model, crop=get_config(config).crop, dtype=dtype,
                   config_name=config)

    @torch.no_grad()
    def predict(self, images_u8) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 -> (logits | image tokens, kl) on the device."""
        x = torch.as_tensor(images_u8).to(self.device)
        x = self._pre({"image": x})["image"]
        return self.model(x, dtype=self.dtype)

    def classify(self, images_u8, top_k: int = 5):
        """Returns (top-k labels (B,k), top-k probs (B,k)) as numpy, sorted
        by falling probability."""
        if self.cfg.generate:
            raise ValueError("generate-head model; use reconstruct()")
        logits, _ = self.predict(images_u8)
        probs, labels = torch.softmax(logits.float(), dim=-1).topk(top_k,
                                                                   dim=-1)
        return labels.cpu().numpy(), probs.cpu().numpy()

    def reconstruct(self, images_u8) -> np.ndarray:
        """Sigmoid'd reconstructions (B, S, S, 3) in [0, 1], numpy."""
        if not self.cfg.generate:
            raise ValueError("classification-head model; use classify()")
        tokens, _ = self.predict(images_u8)
        b, s, _ = tokens.shape
        return torch.sigmoid(tokens.float()).reshape(b, s, s, 3).cpu().numpy()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    cfg = get_config(args.config)
    p = Predictor.fresh(args.config, seed=args.seed, device=args.device,
                        dtype=getattr(torch, args.dtype))
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (args.batch, cfg.image_size, cfg.image_size,
                                 3), dtype=np.uint8)
    if cfg.model.generate:
        out = p.reconstruct(imgs)
        print(f"reconstructed {out.shape}, range "
              f"[{out.min():.3f}, {out.max():.3f}]")
    else:
        labels, _ = p.classify(imgs)
        print(f"top-5 labels for {args.batch} images:", labels[:2].tolist())


if __name__ == "__main__":
    main()
