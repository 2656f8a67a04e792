"""Inference / serving entry point.

JAX counterpart: calm_vit_dte_tpu/serve.py. The Predictor
  * spectral-normalizes every weight ONCE at construction (eval-mode sigma
    from the stored u, v, torch's eval behaviour) and keeps it frozen;
  * takes raw uint8 images (B, H, W, 3); center crop + normalize run on the
    device;
  * runs the forward in `dtype` (bf16 by default) on `device` ("cuda" by
    default; raises without a card);
  * optionally serves int8 weights (quantize="int8": w8a8 dynamic,
    "int8-wo": w8a16 weight-only; see quantize.py);
  * answers classify() (top-k) and reconstruct() (sigmoid image);
  * save()/load() write and read the frozen (possibly quantized) weights
    as a serving artifact: `weights.pt` (torch.save) and `serving.json`.

    from calm_vit_dte_tpu_torch.serve import Predictor
    p = Predictor.from_checkpoint("checkpoints", "imagenet-cls-224")
    labels, probs = p.classify(images_u8)          # (B,256,256,3) uint8

CLI:  python -m calm_vit_dte_tpu_torch.serve --config tiny-cls --device cpu
      [--checkpoint DIR_OR_PTH] [--quantize int8|int8-wo]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np
import torch

from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.data.pipeline import make_eval_preprocess
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    SpectralNormed,
    freeze,
    normalize_tree,
)
from calm_vit_dte_tpu_torch.quantize import quantize_model
from calm_vit_dte_tpu_torch.train.checkpoint import restore_checkpoint
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.utils.configs import get_config

# Power iterations run on a fresh model before its eval weights are frozen
# (the JAX package's Predictor.fresh does the same): raw-init u vectors give
# sigma estimates far too small, and the unnormalized 24-layer forward
# overflows at flagship width.
WARMUP_POWER_ITERATIONS = 30

_QUANTIZE_MODES = (None, "int8", "int8-wo")
_SCHEMES = {"int8": "w8a8", "int8-wo": "w8a16"}
# The frozen tensors of a spectral-normed layer in a serving artifact: the
# eval weight, or the int8 weight and one of its scales.
_FROZEN = ("weight_frozen", "w_q", "w_s", "w_so")
_RAW = ("weight_orig", "weight_u", "weight_v")


def _check_quantize(quantize) -> None:
    if quantize not in _QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode: {quantize!r} "
                         f"(supported: {sorted(_SCHEMES)})")


def _serving_tree(model: ViT) -> dict[str, torch.Tensor]:
    """The frozen model as a flat {name: tensor} on the CPU: every state
    dict entry except the spectral-normed layers' raw weight and u/v, and
    each such layer's frozen eval weight (or int8 weight and scale)."""
    tree = {k: v for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] not in _RAW}
    for name, m in model.named_modules():
        if isinstance(m, SpectralNormed):
            for key in _FROZEN:
                t = getattr(m, key, None)
                if t is not None:
                    tree[f"{name}.{key}"] = t
    return {k: v.detach().cpu() for k, v in tree.items()}


def _install_tree(model: ViT, tree: dict[str, torch.Tensor]) -> None:
    """Load a serving tree into a model of the same config (the inverse of
    `_serving_tree`); raises on a missing or unexpected tensor."""
    tree = dict(tree)
    dev = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, SpectralNormed):
            found = [k for k in _FROZEN if f"{name}.{k}" in tree]
            if not found:
                raise KeyError(f"serving tree has no frozen weight for "
                               f"{name}")
            for key in found:
                setattr(m, key, tree.pop(f"{name}.{key}").to(dev))
    result = model.load_state_dict(tree, strict=False)
    missing = [k for k in result.missing_keys
               if k.rsplit(".", 1)[-1] not in _RAW]
    if missing or result.unexpected_keys:
        raise KeyError(f"serving tree does not fit the model: missing "
                       f"{missing}, unexpected {result.unexpected_keys}")


def _tree_fingerprint(tree: dict[str, torch.Tensor]) -> dict:
    """Element count plus a hash over the sorted (name, shape, dtype)
    triples, written to serving.json at save() and checked at load()."""
    h = hashlib.sha256()
    n = 0
    for name in sorted(tree):
        t = tree[name]
        n += t.numel()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
    return {"n_params": n, "tree_sha256": h.hexdigest()[:16]}


class Predictor:
    def __init__(self, model: ViT, crop: int = 224,
                 dtype: torch.dtype = torch.bfloat16,
                 config_name: str | None = None,
                 quantize: str | None = None, _prefrozen: bool = False):
        """Freezes the model's eval-mode weights, then quantizes them when
        `quantize` is "int8" (w8a8: int8 products with per-channel weight
        and per-token activation scales) or "int8-wo" (w8a16: int8 weights,
        activations in `dtype`). `_prefrozen`: the model already holds a
        restored serving tree (load())."""
        _check_quantize(quantize)
        self.model = model.eval()
        self.cfg = model.cfg
        self.crop = crop
        self.dtype = dtype
        self.config_name = config_name
        self.quantize = quantize
        self.device = next(model.parameters()).device
        if not _prefrozen:
            freeze(model)
            if quantize is not None:
                quantize_model(model, _SCHEMES[quantize])
        self._pre = make_eval_preprocess(crop)

    @classmethod
    def fresh(cls, config: str = "imagenet-cls-224", seed: int = 0,
              device: str | torch.device = "cuda",
              dtype: torch.dtype = torch.bfloat16,
              quantize: str | None = None) -> "Predictor":
        """A model initialized from `seed`, its spectral-norm power iteration
        converged before the eval weights are frozen."""
        _check_quantize(quantize)
        _, model = create_vit(config, seed=seed, device=device)
        with torch.no_grad():
            for _ in range(WARMUP_POWER_ITERATIONS):
                normalize_tree(model, training=True)
        return cls(model, crop=get_config(config).crop, dtype=dtype,
                   config_name=config, quantize=quantize)

    @classmethod
    def from_checkpoint(cls, source: str, config: str = "imagenet-cls-224",
                        quantize: str | None = None,
                        device: str | torch.device = "cuda",
                        dtype: torch.dtype = torch.bfloat16) -> "Predictor":
        """Serve trained weights. `source` is a checkpoint directory of the
        port's trainer (train/checkpoint.py, step_<n>.pt; the newest step)
        or a reference-format .pth state dict (as the JAX package's
        compat/torch_export.py writes it: unknown keys raise, missing ones
        keep their init, as the JAX importer allows)."""
        _check_quantize(quantize)
        _, model = create_vit(config, device=device)
        if source.endswith(".pth"):
            sd = torch.load(source, map_location="cpu", weights_only=True)
            result = model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
            if result.unexpected_keys:
                raise KeyError(f"{source}: keys the model does not have: "
                               f"{result.unexpected_keys}")
        elif os.path.isdir(source):
            state = create_train_state(model, make_optimizer(), seed=0)
            if restore_checkpoint(source, state) is None:
                if os.listdir(source):
                    raise ValueError(
                        f"{source} holds no step_<n>.pt checkpoint of this "
                        "package; Orbax checkpoint directories of the JAX "
                        "package cannot be read by the port yet")
                raise FileNotFoundError(f"no checkpoint under {source}")
            del state
        else:
            raise ValueError(f"unsupported weights source: {source}")
        return cls(model, crop=get_config(config).crop, dtype=dtype,
                   config_name=config, quantize=quantize)

    def save(self, path: str) -> None:
        """Write the serving artifact: the frozen (and, if set, quantized)
        weights to `<path>/weights.pt`, and `<path>/serving.json` with the
        quantize mode, crop, config, dtype and the weights' fingerprint.
        load() then skips normalizing and quantizing."""
        os.makedirs(path, exist_ok=True)
        tree = _serving_tree(self.model)
        torch.save(tree, os.path.join(path, "weights.pt"))
        meta = {"quantize": self.quantize, "crop": self.crop,
                "config": self.config_name,
                "dtype": str(self.dtype).removeprefix("torch.")}
        meta.update(_tree_fingerprint(tree))
        with open(os.path.join(path, "serving.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, config: str | None = None,
             device: str | torch.device = "cuda") -> "Predictor":
        """Restore an artifact written by save(). Config, dtype, quantize
        mode and crop come from its serving.json; `config`, if given, must
        match it (a mismatch raises here, not as a shape error later)."""
        with open(os.path.join(path, "serving.json")) as f:
            meta = json.load(f)
        saved = meta.get("config")
        if config is not None and saved is not None and config != saved:
            raise ValueError(f"serving artifact at {path} was saved from "
                             f"config {saved!r} but load() was asked for "
                             f"{config!r}")
        config = saved or config or "imagenet-cls-224"
        if meta.get("quantize") not in _QUANTIZE_MODES:
            raise ValueError(f"serving.json at {path} has invalid quantize "
                             f"mode {meta.get('quantize')!r} (expected one "
                             f"of {_QUANTIZE_MODES})")
        crop = meta.get("crop")
        if not (isinstance(crop, int) and crop > 0):
            raise ValueError(f"serving.json at {path} has invalid crop "
                             f"{crop!r} (expected positive int)")
        tree = torch.load(os.path.join(path, "weights.pt"),
                          map_location="cpu", weights_only=True)
        fp = _tree_fingerprint(tree)
        if fp != {k: meta.get(k) for k in fp}:
            raise ValueError(
                f"serving artifact at {path} does not match its "
                f"serving.json fingerprint: weights.pt has {fp['n_params']} "
                f"params / hash {fp['tree_sha256']}, the sidecar says "
                f"{meta.get('n_params')} / {meta.get('tree_sha256')}: "
                "artifact corrupted or hand-edited")
        _, model = create_vit(config, device=device)
        _install_tree(model, tree)
        return cls(model, crop=crop,
                   dtype=getattr(torch, meta.get("dtype", "bfloat16")),
                   config_name=config, quantize=meta["quantize"],
                   _prefrozen=True)

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
    ap.add_argument("--checkpoint", default=None,
                    help="a trainer checkpoint directory or a .pth")
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-wo"],
                    help="serve int8 weights: 'int8' = w8a8 dynamic, "
                         "'int8-wo' = w8a16 weight-only")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    cfg = get_config(args.config)
    dtype = getattr(torch, args.dtype)
    if args.checkpoint:
        p = Predictor.from_checkpoint(args.checkpoint, args.config,
                                      quantize=args.quantize,
                                      device=args.device, dtype=dtype)
    else:
        p = Predictor.fresh(args.config, seed=args.seed, device=args.device,
                            dtype=dtype, quantize=args.quantize)
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
