"""Named configs: the port's own copy of the JAX package's.

JAX counterpart: calm_vit_dte_tpu/utils/configs.py (copied, since importing
it pulls in jax). Each config reproduces a hyperparameter set of the
reference; see the JAX module for the call sites each one cites.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from calm_vit_dte_tpu_torch.models.vit import ViTConfig


@dataclass(frozen=True)
class TrainConfig:
    """The fields this slice reads; the trainer's hyperparameters join when
    the trainer is ported."""
    name: str
    model: ViTConfig
    task: str  # 'cls' | 'reg'
    global_batch_size: int
    epochs: int
    image_size: int = 256             # host decode/resize target
    crop: int = 224


def _vit_224(generate: bool, out_features: int) -> ViTConfig:
    return ViTConfig(heads=12, seq_length=224, in_features=672, dim_step=48,
                     mean_var_hidden=240, seq_len_step=16, seq_len_reduce=80,
                     out_features=out_features, force_reduce=False,
                     generate=generate)


TINY_VIT = ViTConfig(heads=3, seq_length=48, in_features=144, dim_step=12,
                     mean_var_hidden=24, seq_len_step=4, seq_len_reduce=8,
                     out_features=10, generate=False)

CONFIGS: dict[str, TrainConfig] = {}


def _register(cfg: TrainConfig) -> TrainConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


_register(TrainConfig(
    name="tiny-cls", model=TINY_VIT, task="cls", global_batch_size=16,
    epochs=2, image_size=56, crop=48))

_register(TrainConfig(
    name="tiny-reg",
    model=replace(TINY_VIT, out_features=144, generate=True),
    task="reg", global_batch_size=16, epochs=2, image_size=56, crop=48))

# The flagship: ImageNet-1k 224px classification (42.58M parameters).
_register(TrainConfig(
    name="imagenet-cls-224", model=_vit_224(False, 1000), task="cls",
    global_batch_size=1936, epochs=65))

_register(TrainConfig(
    name="imagenet-reg-224", model=_vit_224(True, 672), task="reg",
    global_batch_size=1824, epochs=65))


def get_config(name: str, **overrides) -> TrainConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
