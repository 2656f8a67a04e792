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
    """Every field of the JAX package's TrainConfig, with its defaults.
    `mesh_model` and `tp_min_shard_dim` lay out a run over several ranks
    (parallel/mesh.py): the model axis's size and the smallest output axis
    it shards."""
    name: str
    model: ViTConfig
    task: str  # 'cls' | 'reg'
    global_batch_size: int
    epochs: int
    lr: float = 3.1e-3
    weight_decay: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.98
    clip_norm: float = 1.0
    eta_min: float = 1e-6
    kl_weight: float = 0.1
    sampler_seed: int = 2006          # reference DistributedSampler seed
    init_seed: int = 0
    image_size: int = 256             # host decode/resize target
    crop: int = 224
    dataset_root: str = "/dataset/imagenet"
    checkpoint_dir: str = "checkpoints"
    warm_start: str | None = None     # optional reference .pth
    log_every: int = 100              # reference rank-0 print cadence
    num_workers: int = 5
    save_samples_dir: str | None = None
    remat: bool = True                # activation checkpointing in backprop
    schedule: str = "cosine-epoch"    # or 'steplr' (single-node run)
    lr_step_size: int = 5             # StepLR step_size (epochs)
    lr_gamma: float = 0.1             # StepLR gamma
    decoupled_wd: bool = True         # AdamW; False = torch Adam coupled L2
    microbatch: int = 1               # grad-accumulation splits per step
    mesh_model: int = 1               # tensor-parallel axis size
    tp_min_shard_dim: int = 512       # smallest weight dim sharded under TP
    epoch_stats_path: str = ""        # one JSONL line per epoch (p50,
                                      # steps/s, RSS)


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
    epochs=2, image_size=56, crop=48, dataset_root="synthetic",
    log_every=10, remat=False))

_register(TrainConfig(
    name="tiny-reg",
    model=replace(TINY_VIT, out_features=144, generate=True),
    task="reg", global_batch_size=16, epochs=2, image_size=56, crop=48,
    dataset_root="synthetic", log_every=10, remat=False))

# The flagship: ImageNet-1k 224px classification (42.58M parameters).
_register(TrainConfig(
    name="imagenet-cls-224", model=_vit_224(False, 1000), task="cls",
    global_batch_size=1936, epochs=65))

_register(TrainConfig(
    name="imagenet-reg-224", model=_vit_224(True, 672), task="reg",
    global_batch_size=1824, epochs=65, save_samples_dir="samples"))

# The reference's single-node hyperparameters (CALM_ViT_V2.py:151-152, 183,
# 186): torch Adam with COUPLED L2 and betas (0.9, 0.999), StepLR(5, 0.1),
# batch 100, 5 epochs.
_register(TrainConfig(
    name="single-node-cls", model=_vit_224(False, 1000), task="cls",
    global_batch_size=100, epochs=5, beta2=0.999, schedule="steplr",
    lr_step_size=5, lr_gamma=0.1, decoupled_wd=False))

# EncoderDecoder_8 at its 256px defaults (Vi_Tools_CNN_less_V2.py:407-421).
_register(TrainConfig(
    name="imagenet-cls-256",
    model=ViTConfig(heads=12, seq_length=256, in_features=768, dim_step=48,
                    mean_var_hidden=192, seq_len_step=16, seq_len_reduce=128,
                    out_features=1000, force_reduce=False, generate=False),
    task="cls", global_batch_size=1536, epochs=65, image_size=292, crop=256))

# 1024px classification (935.57M parameters): axial attention at S=1024,
# head dims up to 256. Its attention runs the hires kernels
# (kernels/hires_attention.py); one 80 GB card holds its training state.
_register(TrainConfig(
    name="hires-cls-1024",
    model=ViTConfig(heads=12, seq_length=1024, in_features=3072,
                    dim_step=192, mean_var_hidden=768, seq_len_step=64,
                    seq_len_reduce=256, out_features=1000,
                    force_reduce=False, generate=False),
    task="cls", global_batch_size=64, epochs=65, image_size=1168,
    crop=1024))


def get_config(name: str, **overrides) -> TrainConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
