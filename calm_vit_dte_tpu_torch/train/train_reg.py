"""Reconstruction training entry point: the reference's
distributed_trainer_reg.py.

    python -m calm_vit_dte_tpu_torch.train.train_reg [--config imagenet-reg-224]
    torchrun --nproc_per_node=N -m calm_vit_dte_tpu_torch.train.train_reg ...

Arguments, and the launch under torchrun, as for train_cls. JAX counterpart:
calm_vit_dte_tpu/train/train_reg.py.
"""

from __future__ import annotations

from calm_vit_dte_tpu_torch.train.train_cls import main

if __name__ == "__main__":
    main(default_config="imagenet-reg-224")
