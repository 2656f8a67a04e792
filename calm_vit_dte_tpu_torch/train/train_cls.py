"""Classification training entry point: the reference's
distributed_trainer_cls.py.

    python -m calm_vit_dte_tpu_torch.train.train_cls \
        [--config imagenet-cls-224] [--max-steps N] [--device cuda|cpu] \
        [key=value ...]
    torchrun --nproc_per_node=N -m calm_vit_dte_tpu_torch.train.train_cls \
        [--device cpu] [mesh_model=M] ...

Under torchrun each process is one rank: NCCL on cuda:LOCAL_RANK, or gloo
with `--device cpu`; `mesh_model=M` shards the large weights over M ranks
(parallel/mesh.py).

`key=value` pairs override TrainConfig fields (e.g. global_batch_size=128
dataset_root=synthetic). CALM_CONV_FUSED=1 trains the conv residual through
its fused kernels, with the backward route of CALM_CONV_BWD (pallas or
xla); see models/block.py.

JAX counterpart: calm_vit_dte_tpu/train/train_cls.py.
"""

from __future__ import annotations

import argparse
from contextlib import contextmanager

import torch.distributed as dist

from calm_vit_dte_tpu_torch.train.state import TrainState
from calm_vit_dte_tpu_torch.train.trainer import train
from calm_vit_dte_tpu_torch.utils.configs import get_config


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv: list[str] | None = None,
         default_config: str = "imagenet-cls-224") -> TrainState:
    """Parse `argv` (sys.argv[1:] when None) and train; returns the final
    state, so a caller in the same process can inspect it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=default_config)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("overrides", nargs="*",
                    help="TrainConfig field overrides, key=value")
    args = ap.parse_args(argv)
    cfg = get_config(args.config, **_parse_overrides(args.overrides))
    with distributed_scope():
        return train(cfg, max_steps=args.max_steps, device=args.device)


@contextmanager
def distributed_scope():
    """Destroy on exit the process group the body initialized (a torchrun
    launch), and no other."""
    initialized = dist.is_initialized()
    try:
        yield
    finally:
        if not initialized and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
