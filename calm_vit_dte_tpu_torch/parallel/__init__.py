"""Data and tensor parallelism over torch.distributed (JAX counterpart:
calm_vit_dte_tpu/parallel)."""

from calm_vit_dte_tpu_torch.parallel.mesh import (
    Mesh,
    batch_shard,
    host_local_batch_size,
    make_mesh,
    param_shardings,
)

__all__ = [
    "Mesh",
    "batch_shard",
    "host_local_batch_size",
    "make_mesh",
    "param_shardings",
]
