"""The (data, model) process mesh, the tensor-parallel layout and the
collectives of the data-parallel and tensor-parallel step.

JAX counterpart: calm_vit_dte_tpu/parallel/mesh.py. There a jax Mesh and
GSPMD partition one jitted step; here each process is one rank of a
torch.distributed world (torchrun: NCCL on the cards, gloo on the CPU), and
the step calls the few collectives it needs itself:

  data   the batch's axis. Rank r's rows of the global batch are the
         r-th of D equal slices; the gradients and metrics are averaged
         over the D data ranks once per step.
  model  the tensor-parallel axis (`mesh_model`, 1 by default). A weight
         the rule shards (`_spec_for_param`) is stored as its rows of the
         output axis, with its AdamW moments, on its model rank only; the
         step gathers it to full once per step in the spectral-norm
         pre-pass and keeps its rows of the full gradient, averaged over
         the data ranks. This divides the training state's memory by M,
         not the matmul FLOPs: every model rank of a data group runs the
         same rows with the full weights. The replicated parameters'
         gradients (and the metrics) are averaged over the whole world:
         the model ranks computed them from the same rows, equal only up
         to the card's kernels that are not deterministic run to run, and
         the mean keeps every rank's replicated parameters bit for bit
         equal.

Global rank g = d * M + m, the model axis innermost, as JAX's
`create_device_mesh((data, model))` lays out its devices.

Randomness follows the JAX step, where every draw has the global batch's
shape: inside `batch_shard(mesh)` a per-row draw of b rows draws D * b and
keeps this data rank's rows (`local_rows`), and the CutMix/MixUp partner
of a rank's first row is the previous data rank's last row
(`previous_rows`). With one data rank both run the single-process code.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

SHARDED_LEAF = "weight_orig"   # the JAX package's `w` (compat/from_jax.py)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) mesh over the torch.distributed
    world. `data_group` holds the ranks with this rank's model index (the
    gradients' all-reduce), `model_group` those with its data index (the
    shards' gather); each is None where its axis has size 1."""
    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The mesh over the initialized torch.distributed world (one process
    when none is). Every rank must call it, in the same order: it creates
    the axes' process groups."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None:
        data = world // model if model >= 1 else 0
    if model < 1 or data < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} (mesh_model={model}) does "
                         f"not cover the {world} process(es) of the world")
    data_group = model_group = None
    if data > 1:
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = group
    if model > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = group
    return Mesh(data, model, rank, data_group, model_group)


def host_local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """This rank's rows of the global batch (the ranks of one data group
    load the same rows)."""
    if global_batch_size % mesh.data:
        raise ValueError(f"global batch {global_batch_size} does not split "
                         f"over {mesh.data} data ranks")
    return global_batch_size // mesh.data


# ---------------------------------------------------------------- layout

def _spec_for_param(name: str, shape, min_shard_dim: int = 512) -> tuple:
    """The tensor-parallel rule: a spectral-normed weight (the JAX leaf
    `w`, the port's `weight_orig`) of rank >= 2 whose output axis is at
    least `min_shard_dim` is sharded on that axis over 'model'; everything
    else (biases, norms, u/v, small weights) is replicated. With model=1
    the layout degenerates to full replication."""
    if (name.rsplit(".", 1)[-1] == SHARDED_LEAF and len(shape) >= 2
            and shape[0] >= min_shard_dim):
        return ("model",) + (None,) * (len(shape) - 1)
    return ()


def param_shardings(model: torch.nn.Module,
                    min_shard_dim: int = 512) -> dict[str, tuple]:
    """{parameter name: spec} under the rule: ("model", None, ...) for a
    sharded weight, () for a replicated one."""
    return {name: _spec_for_param(name, p.shape, min_shard_dim)
            for name, p in model.named_parameters()}


def _rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.model:
        raise ValueError(f"output axis {n} does not split over "
                         f"{mesh.model} model ranks")
    per = n // mesh.model
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def shard_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's rows of `full` (a copy)."""
    return full[_rows(mesh, full.shape[0])].clone()


# ----------------------------------------------------------- collectives

def _staged(fn: Callable[[torch.Tensor], None], t: torch.Tensor,
            group) -> None:
    """Run the in-place collective `fn` on `t`. gloo takes CUDA tensors
    for some collectives only (not all_gather), so on a gloo group a CUDA
    tensor goes through host memory, for every collective alike."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        fn(host)
        t.copy_(host)
    else:
        fn(t)


def all_reduce_(t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (None: the world)."""
    _staged(lambda x: dist.all_reduce(x, op=op, group=group), t, group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast of `t` from global rank `src` to the world."""
    _staged(lambda x: dist.broadcast(x, src=src), t, None)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` (same shape on every rank of `group`), in the
    group's rank order, on `t`'s device."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def gather_rows(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full tensor of a row-sharded one: the model ranks' shards
    concatenated on dim 0."""
    return torch.cat(all_gather(shard.detach(), mesh.model_group))


def any_rank(flag: bool, device: torch.device) -> bool:
    """True on every rank when `flag` is true on any rank of the world."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_(t, op=dist.ReduceOp.MAX).item() > 0)


def average_(tensors: list[torch.Tensor], group, n: int
             ) -> list[torch.Tensor]:
    """The mean of each tensor over the `n` ranks of `group` (None: the
    world), through one all-reduce of a flat fp32 buffer. Returns new
    tensors shaped as the inputs."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    all_reduce_(flat, group).div_(n)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


# ------------------------------------------------------ global-batch draws

_BATCH_SHARD: ContextVar[Mesh | None] = ContextVar("batch_shard",
                                                   default=None)


@contextmanager
def batch_shard(mesh: Mesh | None):
    """Scope in which per-row draws and the CutMix/MixUp partner follow the
    global batch of `mesh`'s data axis (nothing changes for one data
    rank)."""
    token = _BATCH_SHARD.set(mesh if mesh is not None and mesh.data > 1
                             else None)
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def local_rows(draw: Callable[[int], torch.Tensor], rows: int
               ) -> torch.Tensor:
    """`draw(n)` draws n rows. Alone: draw(rows). Inside `batch_shard`:
    the global batch's D * rows, of which this data rank keeps its own,
    so every rank's rows are the single-process draw's."""
    mesh = _BATCH_SHARD.get()
    if mesh is None:
        return draw(rows)
    full = draw(mesh.data * rows)
    return full[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]


def previous_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch rolled by one row, this rank's rows: alone,
    torch.roll(x, 1, 0); inside `batch_shard`, the first row is the
    previous data rank's last (the last rank's for rank 0)."""
    mesh = _BATCH_SHARD.get()
    if mesh is None:
        return torch.roll(x, 1, 0)
    lasts = all_gather(x[-1:], mesh.data_group)
    return torch.cat([lasts[(mesh.data_rank - 1) % mesh.data], x[:-1]])
