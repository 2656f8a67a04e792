"""Train state: the model (parameters and spectral-norm u/v buffers), the
optimizer state, the step counter and the base seed.

JAX counterpart: calm_vit_dte_tpu/train/state.py. The JAX state is an
immutable pytree that the step replaces; here the step updates the model and
the optimizer state in place and returns the same object. Sampling noise is
drawn from a generator seeded from (seed, step, stream), the counterpart of
`fold_in(state.rng, state.step)`: a run resumed at a step draws the noise
the uninterrupted run drew there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from calm_vit_dte_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_,
    gather_rows,
    param_shardings,
    shard_rows,
)
from calm_vit_dte_tpu_torch.train.optim import AdamWState, FusedAdamW


@dataclass
class TrainState:
    model: nn.Module
    opt_state: AdamWState
    step: int
    seed: int
    # The JAX PRNG key's data (two uint32) of a state that came from or goes
    # to an Orbax checkpoint of the JAX package (compat/orbax.py); the
    # port's noise comes from `seed`.
    jax_rng: list[int] | None = None
    # The mesh of a run over more than one rank (place_state); None alone.
    mesh: Mesh | None = None
    # {parameter name: full shape} of the weights this rank stores as its
    # model rank's rows, with their moments (tensor parallelism).
    sharded: dict[str, torch.Size] = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def generator(self, stream: int = 0) -> torch.Generator:
        """The generator of this step's noise stream `stream` (0: the model's
        noise; 1: preprocessing; 2 + i: microbatch i)."""
        seed = np.random.SeedSequence(
            [self.seed, self.step, stream]).generate_state(1, np.uint64)[0]
        return torch.Generator(self.device).manual_seed(int(seed))


def create_train_state(model: nn.Module, tx: FusedAdamW,
                       seed: int) -> TrainState:
    return TrainState(model=model, opt_state=tx.init(list(model.parameters())),
                      step=0, seed=seed)


def _broadcast(state: TrainState) -> None:
    """Every rank takes global rank 0's parameters, u/v, moments and
    counters (one broadcast per dtype)."""
    opt = state.opt_state
    tensors = [*state.model.state_dict().values(), *opt.mu, *opt.nu]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = broadcast_(torch.cat([t.reshape(-1) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))
    counters = broadcast_(torch.tensor(
        [state.step, state.seed, opt.count, opt.notfinite, float(opt.gnorm)],
        dtype=torch.float64, device=state.device)).tolist()
    state.step, state.seed, opt.count, opt.notfinite = map(int, counters[:4])
    opt.gnorm = torch.tensor(counters[4], device=state.device)


@torch.no_grad()
def place_state(state: TrainState, mesh: Mesh,
                min_shard_dim: int = 512) -> TrainState:
    """Make a full state this rank's part of a run over `mesh`, in place:
    global rank 0's state goes to every rank, then each weight that the
    tensor-parallel rule shards keeps this model rank's rows, and so do
    its moments (the JAX package's `state_shardings`). A mesh of one rank
    leaves the state as it is."""
    if mesh.size == 1:
        return state
    if state.sharded:
        raise ValueError("the state is already placed on a mesh")
    _broadcast(state)
    state.mesh = mesh
    if mesh.model == 1:
        return state
    opt = state.opt_state
    specs = param_shardings(state.model, min_shard_dim)
    for i, (name, p) in enumerate(state.model.named_parameters()):
        if specs[name]:
            state.sharded[name] = p.shape
            p.data = shard_rows(p.data, mesh)
            opt.mu[i] = shard_rows(opt.mu[i], mesh)
            opt.nu[i] = shard_rows(opt.nu[i], mesh)
    return state


def full_weights(state: TrainState) -> dict[nn.Module, torch.Tensor]:
    """{spectral-normed layer: its full raw weight}, gathered from the
    model ranks' rows, for each weight this rank stores sharded (a
    collective: every rank of the mesh calls it); {} when none is."""
    return {state.model.get_submodule(name.rsplit(".", 1)[0]):
            gather_rows(p, state.mesh)
            for name, p in state.model.named_parameters()
            if name in state.sharded}


def full_tensors(state: TrainState
                 ) -> tuple[dict[str, torch.Tensor], list, list]:
    """The full state_dict and moments (mu, nu) of the state, sharded
    weights gathered (a collective under tensor parallelism)."""
    opt = state.opt_state
    sd = state.model.state_dict()
    if not state.sharded:
        return sd, opt.mu, opt.nu
    names = [name for name, _ in state.model.named_parameters()]

    def full(name, t):
        return gather_rows(t, state.mesh) if name in state.sharded else t

    return ({k: full(k, v) for k, v in sd.items()},
            [full(n, m) for n, m in zip(names, opt.mu)],
            [full(n, v) for n, v in zip(names, opt.nu)])
