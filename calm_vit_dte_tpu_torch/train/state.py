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

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

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
