"""Optimizer and LR schedules, matching the reference trainers.

JAX counterpart: calm_vit_dte_tpu/train/optim.py. AdamW(lr 3.1e-3, weight
decay 0.02, betas (0.9, 0.98), eps 1e-8) with global-norm clipping at 1.0 on
the pre-clip norm, cosine annealing to eta_min = 1e-6 stepped per epoch, and
the skip of steps whose gradients are not finite (all the reference's
GradScaler did under bf16). `schedule="steplr"` with `decoupled_wd=False`
reproduces the reference's single-node Adam with coupled L2 and StepLR(5, 0.1).

Like the JAX package's transformation, `FusedAdamW` holds only the
hyperparameters; the moments live in an `AdamWState` inside the TrainState.
One implementation over the parameter list (torch._foreach ops); `update`
changes the parameters and the state in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from calm_vit_dte_tpu_torch.parallel.mesh import all_reduce_

Schedule = Callable[[int], float]


def cosine_per_epoch_schedule(base_lr: float, epochs: int,
                              steps_per_epoch: int,
                              eta_min: float = 1e-6) -> Schedule:
    """torch CosineAnnealingLR(T_max=epochs) stepped once per epoch:
    lr(step) = eta_min + (base - eta_min) * (1 + cos(pi*epoch/T_max)) / 2."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / epochs))

    return schedule


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     step_size: int = 5, gamma: float = 0.1) -> Schedule:
    """torch StepLR stepped once per epoch:
    lr(step) = base * gamma^(epoch // step_size)."""

    def schedule(step: int) -> float:
        return base_lr * gamma ** ((step // steps_per_epoch) // step_size)

    return schedule


@dataclass
class AdamWState:
    count: int                  # applied steps (bias correction and LR)
    notfinite: int              # consecutive skipped steps
    gnorm: torch.Tensor | float  # last pre-clip global gradient norm
    mu: list[torch.Tensor]      # first moments, one per parameter
    nu: list[torch.Tensor]      # second moments


class FusedAdamW:
    """Global-norm clip + Adam(W) + skip of non-finite steps as one update.

    Element for element the JAX package's `_fused_flat_adamw`: trigger-style
    clip scaling, bias-corrected moments with the applied-step count (a
    skipped step advances neither the count nor the schedule), decoupled
    weight decay (or coupled L2 added to the clipped gradient), and the raw
    update let through once `max_consecutive_errors` steps in a row were
    skipped, so a persistent NaN surfaces. Moment math is fp32; only their
    storage rounds to `moment_dtype`.
    """

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float, skip_nonfinite: bool,
                 decoupled_wd: bool = True, moment_dtype=torch.float32,
                 max_consecutive_errors: int = 100):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite
        self.decoupled_wd = decoupled_wd
        self.moment_dtype = moment_dtype
        self.max_consecutive_errors = max_consecutive_errors

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        def zeros():
            return [torch.zeros_like(p, dtype=self.moment_dtype)
                    for p in params]

        return AdamWState(count=0, notfinite=0, gnorm=0.0, mu=zeros(),
                          nu=zeros())

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamWState, sharded: list[bool] | None = None,
               mesh=None) -> None:
        """One step, in place on `params` and `state`: the clip's global
        norm, then `apply`. Under tensor parallelism (`mesh.model` > 1)
        `sharded` marks the parameters that are this rank's rows of a
        sharded weight: the clip's global norm counts their squares over
        the model ranks and every replicated parameter's once, the same
        value on every rank."""
        grads = [g.float() for g in grads]
        state.gnorm = self.global_norm(grads, sharded, mesh)
        self.apply(params, grads, state, float(state.gnorm))   # host sync

    @torch.no_grad()
    def global_norm(self, grads: list[torch.Tensor],
                    sharded: list[bool] | None = None,
                    mesh=None) -> torch.Tensor:
        """The pre-clip global norm of fp32 `grads` (see `update`)."""
        norms = torch.stack(torch._foreach_norm(grads))
        if mesh is None or mesh.model == 1:
            return torch.linalg.vector_norm(norms)
        is_shard = torch.tensor(sharded, device=norms.device)
        sq = torch.where(is_shard, norms.square(),
                         norms.square() / mesh.model).sum()
        return all_reduce_(sq, mesh.model_group).sqrt()

    @torch.no_grad()
    def apply(self, params: list[torch.Tensor], grads: list[torch.Tensor],
              state: AdamWState, gn: float) -> None:
        """The step after the norm: skip a non-finite `gn`, else clip fp32
        `grads` by it and update the moments and `params` in place."""
        if (self.skip_nonfinite and not math.isfinite(gn)
                and state.notfinite < self.max_consecutive_errors):
            state.notfinite += 1
            return
        state.notfinite = 0
        lr = self.schedule(state.count)
        state.count += 1
        t = state.count
        scale = 1.0 if gn < self.clip_norm else \
            self.clip_norm / max(gn, 1e-30)
        g = torch._foreach_mul(grads, scale)
        if not self.decoupled_wd:   # coupled L2, after the clip
            torch._foreach_add_(g, params, alpha=self.weight_decay)
        fp32 = self.moment_dtype == torch.float32
        mu = state.mu if fp32 else [m.float() for m in state.mu]
        nu = state.nu if fp32 else [n.float() for n in state.nu]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        if not fp32:
            for dst, src in zip(state.mu + state.nu, mu + nu):
                dst.copy_(src)
        # p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** t))
        torch._foreach_add_(denom, self.eps)
        if self.decoupled_wd:
            torch._foreach_mul_(params, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(params, mu, denom,
                                value=-lr / (1.0 - self.b1 ** t))


def make_optimizer(base_lr: float = 3.1e-3, weight_decay: float = 0.02,
                   b1: float = 0.9, b2: float = 0.98, epochs: int = 65,
                   steps_per_epoch: int = 1000, clip_norm: float = 1.0,
                   eta_min: float = 1e-6, skip_nonfinite: bool = True, *,
                   schedule: str = "cosine-epoch", lr_step_size: int = 5,
                   lr_gamma: float = 0.1, decoupled_wd: bool = True,
                   moment_dtype=torch.float32) -> FusedAdamW:
    """The JAX package's `make_optimizer`, without its `flatten` switch (a
    TPU op-count fix)."""
    if schedule == "steplr":
        sched = step_lr_schedule(base_lr, steps_per_epoch, lr_step_size,
                                 lr_gamma)
    elif schedule == "cosine-epoch":
        sched = cosine_per_epoch_schedule(base_lr, epochs, steps_per_epoch,
                                          eta_min)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return FusedAdamW(sched, b1, b2, 1e-8, weight_decay, clip_norm,
                      skip_nonfinite, decoupled_wd=decoupled_wd,
                      moment_dtype=moment_dtype)
