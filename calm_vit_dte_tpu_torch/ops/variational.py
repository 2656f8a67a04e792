"""Variational (reparameterized Gaussian) bottleneck primitives, in fp32.

JAX counterpart: calm_vit_dte_tpu/ops/variational.py. sigma is parameterized
directly: sigma = softplus(raw) + 1e-6; z = mu + eps * sigma in training
(eps ~ N(0, 1)), z = mu at eval;
KL = -0.5 * mean(1 + 2 log sigma - mu^2 - sigma^2).

Noise comes from an explicit torch.Generator on the tensor's device, or from
an injected source (`noise_override`, the JAX package's hook of the same
name): torch's and JAX's generators never agree at equal seeds, so the
parity tests feed both packages the same numpy noise. Under data
parallelism every draw has the global batch's shape, as under GSPMD.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.parallel.mesh import local_rows
from calm_vit_dte_tpu_torch.utils.remat import replayed

_NOISE_OVERRIDE: ContextVar[Callable | None] = ContextVar(
    "variational_noise_override", default=None)
_KEEP_MASK_OVERRIDE: ContextVar[Callable | None] = ContextVar(
    "dropout_keep_mask_override", default=None)


@contextmanager
def noise_override(normal: Callable | None = None,
                   keep_mask: Callable | None = None):
    """Scope in which `reparameterize` takes its noise from normal(shape)
    and `dropout` its keep-mask from keep_mask(shape) (arrays or tensors of
    that shape) instead of a generator."""
    tokens = (_NOISE_OVERRIDE.set(normal), _KEEP_MASK_OVERRIDE.set(keep_mask))
    try:
        yield
    finally:
        _NOISE_OVERRIDE.reset(tokens[0])
        _KEEP_MASK_OVERRIDE.reset(tokens[1])


def _draw(override: Callable | None, shape, device, generator, sample):
    """Noise of `shape` (batch first). Under data parallelism
    (parallel.mesh.batch_shard) the draw, injected or sampled, has the
    global batch's shape and this rank keeps its rows, as in the JAX
    step."""
    if override is None and generator is None:
        raise ValueError("training-mode sampling requires a torch.Generator "
                         "on the tensor's device (or noise_override)")

    def draw(rows):
        full = (rows, *shape[1:])
        if override is not None:
            return torch.as_tensor(override(full), dtype=torch.float32,
                                   device=device)
        return sample(torch.empty(full, dtype=torch.float32, device=device))

    return local_rows(draw, shape[0])


def softplus_var(var_raw: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.softplus(var_raw.float()) + eps


def reparameterize(mean: torch.Tensor, var: torch.Tensor, *, training: bool,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """z = mean + eps * var when training (eps ~ N(0,1)), else mean; fp32."""
    mean = mean.float()
    if not training:
        return mean
    noise = replayed(lambda: _draw(
        _NOISE_OVERRIDE.get(), var.shape, var.device, generator,
        lambda t: t.normal_(generator=generator)))
    return mean + noise * var


def dropout(x: torch.Tensor, p: float, *, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout, x * keep_mask / (1 - p), with the mask drawn from
    `generator` (or injected through `noise_override`)."""
    if p <= 0.0 or not training:
        return x
    keep = 1.0 - p
    mask = replayed(lambda: _draw(
        _KEEP_MASK_OVERRIDE.get(), x.shape, x.device, generator,
        lambda t: t.bernoulli_(keep, generator=generator)))
    return x * mask.to(x.dtype) / keep


def kl_divergence(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Reference KL with sigma parameterization: scalar fp32."""
    mean = mean.float()
    var = var.float()
    return -0.5 * torch.mean(1.0 + 2.0 * torch.log(var) - mean.square()
                             - var.square())
