"""Torch-default initializer distributions, drawn from an explicit
torch.Generator.

JAX counterpart: calm_vit_dte_tpu/nn/init.py. The reference relies on PyTorch
default inits (kaiming_uniform with a=sqrt(5), i.e. U(-1/sqrt(fan_in), +), and
the same bound for biases) and on unit-norm Gaussian u/v for spectral norm.
The distributions match the JAX package; the numbers do not (different
generators), so parity tests carry weights across instead.
"""

from __future__ import annotations

import math

import torch


def kaiming_uniform(shape: tuple[int, ...], fan_in: int,
                    generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_(w, a=sqrt(5)): U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def bias_uniform(shape: tuple[int, ...], fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """torch Linear/Conv bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return kaiming_uniform(shape, fan_in, generator)


def normalized_normal(shape: tuple[int, ...], generator: torch.Generator,
                      eps: float = 1e-12) -> torch.Tensor:
    """Unit-norm Gaussian vector (torch spectral_norm u/v init)."""
    v = torch.randn(shape, generator=generator)
    return v / (torch.linalg.vector_norm(v) + eps)
