"""Spectral-normalized linear layer, torch (out, in) weight layout.

JAX counterpart: calm_vit_dte_tpu/nn/linear.py. Parameters live in fp32;
the product runs in the requested compute dtype, as under torch autocast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch.nn import init as vinit
from calm_vit_dte_tpu_torch.nn.spectral_norm import SpectralNormed


class SNLinear(SpectralNormed):
    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 generator: torch.Generator):
        super().__init__(vinit.kaiming_uniform((out_dim, in_dim), in_dim,
                                               generator), generator)
        self.bias = (nn.Parameter(vinit.bias_uniform((out_dim,), in_dim,
                                                     generator))
                     if bias else None)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x @ (W/sigma)^T (+ b) over the last axis, in `dtype`."""
        dtype = dtype or x.dtype
        w = self.normalized_weight().to(dtype)
        y = F.linear(x.to(dtype), w)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y

    def seq(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """The same weight applied over the sequence (-2) axis:
        (B, S, D) -> (B, out, D) (the JAX package's `_sn_seq`)."""
        dtype = dtype or x.dtype
        return torch.matmul(self.normalized_weight().to(dtype), x.to(dtype))
