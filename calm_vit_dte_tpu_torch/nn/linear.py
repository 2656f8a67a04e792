"""Spectral-normalized linear layer, torch (out, in) weight layout.

JAX counterpart: calm_vit_dte_tpu/nn/linear.py. Parameters live in fp32;
the product runs in the requested compute dtype, as under torch autocast.
A layer that quantize.quantize_model has quantized holds int8 `w_q` with
its scales `w_s` (w8a8) or `w_so` (w8a16 weight-only) and runs the
quantized products (the JAX package's `"w_q" in params` branches).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch import quantize
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
        # Set by quantize.quantize_model; not part of the state dict.
        for name in ("w_q", "w_s", "w_so"):
            self.register_buffer(name, None, persistent=False)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x @ (W/sigma)^T (+ b) over the last axis, in `dtype`."""
        dtype = dtype or x.dtype
        if self.w_q is not None:
            if self.w_so is not None:
                return quantize.qdot_wo(x, self.w_q, self.w_so, self.bias,
                                        dtype=dtype)
            return quantize.qdot(x, self.w_q, self.w_s, self.bias,
                                 dtype=dtype)
        w = self.normalized_weight().to(dtype)
        y = F.linear(x.to(dtype), w)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y

    def seq(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """The same weight applied over the sequence (-2) axis:
        (B, S, D) -> (B, out, D) (the JAX package's `_sn_seq`)."""
        dtype = dtype or x.dtype
        if self.w_q is not None:
            if self.w_so is not None:
                return quantize.qdot_seq_wo(x, self.w_q, self.w_so,
                                            dtype=dtype)
            return quantize.qdot_seq(x, self.w_q, self.w_s, dtype=dtype)
        return torch.matmul(self.normalized_weight().to(dtype), x.to(dtype))
