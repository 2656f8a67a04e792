"""Scale-only LayerNorm (eps 1e-6), always computed in fp32.

JAX counterpart: calm_vit_dte_tpu/nn/norm.py. The reference builds every
norm as LayerNorm(dim, eps=1e-6, bias=False); autocast keeps it in fp32.
"""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dtype = dtype or x.dtype
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight
        return y.to(dtype)
