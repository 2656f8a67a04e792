"""1-D rotary position embedding with learned frequencies.

JAX counterpart: calm_vit_dte_tpu/ops/rope.py. The reference's RoPE is always
learned (inv_freq is a parameter) and rebuilds cos/sin each forward:
  inv_freq[i] = theta ** (-2i / dim)
  emb = concat(outer(arange(S), inv_freq)) twice;  cos/sin in fp32
  out = x * cos(emb) + rotate_half(x) * sin(emb),  rotate_half = [-x2, x1]
"""

from __future__ import annotations

import torch
from torch import nn


class RoPE(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        if dim % 2 != 0:
            raise ValueError(
                f"RoPE dim must be even, got {dim}; CALM-ViT requires "
                "stage_dim % (4 * heads) == 0 at every stage")
        self.inv_freq = nn.Parameter(
            1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                             / dim)))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_tables(inv_freq: torch.Tensor,
                seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (seq_len, dim), fp32."""
    t = torch.arange(seq_len, dtype=torch.float32, device=inv_freq.device)
    freqs = torch.outer(t, inv_freq.float())
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin in x's dtype (tables cast to it)."""
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


def rope_apply(inv_freq: torch.Tensor, x: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """x: (..., seq, dim) with seq on axis -2; rotation runs in `dtype`."""
    cos, sin = rope_tables(inv_freq, x.shape[-2])
    return rope_rotate(x.to(dtype), cos, sin)
