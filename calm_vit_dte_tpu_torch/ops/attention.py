"""Scaled dot-product attention with a learned additive mask ("latent
masking").

JAX counterpart: calm_vit_dte_tpu/ops/attention.py. The per-head scores are
computed once; their sum over heads (== the reference's flattened-head
q k^T) feeds the mask MLP Linear(S, 2S) -> exact GELU -> Linear(2S, S) over
the key axis, whose output is added to every head's scaled scores before an
fp32 softmax. Scale is 1/sqrt(D).

Dispatch has no TPU tile or VMEM logic: both entry points go through
kernels/axial_attention.fused_rope_attention, which launches the CUDA kernel
on a CUDA tensor and runs the plain version (`_attention_core` after an
explicit rotate/concat) on a CPU tensor. Both are differentiable in q, k, v,
the mask weights and, through `rope_tables`, the learned frequencies: the
backward is the wrapper's backward kernel (plain version on the CPU).
"""

from __future__ import annotations

import math

import torch

from calm_vit_dte_tpu_torch.kernels.axial_attention import (
    attention_core as _attention_core,
    fused_rope_attention,
)
from calm_vit_dte_tpu_torch.ops.rope import rope_tables

__all__ = ["_attention_core", "masked_attention", "masked_rope_attention"]

MaskWeights = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _mask_args(mask: MaskWeights | None, use_mask: bool):
    if not use_mask:
        return (None,) * 4
    if mask is None:
        raise ValueError("use_mask=True needs the mask MLP weights")
    return tuple(t.float() for t in mask)


def _prep(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype).contiguous()


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: MaskWeights | None, *, dtype,
                     use_mask: bool = True) -> torch.Tensor:
    """q, k: (B,H,S,D) already rotated; v: (B,H,S,Dv); mask: the normalized
    (w1, b1, w2, b2) or None. Returns (B,H,S,Dv) in `dtype`."""
    if q.shape[2] != k.shape[2]:
        raise ValueError("axial attention needs Sq == Skv")
    return fused_rope_attention(
        _prep(q, dtype), None, _prep(k, dtype), None, _prep(v, dtype),
        None, None, None, None, *_mask_args(mask, use_mask),
        scale=1.0 / math.sqrt(q.shape[-1]), dtype=dtype, use_mask=use_mask)


def masked_rope_attention(qc, qr, kc, kr, v, inv_freq_q: torch.Tensor,
                          inv_freq_k: torch.Tensor,
                          mask: MaskWeights | None, *, dtype,
                          use_mask: bool = True) -> torch.Tensor:
    """Attention on the PRE-rotation rope projections.

    qr, kr: (B,H,S,Dr) un-rotated rope halves; qc, kc: (B,H,S,Dc) content
    halves or None (full-dim rotation, the non-reduce VMLA layers);
    inv_freq_q/k: the learned RoPE frequencies. The rotation and the
    content++rope concat happen inside the kernel on the card.
    """
    s = qr.shape[2]
    if kr.shape[2] != s:
        raise ValueError("axial attention needs Sq == Skv")
    d = qr.shape[-1] + (0 if qc is None else qc.shape[-1])
    cos_q, sin_q = rope_tables(inv_freq_q, s)
    cos_k, sin_k = rope_tables(inv_freq_k, s)
    return fused_rope_attention(
        _prep(qc, dtype), _prep(qr, dtype), _prep(kc, dtype),
        _prep(kr, dtype), _prep(v, dtype), cos_q, sin_q, cos_k, sin_k,
        *_mask_args(mask, use_mask), scale=1.0 / math.sqrt(d), dtype=dtype,
        use_mask=use_mask)
