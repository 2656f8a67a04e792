"""Scaled dot-product attention with a learned additive mask ("latent
masking").

JAX counterpart: calm_vit_dte_tpu/ops/attention.py. The per-head scores are
computed once; their sum over heads (== the reference's flattened-head
q k^T) feeds the mask MLP Linear(S, 2S) -> exact GELU -> Linear(2S, S) over
the key axis, whose output is added to every head's scaled scores before an
fp32 softmax. Scale is 1/sqrt(D).

Dispatch picks a kernel by shape, with no TPU tile or VMEM logic (the JAX
`_pick_impl` at :67-91 and its `pallas_hires` branch at :224-236):
  'rope'  — kernels/axial_attention.fused_rope_attention, which rotates and
            concatenates q, k in the kernel: every shape within its limits
            (S <= 256, D <= 64, Dv <= 64), the flagship's;
  'hires' — q, k rotated and concatenated in torch as the JAX fallback does
            (:330-338), then kernels/hires_attention: `fused_hires_attention`
            (forward saving residuals, two-pass backward) where autograd
            records, `fused_attention_forward` (no residuals) where it does
            not. Gradients reach the RoPE frequencies through torch autograd
            of the rotation.
`attention_impl` forces a route for a scope ('auto' picks by shape). Both
routes launch a CUDA kernel on a CUDA tensor (or raise) and run the plain
versions on a CPU tensor; no route runs a plain version on the card.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar

import torch

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels.axial_attention import (
    attention_core as _attention_core,
    fused_rope_attention,
)
from calm_vit_dte_tpu_torch.kernels.hires_attention import (
    fused_attention_forward,
    fused_hires_attention,
)
from calm_vit_dte_tpu_torch.ops.rope import rope_apply, rope_tables

__all__ = ["_attention_core", "attention_impl", "masked_attention",
           "masked_rope_attention", "pick_route"]

MaskWeights = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
ROUTES = ("auto", "rope", "hires")
ROPE_MAX_D = 64   # the rope backward kernel's head-dim limit

# A ContextVar, not a module global: the route must not leak across threads.
_ROUTE: ContextVar[str] = ContextVar("attention_impl", default="auto")


@contextmanager
def attention_impl(impl: str):
    """Force the attention route ('auto', 'rope' or 'hires') for a scope."""
    if impl not in ROUTES:
        raise ValueError(f"attention route {impl!r}; expected one of "
                         f"{ROUTES}")
    token = _ROUTE.set(impl)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def pick_route(s: int, d: int, dv: int) -> str:
    """'rope' or 'hires' for sequence S, q/k head dim D and v head dim Dv."""
    route = _ROUTE.get()
    if route != "auto":
        return route
    fits = s <= ka.MAX_S and d <= ROPE_MAX_D and dv <= ka.MAX_DV
    return "rope" if fits else "hires"


def _mask_args(mask: MaskWeights | None, use_mask: bool):
    if not use_mask:
        return (None,) * 4
    if mask is None:
        raise ValueError("use_mask=True needs the mask MLP weights")
    return tuple(t.float() for t in mask)


def _prep(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype).contiguous()


def _hires(q, k, v, mask, *, dtype, use_mask) -> torch.Tensor:
    """The hires route on rotated q, k."""
    s = q.shape[2]
    w = _mask_args(mask, use_mask)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = _prep(q, dtype), _prep(k, dtype), _prep(v, dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, *w)):
        if not use_mask:   # the hires kernels always run the mask MLP
            z = q.new_zeros
            w = (z((2 * s, s), dtype=torch.float32),
                 z((2 * s,), dtype=torch.float32),
                 z((s, 2 * s), dtype=torch.float32),
                 z((s,), dtype=torch.float32))
        return fused_hires_attention(q, k, v, *w, scale=scale, dtype=dtype)
    return fused_attention_forward(q, k, v, *w, scale=scale, dtype=dtype,
                                   use_mask=use_mask)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: MaskWeights | None, *, dtype,
                     use_mask: bool = True) -> torch.Tensor:
    """q, k: (B,H,S,D) already rotated; v: (B,H,S,Dv); mask: the normalized
    (w1, b1, w2, b2) or None. Returns (B,H,S,Dv) in `dtype`."""
    if q.shape[2] != k.shape[2]:
        raise ValueError("axial attention needs Sq == Skv")
    if pick_route(q.shape[2], q.shape[-1], v.shape[-1]) == "hires":
        return _hires(q, k, v, mask, dtype=dtype, use_mask=use_mask)
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
    inv_freq_q/k: the learned RoPE frequencies. On the rope route the
    rotation and the content++rope concat happen inside the kernel on the
    card; on the hires route in torch, before the kernel.
    """
    s = qr.shape[2]
    if kr.shape[2] != s:
        raise ValueError("axial attention needs Sq == Skv")
    d = qr.shape[-1] + (0 if qc is None else qc.shape[-1])
    if pick_route(s, d, v.shape[-1]) == "hires":
        q = rope_apply(inv_freq_q, qr, dtype)
        k = rope_apply(inv_freq_k, kr, dtype)
        if qc is not None:
            q = torch.cat([qc.to(dtype), q], dim=-1)
            k = torch.cat([kc.to(dtype), k], dim=-1)
        return _hires(q, k, v, mask, dtype=dtype, use_mask=use_mask)
    cos_q, sin_q = rope_tables(inv_freq_q, s)
    cos_k, sin_k = rope_tables(inv_freq_k, s)
    return fused_rope_attention(
        _prep(qc, dtype), _prep(qr, dtype), _prep(kc, dtype),
        _prep(kr, dtype), _prep(v, dtype), cos_q, sin_q, cos_k, sin_k,
        *_mask_args(mask, use_mask), scale=1.0 / math.sqrt(d), dtype=dtype,
        use_mask=use_mask)
