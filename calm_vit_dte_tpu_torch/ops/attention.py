"""Scaled dot-product attention with a learned additive mask ("latent
masking").

JAX counterpart: calm_vit_dte_tpu/ops/attention.py. The per-head scores are
computed once; their sum over heads (== the reference's flattened-head
q k^T) feeds the mask MLP Linear(Skv, 2Skv) -> exact GELU -> Linear(2Skv,
Skv) over the key axis, whose output is added to every head's scaled scores
before an fp32 softmax. Scale is 1/sqrt(D).

`pick_route` chooses by shape, before anything is launched, in the order of
the JAX `_pick_impl` (:67-91):
  'rope'    — kernels/axial_attention.fused_rope_attention, which rotates
              and concatenates q, k in the kernel: every shape the rope
              kernels take (`axial_attention.refusal` is None: Sq == Skv <=
              256, D, Dv <= 64, bf16 with even Dc, Dv, shared memory), the
              flagship's;
  'hires'   — q, k rotated and concatenated in torch as the JAX fallback
              does (:330-338), then kernels/hires_attention:
              `fused_hires_attention` (forward saving residuals, two-pass
              backward) where autograd records, `fused_attention_forward`
              (no residuals) where it does not; every other shape with Sq
              == Skv in fp32 or bf16 (`hires_attention.refusal` is None: the
              kernels take any S, D and Dv), as the TPU takes its Pallas
              routes for every shape its tiles fit. Gradients reach the RoPE
              frequencies through torch autograd of the rotation;
  'chunked' — the JAX package's XLA route (`_attention_core`, :159-183, and
  'xla'       the `lax.map` over batch chunks under `jax.checkpoint`,
              :248-263) in torch ops, for the shapes no kernel takes: Sq !=
              Skv (as on the TPU, whose Pallas routes all need Sq == Skv) or
              a compute dtype other than fp32 and bf16. 'chunked' when the
              fp32 scores of the whole batch (B*H*Sq*Skv*4 bytes) would pass
              `AUTO_SCORE_BUDGET`, else 'xla', which is the same route with
              one chunk. It recomputes each chunk in the backward
              (`_RouteAttention`).
`attention_impl` forces a route for a scope ('auto' picks by shape); forcing
a kernel route on a shape its kernels refuse raises. The kernel routes
launch a CUDA kernel on a CUDA tensor (or raise) and run their plain
versions on a CPU tensor. 'chunked' and 'xla' are the JAX package's XLA
route in torch ops, the same on the card and on the CPU, taken only for the
shapes no kernel takes or when forced. `route_calls` counts their
forwards.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
from calm_vit_dte_tpu_torch.kernels.axial_attention import (
    attention_core as _attention_core,
    fused_rope_attention,
)
from calm_vit_dte_tpu_torch.kernels.hires_attention import (
    fused_attention_forward,
    fused_hires_attention,
)
from calm_vit_dte_tpu_torch.ops.rope import rope_apply, rope_tables
from calm_vit_dte_tpu_torch.utils.remat import replayed

__all__ = ["_attention_core", "attention_impl", "masked_attention",
           "masked_rope_attention", "pick_route", "route_calls",
           "route_core"]

MaskWeights = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
ROUTES = ("auto", "rope", "hires", "chunked", "xla")
# 'auto' takes 'chunked' over 'xla' when the fp32 score tensor of the whole
# batch would pass this many bytes (the JAX `_AUTO_SCORE_BUDGET`).
AUTO_SCORE_BUDGET = 1 << 28

# The dispatcher's limits, which chip_smoke.py phase 15 (a) and the tests
# drive: (what, the shape just inside, the shape just past, the route each
# takes, the dtypes), shapes (B, H, Sq, Skv, Dc, Dr, Dv) with Dr = 0 for q,
# k rotated already (`masked_attention`). Past a tensor-core hires kernel's
# limit a shape stays on the hires route (`hires_attention.family`, per
# pass): at bf16 D = Dv 264 every pass runs its wide tensor-core kernel; at
# bf16 S 1020 every pass runs the CUDA-core kernels; in fp32 D 264 is the
# first head the CUDA-core kernels split over the grid.
ROUTE_LIMITS = (
    ("rope Dv 64 -> 72", (2, 12, 224, 224, 32, 32, 64),
     (2, 12, 224, 224, 32, 32, 72), "rope", "hires", ("float32", "bfloat16")),
    ("hires D = Dv 256 -> 264", (2, 4, 1024, 1024, 256, 0, 256),
     (2, 4, 1024, 1024, 264, 0, 264), "hires", "hires",
     ("float32", "bfloat16")),
    ("hires bf16 S 1024 -> 1020", (2, 4, 1024, 1024, 256, 0, 256),
     (2, 4, 1020, 1020, 256, 0, 256), "hires", "hires", ("bfloat16",)),
    ("rope (Sq, Skv) (224, 224) -> (224, 256)", (2, 12, 224, 224, 28, 28, 56),
     (2, 12, 224, 256, 28, 28, 56), "rope", "xla", ("float32", "bfloat16")),
)

# A ContextVar, not a module global: the route must not leak across threads.
_ROUTE: ContextVar[tuple[str, int | None]] = ContextVar(
    "attention_impl", default=("auto", None))

# Forwards of the torch route by name; a remat replay adds nothing.
route_calls = {"chunked": 0, "xla": 0}


@contextmanager
def attention_impl(impl: str, chunk: int | None = None):
    """Force the attention route (one of ROUTES) for a scope; `chunk` is the
    batch chunk of 'chunked' (None: the budget's)."""
    if impl not in ROUTES:
        raise ValueError(f"attention route {impl!r}; expected one of "
                         f"{ROUTES}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk {chunk}: expected a positive batch chunk")
    token = _ROUTE.set((impl, chunk))
    try:
        yield
    finally:
        _ROUTE.reset(token)


def pick_route(b: int, h: int, sq: int, skv: int, d: int, dv: int, dtype, *,
               dr: int = 0, use_mask: bool = True) -> tuple[str, int | None]:
    """(route, chunk) for q, k (B,H,Sq|Skv,D) with D = Dc + Dr (Dr the rope
    half the rope kernel rotates; 0 for rotated q, k), v (B,H,Skv,Dv) and
    the compute dtype. chunk is None except on 'chunked'."""
    impl, chunk = _ROUTE.get()
    if sq != skv:
        why = {"rope": "Sq != Skv", "hires": "Sq != Skv"}
    else:
        why = {"rope": ka.refusal(sq, d - dr, dr, dv, dtype, use_mask),
               "hires": kh.refusal(sq, d, dv, dtype)}
    if impl == "auto":
        if why["rope"] is None:
            impl = "rope"
        elif why["hires"] is None:
            impl = "hires"
        elif b * h * sq * skv * 4 > AUTO_SCORE_BUDGET:
            impl = "chunked"
        else:
            impl = "xla"
    elif impl in why and why[impl] is not None:
        raise ValueError(f"attention route {impl!r} refuses (B={b}, H={h}, "
                         f"Sq={sq}, Skv={skv}, D={d}, Dv={dv}, {dtype}): "
                         f"{why[impl]}")
    if impl == "chunked" and chunk is None:
        chunk = max(1, AUTO_SCORE_BUDGET // (4 * h * sq * skv * 4))
        while b % chunk:
            chunk -= 1
    return impl, (chunk if impl == "chunked" else None)


def _mask_args(mask: MaskWeights | None, use_mask: bool):
    if not use_mask:
        return (None,) * 4
    if mask is None:
        raise ValueError("use_mask=True needs the mask MLP weights")
    return tuple(t.float() for t in mask)


def _prep(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype).contiguous()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in x's dtype. In fp32 torch's (the plain version's); in a
    narrower dtype the op sequence of `jax.nn.gelu(x, approximate=False)`,
    0.5 * x * erfc(-x * sqrt(0.5)) with sqrt(0.5) in that dtype, each op
    rounded to it, as the JAX package computes it on a bf16 array."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def route_core(q, k, v, w1, b1, w2, b2, *, scale: float, dtype,
               use_mask: bool) -> torch.Tensor:
    """The JAX `_attention_core` in torch ops, with its rounding: q, k (B,H,
    Sq|Skv,D); v (B,H,Skv,Dv); mask weights spectral-normalized. The score
    operands, the mask MLP's two products and biases, its GELU (`_gelu`)
    and P.V run in `dtype` (`preferred_element_type=dtype`), each op
    rounded to it as the JAX package's ops are when they run one by one;
    the scores and the softmax in fp32. In fp32 it is
    `axial_attention.attention_core` op for op; in bf16 that plain version
    keeps the mask MLP in fp32 instead. Returns (B,H,Sq,Dv) in `dtype`."""
    scores = q.to(dtype).float() @ k.to(dtype).float().transpose(-1, -2)
    logits = scores * scale
    if use_mask:
        ssum = scores.sum(dim=1).to(dtype)   # the flattened-head q k^T
        hmid = _gelu(ssum @ w1.to(dtype).T + b1.to(dtype))
        mask = hmid @ w2.to(dtype).T + b2.to(dtype)
        logits = logits + mask.float()[:, None]
    p = torch.softmax(logits, dim=-1)
    return p.to(dtype) @ v.to(dtype)


class _RouteAttention(torch.autograd.Function):
    """`route_core` over batch chunks, the JAX `jax.checkpoint` of each
    chunk: the forward keeps no graph and saves only its inputs; the
    backward recomputes each chunk with grad enabled and pulls its slice of
    g back through it, summing the mask weights' gradients over chunks."""

    @staticmethod
    def forward(ctx, route, chunk, scale, dtype, use_mask, q, k, v, w1, b1,
                w2, b2):
        kw = dict(scale=scale, dtype=dtype, use_mask=use_mask)

        def run():
            route_calls[route] += 1
            out = torch.empty((*q.shape[:3], v.shape[-1]), dtype=dtype,
                              device=v.device)
            for i in range(0, q.shape[0], chunk):
                sl = slice(i, i + chunk)
                out[sl] = route_core(q[sl], k[sl], v[sl], w1, b1, w2, b2,
                                     **kw)
            return out

        # Under activation checkpointing the replay takes the first run's
        # output (the JAX step's saved "attn_out").
        out = replayed(run)
        ctx.chunk, ctx.kw = chunk, kw
        ctx.save_for_backward(q, k, v, w1, b1, w2, b2)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, *w = ctx.saved_tensors
        need_qkv, need_w = ctx.needs_input_grad[5:8], ctx.needs_input_grad[8:]
        w = [None if t is None else t.detach().requires_grad_(n)
             for t, n in zip(w, need_w)]
        dqkv = [[] for _ in range(3)]
        dw = [None] * 4
        for i in range(0, q.shape[0], ctx.chunk):
            sl = slice(i, i + ctx.chunk)
            qkv = [t[sl].detach().requires_grad_(n)
                   for t, n in zip((q, k, v), need_qkv)]
            with torch.enable_grad():
                out = route_core(*qkv, *w, **ctx.kw)
            wanted = [t for t in (*qkv, *w)
                      if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted,
                                           g[sl].to(out.dtype)))
            for j, t in enumerate(qkv):
                if t.requires_grad:
                    dqkv[j].append(next(got))
            for j, t in enumerate(w):
                if t is not None and t.requires_grad:
                    gj = next(got)
                    dw[j] = gj if dw[j] is None else dw[j] + gj
        return (None,) * 5 + tuple(torch.cat(x) if x else None
                                   for x in dqkv) + tuple(dw)


def _route(q, k, v, mask, route: str, chunk: int | None, *, dtype,
           use_mask: bool) -> torch.Tensor:
    """The 'chunked' or 'xla' route on rotated q, k."""
    b = q.shape[0]
    chunk = b if route == "xla" else min(chunk, b)
    if b % chunk:
        raise ValueError(f"chunk {chunk} does not divide the batch {b}")
    return _RouteAttention.apply(route, chunk, 1.0 / math.sqrt(q.shape[-1]),
                                 dtype, use_mask, q, k, v,
                                 *_mask_args(mask, use_mask))


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
    """q, k: (B,H,Sq|Skv,D) already rotated; v: (B,H,Skv,Dv); mask: the
    normalized (w1, b1, w2, b2) or None. Returns (B,H,Sq,Dv) in `dtype`."""
    b, h, sq, d = q.shape
    route, chunk = pick_route(b, h, sq, k.shape[2], d, v.shape[-1], dtype,
                              use_mask=use_mask)
    if route == "hires":
        return _hires(q, k, v, mask, dtype=dtype, use_mask=use_mask)
    if route != "rope":
        return _route(q, k, v, mask, route, chunk, dtype=dtype,
                      use_mask=use_mask)
    return fused_rope_attention(
        _prep(q, dtype), None, _prep(k, dtype), None, _prep(v, dtype),
        None, None, None, None, *_mask_args(mask, use_mask),
        scale=1.0 / math.sqrt(d), dtype=dtype, use_mask=use_mask)


def masked_rope_attention(qc, qr, kc, kr, v, inv_freq_q: torch.Tensor,
                          inv_freq_k: torch.Tensor,
                          mask: MaskWeights | None, *, dtype,
                          use_mask: bool = True) -> torch.Tensor:
    """Attention on the PRE-rotation rope projections.

    qr, kr: (B,H,Sq|Skv,Dr) un-rotated rope halves; qc, kc: (B,H,Sq|Skv,Dc)
    content halves or None (full-dim rotation, the non-reduce VMLA layers);
    inv_freq_q/k: the learned RoPE frequencies. On the rope route the
    rotation and the content++rope concat happen inside the kernel on the
    card; on every other route in torch, before it.
    """
    b, h, sq, dr = qr.shape
    d = dr + (0 if qc is None else qc.shape[-1])
    route, chunk = pick_route(b, h, sq, kr.shape[2], d, v.shape[-1], dtype,
                              dr=dr, use_mask=use_mask)
    if route != "rope":
        q = rope_apply(inv_freq_q, qr, dtype)
        k = rope_apply(inv_freq_k, kr, dtype)
        if qc is not None:
            q = torch.cat([qc.to(dtype), q], dim=-1)
            k = torch.cat([kc.to(dtype), k], dim=-1)
        if route == "hires":
            return _hires(q, k, v, mask, dtype=dtype, use_mask=use_mask)
        return _route(q, k, v, mask, route, chunk, dtype=dtype,
                      use_mask=use_mask)
    cos_q, sin_q = rope_tables(inv_freq_q, sq)
    cos_k, sin_k = rope_tables(inv_freq_k, sq)
    return fused_rope_attention(
        _prep(qc, dtype), _prep(qr, dtype), _prep(kc, dtype),
        _prep(kr, dtype), _prep(v, dtype), cos_q, sin_q, cos_k, sin_k,
        *_mask_args(mask, use_mask), scale=1.0 / math.sqrt(d), dtype=dtype,
        use_mask=use_mask)
