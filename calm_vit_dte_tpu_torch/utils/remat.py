"""Activation checkpointing that keeps chosen tensors across the replay.

JAX counterpart: the `jax.checkpoint(..., policy=save_only_these_names(
"attn_out", "conv_out"))` of calm_vit_dte_tpu/train/step.py.
`torch.utils.checkpoint` re-runs its whole segment in the backward pass,
which would launch the fused attention forward kernel a second time per
layer and draw fresh reparameterization noise. `checkpoint` here wraps it:
inside the segment, `replayed(compute)` computes and records a tensor on the
first run and hands the recorded tensor back, in order, on the replay. The
attention wrappers record their outputs that way (so the replay only
rebuilds the autograd graph around them; the long-sequence attention records
its output with its softmax and mask residuals, a tuple), and the
variational ops their noise and dropout masks (so the replay sees the first
run's draws).
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint


Recorded = TypeVar("Recorded", torch.Tensor, tuple)


def _detach(x):
    return tuple(t.detach() for t in x) if isinstance(x, tuple) \
        else x.detach()


class _Saved:
    def __init__(self):
        self.tensors: list = []
        self.recorded = False
        self.next = 0


_ACTIVE: _Saved | None = None


def replayed(compute: Callable[[], Recorded]) -> Recorded:
    """`compute()` outside a checkpointed segment and on its first run; the
    first run's result (detached aliases) on the replay. The result is a
    tensor or a tuple of tensors. Call it only from code that produces
    tensors autograd should treat as constants, or from inside an autograd
    Function's forward."""
    saved = _ACTIVE
    if saved is None:
        return compute()
    if saved.recorded:
        out = _detach(saved.tensors[saved.next])
        saved.next += 1
        return out
    out = compute()
    saved.tensors.append(_detach(out))
    return out


def checkpoint(fn: Callable, *args):
    """`fn(*args)` under non-reentrant activation checkpointing, with
    `replayed` tensors kept across the replay. `fn` must be a function of its
    arguments and module parameters only: anything it mutates is mutated
    again by the replay."""
    saved = _Saved()

    def segment(*a):
        global _ACTIVE
        previous, _ACTIVE = _ACTIVE, saved
        saved.next = 0
        try:
            out = fn(*a)
            saved.recorded = True
            return out
        finally:
            _ACTIVE = previous

    return _torch_checkpoint(segment, *args, use_reentrant=False)
