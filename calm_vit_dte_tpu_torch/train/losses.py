"""Training losses, matching the reference trainers.

JAX counterpart: calm_vit_dte_tpu/train/losses.py. Classification: softmax
cross-entropy against CutMix/MixUp soft label distributions (the KL term is
discarded). Reconstruction: Huber(delta=1) between the reconstructed image
and the input, plus 0.1 * KL, compared in NHWC. All losses reduce in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """targets: soft label distribution (B, C) or int labels (B,)."""
    logits = logits.float()
    if targets.dim() == logits.dim() - 1:
        targets = F.one_hot(targets.long(), logits.shape[-1])
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(targets.float() * logp, dim=-1))


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """torch.nn.HuberLoss(delta, reduction='mean'), in fp32."""
    d = pred.float() - target.float()
    ad = d.abs()
    return torch.mean(torch.where(ad < delta, 0.5 * d * d,
                                  delta * (ad - 0.5 * delta)))


def reconstruction_loss(tokens: torch.Tensor, image_nhwc: torch.Tensor,
                        kl: torch.Tensor,
                        kl_weight: float = 0.1) -> torch.Tensor:
    """tokens: (B, S, 3S) model output; image: (B, S, S, 3) input."""
    b, s, _ = tokens.shape
    return huber(tokens.reshape(b, s, s, 3), image_nhwc) \
        + kl_weight * kl.float()


def dominant_class_accuracy(logits: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """Accuracy on the dominant class under soft labels."""
    pred = logits.argmax(dim=-1)
    lab = targets.argmax(dim=-1) if targets.dim() == 2 else targets
    return (pred == lab).float().mean()
