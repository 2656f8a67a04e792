"""Variational (reparameterized Gaussian) bottleneck primitives, in fp32.

JAX counterpart: calm_vit_dte_tpu/ops/variational.py. sigma is parameterized
directly: sigma = softplus(raw) + 1e-6; z = mu at eval;
KL = -0.5 * mean(1 + 2 log sigma - mu^2 - sigma^2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus_var(var_raw: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.softplus(var_raw.float()) + eps


def reparameterize(mean: torch.Tensor, var: torch.Tensor, *,
                   training: bool) -> torch.Tensor:
    """z = mean at eval (fp32). Training draws z = mean + eps * var; that
    branch arrives with the trainer, which will take eps from the caller so
    a test can feed both packages the same noise."""
    if training:
        raise NotImplementedError("training-mode reparameterization is not "
                                  "ported yet")
    return mean.float()


def kl_divergence(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Reference KL with sigma parameterization: scalar fp32."""
    mean = mean.float()
    var = var.float()
    return -0.5 * torch.mean(1.0 + 2.0 * torch.log(var) - mean.square()
                             - var.square())
