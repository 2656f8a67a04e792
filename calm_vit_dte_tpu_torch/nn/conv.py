"""Spectral-normalized 2-D convolution: OIHW weights, NHWC at the interface.

JAX counterpart: calm_vit_dte_tpu/nn/conv.py. The CALM block's image view
(B, S, S, 3) is NHWC, so the interface stays NHWC like the JAX package's:
`conv2d_nhwc` permutes to torch's NCHW around F.conv2d. It is the building
block of the conv residual's plain version (kernels/conv_residual.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch.nn import init as vinit
from calm_vit_dte_tpu_torch.nn.spectral_norm import SpectralNormed


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                groups: int = 1, dtype=None) -> torch.Tensor:
    """Stride-1 'SAME' conv of an NHWC tensor with an OIHW weight, in
    `dtype`."""
    dtype = dtype or x.dtype
    pad = w.shape[-1] // 2
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype),
                 None if b is None else b.to(dtype), padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class SNConv2d(SpectralNormed):
    """OIHW `weight_orig` + bias. Its only caller, the block's conv
    residual, hands the normalized weights to one fused kernel, so the layer
    has no forward of its own."""

    def __init__(self, in_c: int, out_c: int, kernel: int, *, groups: int = 1,
                 generator: torch.Generator):
        fan_in = (in_c // groups) * kernel * kernel
        super().__init__(vinit.kaiming_uniform(
            (out_c, in_c // groups, kernel, kernel), fan_in, generator),
            generator)
        self.bias = nn.Parameter(vinit.bias_uniform((out_c,), fan_in,
                                                    generator))
