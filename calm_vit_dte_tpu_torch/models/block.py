"""CALM stage Block: row self-attention -> axial transpose -> column
self-attention -> transpose back -> row/column cross-attention (resolution
change) -> conv residual.

JAX counterpart: calm_vit_dte_tpu/models/block.py (reference
Vi_Tools_CNN_less_V2.py:317-403). The first block tokenizes an NHWC image
(B, H, W, 3) into rows (B, H, W*3); the axial transpose views (B, S, 3S) as
(B, S, S, 3) and swaps the spatial axes. The conv residual works on that
NHWC view directly; `ConvResidual.forward` picks its formulation as the JAX
package's `conv_residual_apply` does (kernels/conv_residual.py has the
kernels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn

from calm_vit_dte_tpu_torch.kernels.conv_residual import (
    fused_conv_residual,
    fused_conv_residual_plain,
    fused_conv_residual_train,
)
from calm_vit_dte_tpu_torch.models.vmla import VMLA, VMLAConfig
from calm_vit_dte_tpu_torch.nn.conv import SNConv2d
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState

CONV_HIDDEN = 32


@dataclass(frozen=True)
class BlockConfig:
    heads: int
    dim1: int
    dim_step: int
    mean_var_hidden: int
    seq_length: int
    seq_len_step: int
    is_first_block: bool
    is_last_block: bool
    seq_len_reduce: int
    force_reduce: bool = False
    out_features_override: int | None = None

    @property
    def dim2(self) -> int:
        if self.out_features_override is not None:
            return self.out_features_override
        return self.dim1 + self.dim_step * 3

    @property
    def seq_len_new(self) -> int:
        return self.seq_length + self.seq_len_step * 3

    def encoder_cfg(self) -> VMLAConfig:
        return VMLAConfig(
            heads=self.heads, dim1=self.dim1, dim2=self.dim1,
            mean_var_hidden=self.mean_var_hidden,
            seq_length=self.seq_length, seq_len_reduce=self.seq_len_reduce,
            seq_len_new=self.seq_length, mlp_dim=self.dim1 * 2,
            force_reduce=self.force_reduce, use_mlp=True)

    def decoder_cfg(self) -> VMLAConfig:
        return self.encoder_cfg()

    def cross_cfg(self) -> VMLAConfig:
        return VMLAConfig(
            heads=self.heads, dim1=self.dim1, dim2=self.dim2,
            mean_var_hidden=self.mean_var_hidden,
            seq_length=self.seq_length, seq_len_reduce=self.seq_len_reduce,
            seq_len_new=self.seq_len_new,
            # mlp width follows dim1 + 3*dim_step even when the output dim
            # is overridden (reference :371).
            mlp_dim=(self.dim1 + self.dim_step * 3) * 2,
            force_reduce=self.force_reduce, is_cross=True, use_mlp=True)


class ConvResidual(nn.ModuleDict):
    """The 1x1 -> dw3x3 -> 1x1 conv stack (reference :379-385), children
    named "0", "2", "4" as in the reference's nn.Sequential."""

    def __init__(self, generator: torch.Generator):
        super().__init__({
            "0": SNConv2d(3, CONV_HIDDEN, 1, generator=generator),
            "2": SNConv2d(CONV_HIDDEN, CONV_HIDDEN, 3, groups=CONV_HIDDEN,
                          generator=generator),
            "4": SNConv2d(CONV_HIDDEN, 3, 1, generator=generator)})

    def forward(self, x_seq: torch.Tensor, dtype) -> torch.Tensor:
        """x_seq: (B, S, 3S) row tokens -> conv residual term (B, S, 3S);
        the JAX package's `conv_residual_apply`.

        CALM_CONV_FUSED, read at each call: unset, eval runs the fused
        forward kernel and training the F.conv2d chain under torch autograd
        (the JAX package's default, where its lax chain trained fastest);
        '1' also trains through the fused kernels
        (`fused_conv_residual_train`, backward route by CALM_CONV_BWD); '0'
        runs the F.conv2d chain everywhere. Any other value raises."""
        mode = os.environ.get("CALM_CONV_FUSED", "")
        if mode not in ("", "0", "1"):
            raise ValueError(f"CALM_CONV_FUSED={mode!r}: expected '0' or "
                             "'1'")
        b, s, _ = x_seq.shape
        img = x_seq.reshape(b, s, s, 3).to(dtype).contiguous()  # NHWC
        c1, c2, c3 = self["0"], self["2"], self["4"]
        if mode == "0" or (self.training and mode == ""):
            conv = fused_conv_residual_plain
        elif self.training:
            conv = fused_conv_residual_train
        else:
            conv = fused_conv_residual
        y = conv(
            img,
            c1.normalized_weight().reshape(CONV_HIDDEN, 3), c1.bias,
            c2.normalized_weight().permute(2, 3, 1, 0).reshape(
                3, 3, CONV_HIDDEN).contiguous(), c2.bias,
            c3.normalized_weight().reshape(3, CONV_HIDDEN), c3.bias,
            dtype=dtype)
        return y.reshape(b, s, s * 3)


def axial_transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, S, 3S) row tokens <-> column tokens (reference :394-398)."""
    b, s, _ = x.shape
    return x.reshape(b, s, s, 3).transpose(1, 2).reshape(b, s, s * 3)


def tokenize_image(x: torch.Tensor) -> torch.Tensor:
    """NHWC image (B, H, W, 3) -> row tokens (B, H, W*3)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w * c)


class Block(nn.Module):
    def __init__(self, cfg: BlockConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = VMLA(cfg.encoder_cfg(), generator)
        self.decoder = VMLA(cfg.decoder_cfg(), generator)
        self.cross = VMLA(cfg.cross_cfg(), generator)
        self.proj = ConvResidual(generator)

    def forward(self, x: torch.Tensor, esm: LatentState | None = None,
                dsm: LatentState | None = None,
                csm: LatentState | None = None, *, dtype=torch.float32,
                use_mask: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kw = dict(dtype=dtype, use_mask=use_mask, generator=generator)
        xq = tokenize_image(x) if self.cfg.is_first_block else x
        xq = self.encoder(xq, latent=esm, **kw)
        xkv = self.decoder(axial_transpose(xq), latent=dsm, **kw)
        xkv = axial_transpose(xkv)
        x = self.cross(xq, input_kv=xkv, latent=csm, **kw)
        return x + self.proj(x, dtype)
