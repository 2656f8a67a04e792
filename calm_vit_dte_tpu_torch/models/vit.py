"""ViT task wrapper: EncoderDecoder8 backbone plus a classification head
(mean-pool over the sequence -> SN MLP d -> 2d -> classes) or a generate head
(the block's conv residual applied to the image-shaped output).

JAX counterpart: calm_vit_dte_tpu/models/vit.py (reference
CALM_ViT_V2.py:21-84). Input is an NHWC image (B, H, W, 3). The forward
returns (logits or image tokens (B,S,3S), kl).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch.models.block import ConvResidual
from calm_vit_dte_tpu_torch.models.encoder_decoder import (
    EncoderDecoder8,
    EncoderDecoder8Config,
)
from calm_vit_dte_tpu_torch.nn.linear import SNLinear


@dataclass(frozen=True)
class ViTConfig:
    heads: int = 12
    seq_length: int = 256
    in_features: int = 768
    dim_step: int = 48
    mean_var_hidden: int = 192
    seq_len_step: int = 16
    seq_len_reduce: int = 128
    out_features: int = 1000
    force_reduce: bool = False
    generate: bool = True

    def backbone_cfg(self) -> EncoderDecoder8Config:
        return EncoderDecoder8Config(
            heads=self.heads, dim1=self.in_features, dim_step=self.dim_step,
            mean_var_hidden=self.mean_var_hidden, seq_length=self.seq_length,
            seq_len_step=self.seq_len_step,
            seq_len_reduce=self.seq_len_reduce,
            out_features_override=None, force_reduce=self.force_reduce)

    def validate(self):
        if self.in_features != 3 * self.seq_length:
            raise ValueError(
                f"row tokenization requires in_features == 3*seq_length, got "
                f"{self.in_features} != 3*{self.seq_length}")
        if self.dim_step != 3 * self.seq_len_step:
            raise ValueError(
                "dim/seq invariant requires dim_step == 3*seq_len_step")
        for _, bcfg in self.backbone_cfg().block_configs():
            bcfg.cross_cfg().validate()


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.autoencoder = EncoderDecoder8(cfg.backbone_cfg(), generator)
        if cfg.generate:
            self.proj = ConvResidual(generator)
        else:
            d = cfg.in_features
            self.head = nn.ModuleDict({
                "0": SNLinear(d, d * 2, generator=generator),
                "2": SNLinear(d * 2, cfg.out_features, generator=generator)})

    def forward(self, x: torch.Tensor, *, dtype=torch.float32,
                use_mask: bool = True,
                generator: torch.Generator | None = None,
                remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """`generator` feeds the training-mode noise; `remat` checkpoints
        each Block of the backbone (see EncoderDecoder8.forward)."""
        x = x.to(dtype)
        feats, kl = self.autoencoder(x, dtype=dtype, use_mask=use_mask,
                                     generator=generator, remat=remat)
        if self.cfg.generate:
            return feats + self.proj(feats, dtype), kl
        pooled = feats.mean(dim=1)  # AdaptiveAvgPool1d over the sequence
        h = F.gelu(self.head["0"](pooled, dtype))
        return self.head["2"](h, dtype), kl

