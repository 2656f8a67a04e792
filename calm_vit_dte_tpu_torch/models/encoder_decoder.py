"""EncoderDecoder8: the U-Net-shaped 8-block / 24-attention-layer stack.

JAX counterpart: calm_vit_dte_tpu/models/encoder_decoder.py (reference
Vi_Tools_CNN_less_V2.py:407-533). Three encoder blocks step dim/seq down by
3*step each, two bottleneck blocks keep the shape, three decoder blocks step
back up; long U-Net skips; final LayerNorm. One shared "sum" latent
accumulator threads through all cross layers and yields the KL term.
Encoder8 and CALMLatentDiffusion are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from calm_vit_dte_tpu_torch.models.block import Block, BlockConfig
from calm_vit_dte_tpu_torch.nn.norm import LayerNorm
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState


@dataclass(frozen=True)
class EncoderDecoder8Config:
    heads: int = 12
    dim1: int = 768
    dim_step: int = 48
    mean_var_hidden: int = 192
    seq_length: int = 256
    seq_len_step: int = 16
    seq_len_reduce: int = 128
    out_features_override: int | None = None
    force_reduce: bool = False

    def block_configs(self) -> list[tuple[str, BlockConfig]]:
        blocks = []
        dim, seq = self.dim1, self.seq_length
        for i in range(3):
            blocks.append((f"encoder_{i}", BlockConfig(
                heads=self.heads, dim1=dim, dim_step=-self.dim_step,
                mean_var_hidden=self.mean_var_hidden, seq_length=seq,
                seq_len_step=-self.seq_len_step,
                is_first_block=(i == 0), is_last_block=False,
                seq_len_reduce=self.seq_len_reduce,
                force_reduce=self.force_reduce)))
            dim -= self.dim_step * 3
            seq -= self.seq_len_step * 3
        for name in ("bottleneck_1", "bottleneck_2"):
            blocks.append((name, BlockConfig(
                heads=self.heads, dim1=dim, dim_step=0,
                mean_var_hidden=self.mean_var_hidden, seq_length=seq,
                seq_len_step=0, is_first_block=False, is_last_block=False,
                seq_len_reduce=self.seq_len_reduce,
                force_reduce=self.force_reduce)))
        for i in range(3):
            blocks.append((f"decoder_{i}", BlockConfig(
                heads=self.heads, dim1=dim, dim_step=self.dim_step,
                mean_var_hidden=self.mean_var_hidden, seq_length=seq,
                seq_len_step=self.seq_len_step,
                is_first_block=False, is_last_block=(i == 2),
                seq_len_reduce=self.seq_len_reduce,
                out_features_override=(self.out_features_override
                                       if i == 2 else None),
                force_reduce=self.force_reduce)))
            dim += self.dim_step * 3
            seq += self.seq_len_step * 3
        return blocks

    @property
    def final_dim(self) -> int:
        return self.dim1  # symmetric stack returns to the input dim


class EncoderDecoder8(nn.Module):
    """Submodules named as the reference's: encoder_blocks.{0,1,2},
    block_bottle_neck_{1,2}, decoder_blocks.{0,1,2}, ln_final."""

    def __init__(self, cfg: EncoderDecoder8Config,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        blocks = dict(cfg.block_configs())
        self.encoder_blocks = nn.ModuleList(
            Block(blocks[f"encoder_{i}"], generator) for i in range(3))
        self.block_bottle_neck_1 = Block(blocks["bottleneck_1"], generator)
        self.block_bottle_neck_2 = Block(blocks["bottleneck_2"], generator)
        self.decoder_blocks = nn.ModuleList(
            Block(blocks[f"decoder_{i}"], generator) for i in range(3))
        self.ln_final = LayerNorm(cfg.final_dim)

    def forward(self, x: torch.Tensor, *, dtype=torch.float32,
                use_mask: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC image (B, H, W, 3). Returns (tokens (B,S,3S), kl)."""
        esm = LatentState(mode="sum") if self.cfg.force_reduce else None
        dsm = LatentState(mode="sum") if self.cfg.force_reduce else None
        csm = LatentState(mode="sum")

        def run(block: Block, x: torch.Tensor) -> torch.Tensor:
            return block(x, esm, dsm, csm, dtype=dtype, use_mask=use_mask)

        skips = []
        for block in self.encoder_blocks:
            x = run(block, x)
            skips.append(x)  # skip_1, skip_2, skip_bn_1
        x = run(self.block_bottle_neck_1, x) + skips[2]
        skip_bn_2 = x
        x = run(self.block_bottle_neck_2, x) + skip_bn_2 + skips[2]
        x = run(self.decoder_blocks[0], x) + skips[1]
        x = run(self.decoder_blocks[1], x) + skips[0]
        x = run(self.decoder_blocks[2], x)
        x = self.ln_final(x, dtype)

        kl = csm.kl_loss()
        if self.cfg.force_reduce:
            kl = esm.kl_loss() + dsm.kl_loss() + kl
        return x, kl
