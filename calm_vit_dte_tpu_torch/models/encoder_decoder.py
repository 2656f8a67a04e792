"""Model stacks: EncoderDecoder8 (the U-Net-shaped 8-block / 24-attention-layer
stack), Encoder8 (encoder-only) and CALMLatentDiffusion (3 + 3 blocks).

JAX counterpart: calm_vit_dte_tpu/models/encoder_decoder.py (reference
Vi_Tools_CNN_less_V2.py:407-533, :600-656, :535-595).

EncoderDecoder8: three encoder blocks step dim/seq down by
3*step each, two bottleneck blocks keep the shape, three decoder blocks step
back up; long U-Net skips; final LayerNorm. One shared "sum" latent
accumulator threads through all cross layers and yields the KL term. With
`remat` each Block is one activation-checkpoint segment (utils/remat.py): the
backward replays the Block's cheap chain around the saved attention outputs.

Encoder8: 8 blocks stepping at blocks 2 and 5, skip-adds whenever
consecutive shapes match, no latent accumulators, final LayerNorm.
CALMLatentDiffusion: 3 encoder and 3 decoder blocks with one shared "sum"
latent accumulator (its KL is returned), the skips x + skips[1] after
decoder 0 and x + skips[0] after decoder 1, final LayerNorm (the JAX
package's completion of the reference's constructor-only module). Neither
takes `remat`: no training path of the package runs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from calm_vit_dte_tpu_torch.models.block import Block, BlockConfig
from calm_vit_dte_tpu_torch.nn.norm import LayerNorm
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState
from calm_vit_dte_tpu_torch.utils import remat as rm


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
                use_mask: bool = True,
                generator: torch.Generator | None = None,
                remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC image (B, H, W, 3). Returns (tokens (B,S,3S), kl).
        `generator` feeds the training-mode noise; `remat` checkpoints each
        Block (training, on pre-normalized weights: a replayed power
        iteration would update u/v twice)."""
        esm = LatentState(mode="sum") if self.cfg.force_reduce else None
        dsm = LatentState(mode="sum") if self.cfg.force_reduce else None
        csm = LatentState(mode="sum")
        states = [s for s in (esm, dsm, csm) if s is not None]
        any_sn_layer = self.block_bottle_neck_1.proj["0"]
        if remat and any_sn_layer.weight_prenormalized is None:
            raise ValueError("remat needs pre-normalized weights "
                             "(nn.spectral_norm.prenormalized_scope)")

        def run(block: Block, x: torch.Tensor) -> torch.Tensor:
            if not remat:
                return block(x, esm, dsm, csm, dtype=dtype,
                             use_mask=use_mask, generator=generator)
            # The latent accumulators are the segment's only mutable state:
            # their tensors go in and come out as arguments, their counters
            # are reset to the segment's start on every run.
            start = [s.carry() for s in states]

            def segment(x, *tensors):
                for i, s in enumerate(states):
                    s.set_carry(tuple(tensors[3 * i:3 * i + 3])
                                + start[i][3:])
                y = block(x, esm, dsm, csm, dtype=dtype, use_mask=use_mask,
                          generator=generator)
                return (y, *(t for s in states for t in s.carry()[:3]))

            y, *tensors = rm.checkpoint(
                segment, x, *(t for c in start for t in c[:3]))
            for i, s in enumerate(states):
                s.set_carry(tuple(tensors[3 * i:3 * i + 3]) + s.carry()[3:])
            return y

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


@dataclass(frozen=True)
class Encoder8Config:
    """Encoder-only 8-block stack (reference :600-640). The reference
    defaults (dim1=672, dim_step=24) give stage dim 600 at heads=12, an odd
    RoPE dim that crashes the reference's forward; stage dims must satisfy
    dim % (4*heads) == 0, hence dim_step=48."""
    heads: int = 12
    dim1: int = 672
    dim_step: int = 48
    mean_var_hidden: int = 192
    seq_length: int = 224
    seq_len_step: int = 16
    seq_len_reduce: int = 96
    force_reduce: bool = False

    def block_configs(self) -> list[tuple[str, BlockConfig]]:
        blocks = []
        dim, seq = self.dim1, self.seq_length
        for i in range(8):
            step = i in (2, 5)
            blocks.append((f"block_{i}", BlockConfig(
                heads=self.heads, dim1=dim,
                dim_step=-self.dim_step if step else 0,
                mean_var_hidden=self.mean_var_hidden, seq_length=seq,
                seq_len_step=-self.seq_len_step if step else 0,
                is_first_block=(i == 0), is_last_block=(i == 7),
                seq_len_reduce=self.seq_len_reduce,
                force_reduce=self.force_reduce)))
            if step:
                dim -= self.dim_step * 3
                seq -= self.seq_len_step * 3
        return blocks

    @property
    def final_dim(self) -> int:
        return self.dim1 - 2 * self.dim_step * 3


class Encoder8(nn.Module):
    """Submodules named as the reference's: encoder_blocks.{0..7},
    ln_final (the JAX package's block_{i})."""

    def __init__(self, cfg: Encoder8Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder_blocks = nn.ModuleList(
            Block(bcfg, generator) for _, bcfg in cfg.block_configs())
        self.ln_final = LayerNorm(cfg.final_dim)

    def forward(self, x: torch.Tensor, *, dtype=torch.float32,
                use_mask: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: NHWC image (B, H, W, 3) -> tokens (B, S', 3S'). No latent
        accumulators: each layer learns its own representation (reference
        :643-646)."""
        skip = None
        for block in self.encoder_blocks:
            x = block(x, dtype=dtype, use_mask=use_mask, generator=generator)
            if skip is None or x.shape != skip.shape:
                skip = x
            else:
                x = x + skip
                skip = x
        return self.ln_final(x, dtype)


@dataclass(frozen=True)
class CALMLatentDiffusionConfig:
    """3 + 3 encoder/decoder latent stack (reference :535-595, a constructor
    only there; the forward is the JAX package's U-Net wiring).
    `mean_var_hidden_diffusion` and `seq_len_reduce_diffusion` are the
    reference's constructor arguments; no layer uses them, there or here."""
    heads: int = 12
    dim1: int = 672
    dim_step: int = 48
    mean_var_hidden: int = 204
    mean_var_hidden_diffusion: int = 96
    seq_length: int = 224
    seq_len_step: int = 16
    seq_len_reduce: int = 80
    seq_len_reduce_diffusion: int = 32
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
        return self.dim1


class CALMLatentDiffusion(nn.Module):
    """Submodules: encoder_blocks.{0,1,2}, decoder_blocks.{0,1,2}, ln_final
    (the JAX package's encoder_{i}, decoder_{i}, ln_final;
    compat/from_jax.py::latent_diffusion_state_dict_from_jax maps them)."""

    def __init__(self, cfg: CALMLatentDiffusionConfig,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        blocks = dict(cfg.block_configs())
        self.encoder_blocks = nn.ModuleList(
            Block(blocks[f"encoder_{i}"], generator) for i in range(3))
        self.decoder_blocks = nn.ModuleList(
            Block(blocks[f"decoder_{i}"], generator) for i in range(3))
        self.ln_final = LayerNorm(cfg.final_dim)

    def forward(self, x: torch.Tensor, *, dtype=torch.float32,
                use_mask: bool = True,
                generator: torch.Generator | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC image (B, H, W, 3). Returns (tokens (B,S,3S), kl)."""
        csm = LatentState(mode="sum")
        kw = dict(dtype=dtype, use_mask=use_mask, generator=generator)
        skips = []
        for block in self.encoder_blocks:
            x = block(x, csm=csm, **kw)
            skips.append(x)
        x = self.decoder_blocks[0](x, csm=csm, **kw) + skips[1]
        x = self.decoder_blocks[1](x, csm=csm, **kw) + skips[0]
        x = self.decoder_blocks[2](x, csm=csm, **kw)
        return self.ln_final(x, dtype), csm.kl_loss()
