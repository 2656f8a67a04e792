"""VMLA ("Variational Multi-Head Latent Attention") layer, eval forward.

JAX counterpart: calm_vit_dte_tpu/models/vmla.py (reference
Vi_Tools_CNN_less_V2.py:98-315). A pre-LN attention layer with an optional
feature bottleneck (x -> (mu, sigma)), an optional temporal bottleneck over
the sequence axis (seq_length -> seq_len_reduce -> seq_len_new), decoupled
RoPE when reducing (rope on the rope half only, concatenated with the
content half) and full-head RoPE otherwise, the learned additive attention
mask, LayerScale, residual shape adaptation and a 2x GELU MLP; every linear
is spectral-normed.

Submodules carry the reference's names (ln_q, t_encoder_q, q_proj,
linear_mask.0/2, mlp.0/3, ...), so reference and golden state dicts load
with load_state_dict. This slice ports the eval forward only; training
(reparameterization noise, dropout, power iteration per step) comes with
the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch.nn.linear import SNLinear
from calm_vit_dte_tpu_torch.nn.norm import LayerNorm
from calm_vit_dte_tpu_torch.ops.attention import masked_rope_attention
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState
from calm_vit_dte_tpu_torch.ops.rope import RoPE
from calm_vit_dte_tpu_torch.ops.variational import (
    reparameterize,
    softplus_var,
)


@dataclass(frozen=True)
class VMLAConfig:
    heads: int
    dim1: int
    dim2: int
    mean_var_hidden: int
    seq_length: int
    seq_len_reduce: int
    seq_len_new: int
    mlp_dim: int
    force_reduce: bool = False
    t_force_reduce: bool = False
    use_mlp: bool = True
    is_cross: bool = False

    @property
    def reduce(self) -> bool:
        return self.dim1 != self.dim2 or self.force_reduce

    @property
    def t_reduce(self) -> bool:
        return self.seq_len_new != self.seq_length or self.t_force_reduce

    @property
    def head_dim_content(self) -> int:
        return self.dim2 // self.heads // 2

    @property
    def head_dim_rope(self) -> int:
        return self.dim2 // self.heads // 2

    @property
    def head_dim(self) -> int:
        return self.head_dim_content + self.head_dim_rope

    def validate(self):
        rope_dim = self.head_dim_rope if self.reduce else self.head_dim
        if rope_dim % 2 != 0:
            raise ValueError(
                f"VMLA stage dim2={self.dim2}, heads={self.heads} yields odd "
                f"RoPE dim {rope_dim}; dim2 % (4*heads) == 0 is required.")


def _heads(layer: SNLinear, x: torch.Tensor, heads: int, dhead: int,
           dtype) -> torch.Tensor:
    """Projection straight into the head-split (B, H, S, d) layout."""
    b, s, _ = x.shape
    y = layer(x, dtype)
    return y.view(b, s, heads, dhead).transpose(1, 2).contiguous()


class VMLA(nn.Module):
    def __init__(self, cfg: VMLAConfig, generator: torch.Generator):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        g = generator

        def sn(in_dim, out_dim, bias=False):
            return SNLinear(in_dim, out_dim, bias=bias, generator=g)

        self.ls_att = nn.Parameter(torch.ones(cfg.dim2))
        if cfg.use_mlp:
            self.ls_mlp = nn.Parameter(torch.ones(cfg.dim2))
        self.ln_q = LayerNorm(cfg.dim1)
        if cfg.is_cross:
            self.ln_kv = LayerNorm(cfg.dim1)
        if cfg.t_reduce:
            self.t_encoder_q = sn(cfg.seq_length, cfg.seq_len_reduce)
            self.t_encoder_kv = sn(cfg.seq_length, cfg.seq_len_reduce)
        if cfg.reduce:
            self.encoder_q = sn(cfg.dim1, cfg.mean_var_hidden * 2)
            self.encoder_kv = sn(cfg.dim1, cfg.mean_var_hidden * 2)
        if cfg.t_reduce:
            self.t_qz_upsample = sn(cfg.seq_len_reduce, cfg.seq_len_new)
            self.t_kz_upsample = sn(cfg.seq_len_reduce, cfg.seq_len_new)
            self.t_vz_upsample = sn(cfg.seq_len_reduce, cfg.seq_len_new)
            self.t_qr_proj = sn(cfg.seq_len_reduce, cfg.seq_len_new)
            self.t_kr_proj = sn(cfg.seq_length, cfg.seq_len_new)
        qkv_in = cfg.mean_var_hidden if cfg.reduce else cfg.dim2
        qk_out = cfg.heads * (cfg.head_dim_content if cfg.reduce
                              else cfg.head_dim)
        self.q_proj = sn(qkv_in, qk_out)
        self.k_proj = sn(qkv_in, qk_out)
        self.v_proj = sn(qkv_in, cfg.dim2)
        if cfg.reduce:
            self.qr_proj = sn(cfg.mean_var_hidden,
                              cfg.head_dim_rope * cfg.heads)
            self.kr_proj = sn(cfg.dim1, cfg.head_dim_rope * cfg.heads)
        if cfg.seq_len_new != cfg.seq_length:
            self.input_t_proj = sn(cfg.seq_length, cfg.seq_len_new)
        if cfg.dim1 != cfg.dim2:
            self.input_proj = sn(cfg.dim1, cfg.dim2)
        rope_dim = cfg.head_dim_rope if cfg.reduce else cfg.head_dim
        self.rope_q = RoPE(rope_dim)
        self.rope_k = RoPE(rope_dim)
        s_new = cfg.seq_len_new
        self.linear_mask = nn.ModuleDict({
            "0": sn(s_new, s_new * 2, bias=True),
            "2": sn(s_new * 2, s_new, bias=True)})
        self.out_proj = sn(cfg.dim2, cfg.dim2)
        self.ln_2 = LayerNorm(cfg.dim2)
        if cfg.use_mlp:
            self.mlp = nn.ModuleDict({"0": sn(cfg.dim2, cfg.mlp_dim),
                                      "3": sn(cfg.mlp_dim, cfg.dim2)})

    def forward(self, input_q: torch.Tensor,
                input_kv: torch.Tensor | None = None,
                latent: LatentState | None = None, *, dtype=torch.float32,
                use_mask: bool = True) -> torch.Tensor:
        """Eval forward of one layer: (B, S, dim1) -> (B, S', dim2)."""
        if self.training:
            raise NotImplementedError(
                "the VMLA training forward is not ported yet; call .eval()")
        cfg = self.cfg
        residual = input_q
        xq = self.ln_q(input_q, dtype)
        xkv = xq if input_kv is None else self.ln_kv(input_kv, dtype)

        qz, kz, vz, qr, kr = xq, xkv, xkv, xq, xkv
        if cfg.reduce:
            if cfg.t_reduce:
                xq = self.t_encoder_q.seq(xq, dtype)
                xkv = self.t_encoder_kv.seq(xkv, dtype)
            mean_zq, var_zq_raw = self.encoder_q(xq, dtype).chunk(2, dim=-1)
            mean_zkv, var_zkv_raw = self.encoder_kv(xkv, dtype).chunk(2,
                                                                      dim=-1)
            var_zq = softplus_var(var_zq_raw)
            var_zkv = softplus_var(var_zkv_raw)
            zq = reparameterize(mean_zq, var_zq, training=False)
            zkv = reparameterize(mean_zkv, var_zkv, training=False)
            if latent is not None:
                zq, zkv = latent.update(zq, zkv, mean_zq, var_zq,
                                        mean_zkv, var_zkv)
            zq = zq.to(dtype)
            zkv = zkv.to(dtype)
            qr, qz, kz, vz = zq, zq, zkv, zkv
            if cfg.t_reduce:
                qz = self.t_qz_upsample.seq(zq, dtype)
                qr = self.t_qr_proj.seq(zq, dtype)
                kz = self.t_kz_upsample.seq(zkv, dtype)
                vz = self.t_vz_upsample.seq(zkv, dtype)
                # kr upsamples the full-resolution normed kv (reference
                # binds kr before the temporal encoder rebinding).
                kr = self.t_kr_proj.seq(kr, dtype)

        h = cfg.heads
        content_dim = cfg.head_dim_content if cfg.reduce else cfg.head_dim
        q = _heads(self.q_proj, qz, h, content_dim, dtype)
        k = _heads(self.k_proj, kz, h, content_dim, dtype)
        v = _heads(self.v_proj, vz, h, cfg.head_dim, dtype)
        if cfg.reduce:
            qr = _heads(self.qr_proj, qr, h, cfg.head_dim_rope, dtype)
            kr = _heads(self.kr_proj, kr, h, cfg.head_dim_rope, dtype)
            qc, kc = q, k
        else:
            qr, kr = q, k
            qc = kc = None
        fc1, fc2 = self.linear_mask["0"], self.linear_mask["2"]
        mask = (fc1.normalized_weight(), fc1.bias, fc2.normalized_weight(),
                fc2.bias)
        attn = masked_rope_attention(
            qc, qr, kc, kr, v, self.rope_q.inv_freq, self.rope_k.inv_freq,
            mask, dtype=dtype, use_mask=use_mask)
        b, _, s, _ = attn.shape
        x = attn.transpose(1, 2).reshape(b, s, -1)
        x = self.out_proj(x, dtype) * self.ls_att.to(dtype)

        if residual.shape != x.shape:
            if cfg.seq_len_new != cfg.seq_length:
                residual = self.input_t_proj.seq(residual, dtype)
            if cfg.dim1 != cfg.dim2:
                residual = self.input_proj(residual, dtype)
        x = x + residual.to(dtype)

        if cfg.use_mlp:
            y = self.ln_2(x, dtype)
            y = F.gelu(self.mlp["0"](y, dtype))
            y = self.mlp["3"](y, dtype) * self.ls_mlp.to(dtype)
            return x + y
        return self.ln_2(x, dtype)
