"""Spectral normalization with explicit fp32 u/v buffers.

JAX counterpart: calm_vit_dte_tpu/nn/spectral_norm.py. Semantics match
torch.nn.utils.spectral_norm (old API) and the JAX package:
  * training: one power iteration v = norm(W^T u), u = norm(W v) updates the
    fp32 buffers, gradients stopped, and sigma uses the updated u, v;
  * eval: the stored u, v are used unchanged;
  * the matrix is the 2-D view (out_dim, -1) of the raw weight.

Each layer holds `weight_orig` (parameter) and `weight_u`/`weight_v`
(buffers), torch's own names, so reference state dicts load as they are. The
buffers are explicit rather than torch's forward hook so that
`normalize_tree` can normalize every layer in one batched pass and `freeze`
can pin the eval-mode weights once for serving (the JAX package's hoisted
pre-pass, `normalize_tree` + `prenormalized_scope`).
"""

from __future__ import annotations

import torch
from torch import nn

from calm_vit_dte_tpu_torch.nn.init import normalized_normal

_EPS = 1e-12


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """One torch-ordered power iteration: v = norm(W^T u); u = norm(W v)."""
    v = _l2n(w_mat.T @ u)
    u = _l2n(w_mat @ v)
    return u, v


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                       training: bool):
    """Return (w / sigma, u', v'). `w` may be any rank; its 2-D view is
    (w.shape[0], -1). u and v come back detached."""
    w32 = w.float()
    w_mat = w32.reshape(w32.shape[0], -1)
    u, v = u.detach(), v.detach()
    if training:
        with torch.no_grad():
            u, v = power_iteration(w_mat, u, v)
    sigma = torch.dot(u, w_mat @ v)
    return (w32 / sigma).to(w.dtype), u, v


class SpectralNormed(nn.Module):
    """Base of the spectral-normed layers: `weight_orig`, fp32 `weight_u`
    and `weight_v` buffers, and an optional frozen eval-mode weight."""

    def __init__(self, weight: torch.Tensor, generator: torch.Generator):
        super().__init__()
        self.weight_orig = nn.Parameter(weight)
        out_dim = weight.shape[0]
        self.register_buffer("weight_u",
                             normalized_normal((out_dim,), generator))
        self.register_buffer(
            "weight_v", normalized_normal((weight[0].numel(),), generator))
        # fp32 w/sigma pinned by freeze(); not part of the state dict.
        self.register_buffer("weight_frozen", None, persistent=False)

    def normalized_weight(self) -> torch.Tensor:
        """w / sigma in fp32. In training mode this runs one power iteration
        and updates the u/v buffers in place (torch's hook semantics)."""
        if self.weight_frozen is not None:
            return self.weight_frozen
        w, u, v = spectral_normalize(self.weight_orig, self.weight_u,
                                     self.weight_v, training=self.training)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w


@torch.no_grad()
def normalize_tree(model: nn.Module, *,
                   training: bool) -> dict[SpectralNormed, torch.Tensor]:
    """Normalize every spectral-normed weight of `model` in one pre-pass.

    Weights are batched by their (out, in) 2-D shape, so ~150 per-layer
    power iterations become a handful of batched einsums. In training mode
    the u/v buffers are updated in place. Returns {layer: w/sigma (fp32)}.
    Per-weight math is that of spectral_normalize up to fp32 reduction
    order.
    """
    groups: dict[tuple[int, int], list[SpectralNormed]] = {}
    for m in model.modules():
        if not isinstance(m, SpectralNormed):
            continue
        w = m.weight_orig
        groups.setdefault((w.shape[0], w[0].numel()), []).append(m)
    out: dict[SpectralNormed, torch.Tensor] = {}
    for shape2d, mods in groups.items():
        ws = torch.stack([m.weight_orig.float().reshape(shape2d)
                          for m in mods])
        us = torch.stack([m.weight_u for m in mods])
        vs = torch.stack([m.weight_v for m in mods])
        if training:
            vs = _l2n(torch.einsum("noi,no->ni", ws, us))
            us = _l2n(torch.einsum("noi,ni->no", ws, vs))
            for m, u, v in zip(mods, us, vs):
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        sigma = torch.einsum("no,noi,ni->n", us, ws, vs)
        wn = ws / sigma[:, None, None]
        for m, w in zip(mods, wn):
            out[m] = w.reshape(m.weight_orig.shape)
    return out


def freeze(model: nn.Module) -> None:
    """Pin every layer's eval-mode w/sigma (stored u, v unchanged): serving
    never updates u/v, so sigma is computed once instead of per forward."""
    for m, w in normalize_tree(model, training=False).items():
        m.weight_frozen = w
