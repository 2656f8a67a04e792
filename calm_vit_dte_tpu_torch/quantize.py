"""Post-training int8 quantization for the serving path.

JAX counterpart: calm_vit_dte_tpu/quantize.py, in the same two schemes:

w8a8 dynamic (mode 'w8a8', Predictor quantize='int8'):
  * weights: symmetric per-output-channel int8, each row of the frozen,
    spectral-normalized (out, in) matrix scaled by absmax(row) / 127 and
    rounded half to even (torch.round, like jnp.round); the layer holds
    `w_q` (int8) and `w_s` (fp32, (out,));
  * activations: symmetric per-token dynamic int8 over the contraction
    axis, no calibration data;
  * the product is int8 x int8 -> int32, then one rescale (sx * w_s) to the
    compute dtype. On the card it is torch._int_mm (cuBLAS): the JAX package
    leaves this product to XLA's dot_general outside any Pallas kernel. On
    the CPU it is an int32 product, exact.

w8a16 weight-only (mode 'w8a16', Predictor quantize='int8-wo'): the same
int8 weights with their scales in `w_so`; activations stay in the compute
dtype, the weight converts exactly to it (|q| <= 127), the product
accumulates in fp32 and the per-channel scale applies to the accumulator.

What gets quantized: every 2-D spectral-normed linear except the attention
mask MLP (`_SKIP`: its weights are operands of the attention kernel, which
takes float tiles). Conv taps, LayerNorm, LayerScale, biases and RoPE tables
stay float. The JAX package merges projections that share an input and
concatenates their per-row scales; the port keeps one projection per layer.
Both use the same per-row weight scales and per-token activation scales, so
the results are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from calm_vit_dte_tpu_torch.nn.spectral_norm import SpectralNormed

MODES = ("w8a8", "w8a16")
# Layers whose weights stay float (operands of the attention kernel).
_SKIP = ("linear_mask",)
# torch._int_mm on the card: more than 16 rows in A, K and N multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an (out, in) matrix. Returns
    (w_q int8 (out, in), w_s fp32 (out,))."""
    w32 = w.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    wq = torch.round(w32 / scale[:, None]).clamp(-127, 127)
    return wq.to(torch.int8), scale


def _dynamic_quant(x: torch.Tensor, dim: int):
    """Symmetric dynamic int8 over `dim` (the contraction axis). Returns
    (x_q int8, scale fp32 with `dim` kept)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 127.0
    xq = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return xq, scale


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    return t if (r, c) == (rows, cols) else F.pad(t, (0, cols - c, 0,
                                                      rows - r))


def int8_matmul(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ wq (N, K) int8 ^T -> (M, N) int32, exact. On the
    card through torch._int_mm; where M <= 16 or K, N are not multiples of
    8 (the tiny configs, a batch of a few images at the head) both operands
    are padded with zeros, which leaves every sum unchanged. The flagship's
    widths need no padding."""
    if a.device.type != "cuda":
        return a.int() @ wq.int().t()
    m, k = a.shape
    n = wq.shape[0]
    mp = max(m, _MIN_ROWS)
    kp, np_ = -(-k // _ALIGN) * _ALIGN, -(-n // _ALIGN) * _ALIGN
    out = torch._int_mm(_pad_to(a.contiguous(), mp, kp),
                        _pad_to(wq, np_, kp).t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


def qdot(x, wq, ws, b=None, *, dtype) -> torch.Tensor:
    """y = x @ dequant(wq)^T (+ b), w8a8. x (..., in); wq (out, in) int8;
    ws (out,) fp32."""
    xq, sx = _dynamic_quant(x, -1)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    y = y.reshape(*x.shape[:-1], wq.shape[0])
    y = (y.float() * sx * ws).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def qdot_seq(x, wq, ws, *, dtype) -> torch.Tensor:
    """The sequence-axis contraction einsum('ns,bsd->bnd', w, x), w8a8.
    x (b, s, d); wq (n, s) int8; ws (n,) fp32. Activation scales are per
    (b, d) column: absmax over the contracted s axis."""
    b, s, d = x.shape
    xq, sx = _dynamic_quant(x, -2)                    # sx (b, 1, d)
    cols = xq.transpose(1, 2).reshape(b * d, s)       # rows (b, d)
    y = int8_matmul(cols, wq).reshape(b, d, -1).transpose(1, 2)
    return (y.float() * ws[None, :, None] * sx).to(dtype)


def _wo_matmul(x2, wq, dtype) -> torch.Tensor:
    """x2 (M, K) @ wq (N, K)^T with x and the weight in `dtype`, summed in
    fp32, fp32 out (the JAX preferred_element_type=float32). On the card:
    one cuBLAS product with an fp32 output (torch.mm's out_dtype); on the
    CPU the operands go to fp32 first, exactly representable."""
    w = wq.to(dtype)
    if x2.device.type == "cuda" and dtype != torch.float32:
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return x2.float() @ w.float().t()


def qdot_wo(x, wq, ws, b=None, *, dtype) -> torch.Tensor:
    """Weight-only (w8a16) y = x @ dequant(wq)^T (+ b): activations in
    `dtype`, the int8 weight converted exactly to `dtype`, an fp32 sum,
    the per-channel scale on the accumulator."""
    y = _wo_matmul(x.to(dtype).reshape(-1, x.shape[-1]), wq, dtype)
    y = (y.reshape(*x.shape[:-1], wq.shape[0]) * ws).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def qdot_seq_wo(x, wq, ws, *, dtype) -> torch.Tensor:
    """Weight-only einsum('ns,bsd->bnd', w, x). x (b, s, d); wq (n, s)
    int8; ws (n,) fp32."""
    b, s, d = x.shape
    cols = x.to(dtype).transpose(1, 2).reshape(b * d, s)
    y = _wo_matmul(cols, wq, dtype).reshape(b, d, -1).transpose(1, 2)
    return (y * ws[None, :, None]).to(dtype)


def quantize_model(model: nn.Module, mode: str = "w8a8") -> list[str]:
    """Quantize every eligible spectral-normed 2-D linear of a FROZEN model
    (nn.spectral_norm.freeze first) in place: the layer's frozen weight is
    replaced by `w_q` and `w_s` (w8a8) or `w_so` (w8a16), which its forward
    and `seq` then use. Returns the quantized layers' names."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize_model mode: {mode!r}")
    done = []
    for name, m in model.named_modules():
        if (not isinstance(m, SpectralNormed) or m.weight_orig.dim() != 2
                or any(k in name.split(".") for k in _SKIP)):
            continue
        if m.weight_frozen is None:
            raise ValueError(f"{name}: quantize_model takes a frozen model "
                             "(nn.spectral_norm.freeze)")
        wq, scale = quantize_weight(m.weight_frozen)
        m.w_q = wq
        setattr(m, "w_s" if mode == "w8a8" else "w_so", scale)
        m.weight_frozen = None
        done.append(name)
    return done
