"""The CALM block's conv residual (1x1 3->32, GELU, depthwise 3x3 with zero
padding, GELU, 1x1 32->3): the CUDA kernel's wrapper and its plain version.

JAX counterpart: calm_vit_dte_tpu/kernels/conv_residual.py,
`fused_conv_residual` (the Pallas kernel built by `_make_fused`, forward
body `_fwd_kernel`). The kernel source and its design note are in
csrc/conv_residual.cu. Both GELUs are exact (erf) in both compute dtypes;
the TPU kernel's bf16 minimax GELU is not carried over. There is no S gate:
every S goes to the kernel on the card.

On a CPU tensor the wrapper runs the plain version, the F.conv2d chain in
the compute dtype (what the JAX package's lax chain computes); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels._build import library
from calm_vit_dte_tpu_torch.nn.conv import conv2d_nhwc

SOURCE = "calm_vit_dte_tpu_torch/csrc/conv_residual.cu"
REPLACES = "calm_vit_dte_tpu/kernels/conv_residual.py:355"
HIDDEN = 32
_DTYPES = (torch.float32, torch.bfloat16)


def fused_conv_residual_plain(x, w1, b1, wd, bd, w2, b2, *,
                              dtype) -> torch.Tensor:
    """x: (B,S,S,3) NHWC. w1 (32,3), wd (3,3,32) [= OIHW (32,1,3,3)
    transposed], w2 (3,32), biases (32,), (32,), (3,). Returns (B,S,S,3) in
    `dtype`."""
    w1_oihw = w1.reshape(HIDDEN, 3, 1, 1)
    wd_oihw = wd.permute(2, 0, 1).reshape(HIDDEN, 1, 3, 3)
    w2_oihw = w2.reshape(3, HIDDEN, 1, 1)
    h = F.gelu(conv2d_nhwc(x, w1_oihw, b1, dtype=dtype))
    h = F.gelu(conv2d_nhwc(h, wd_oihw, bd, groups=HIDDEN, dtype=dtype))
    return conv2d_nhwc(h, w2_oihw, b2, dtype=dtype)


def _kernel_fn():
    fn = library("conv_residual").conv_residual_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, wd, bd, w2, b2, *, dtype) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype {dtype} not supported; "
                         f"expected one of {_DTYPES}")
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != 3:
        raise ValueError(f"x must be (B,S,S,3), got {tuple(x.shape)}")
    b, s = x.shape[0], x.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's z limit 65535")
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {dtype}, got {x.dtype}")
    for name, t, shape in (("w1", w1, (HIDDEN, 3)), ("b1", b1, (HIDDEN,)),
                           ("wd", wd, (3, 3, HIDDEN)), ("bd", bd, (HIDDEN,)),
                           ("w2", w2, (3, HIDDEN)), ("b2", b2, (3,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} float32 "
                             f"on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    y = torch.empty_like(x)
    err = _kernel_fn()(
        int(dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), wd.data_ptr(), bd.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), b, s,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_residual_fwd launch failed: CUDA error "
                           f"{err} (B={b}, S={s}, {dtype})")
    fused_conv_residual.launches += 1
    return y


def fused_conv_residual(x, w1, b1, wd, bd, w2, b2, *,
                        dtype) -> torch.Tensor:
    """The conv residual term of x (B,S,S,3) NHWC, in `dtype`. Weights are
    spectral-normalized fp32 in the layouts of `fused_conv_residual_plain`.
    A CPU tensor runs the plain version; on the card x must already be
    contiguous and in `dtype`."""
    if x.device.type == "cpu":
        return fused_conv_residual_plain(x, w1, b1, wd, bd, w2, b2,
                                         dtype=dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, w1, b1, wd, bd, w2, b2, dtype=dtype)


fused_conv_residual.launches = 0
