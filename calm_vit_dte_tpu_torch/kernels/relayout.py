"""The (s, h, d) -> (h, s, d) head-split relayout: the CUDA kernel's wrapper
and its plain version.

JAX counterpart: the Pallas kernel of the toolchain canary,
scripts/canary_probes.py::probe_swap (:62), and its module-level twin in
scripts/mosaic_swap_probe.py (:29): o[b] = swapaxes(x[b], 0, 1) for x
(B, S, H, D). The kernel source and its design notes are in
csrc/relayout.cu. It is a copy, so the kernel and the plain version agree
bit for bit; the plain version is also the one PyTorch call that computes
the function (its time is the kernel's library time).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from calm_vit_dte_tpu_torch.kernels._build import library

SOURCE = "calm_vit_dte_tpu_torch/csrc/relayout.cu"
REPLACES = "scripts/canary_probes.py:62"
REPLACES_MODULE_PROBE = "scripts/mosaic_swap_probe.py:29"
_DTYPES = (torch.float32, torch.bfloat16)


def swap_seq_heads_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D)."""
    return x.transpose(1, 2).contiguous()


def swap_seq_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D). On the card x must be a
    contiguous fp32 or bf16 tensor."""
    if x.device.type == "cpu":
        return swap_seq_heads_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, H, D) tensor of "
                         f"one of {_DTYPES}, got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()})")
    b, s, h, d = x.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} and H={h} must each be at most 65535 (the "
                         "grid's y and z limits)")
    y = torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = library("relayout").swap_seq_heads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), y.data_ptr(), b, s, h, d * x.element_size(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swap_seq_heads launch failed: CUDA error {err} "
                           f"({tuple(x.shape)}, {x.dtype})")
    swap_seq_heads.launches += 1
    return y


swap_seq_heads.launches = 0
