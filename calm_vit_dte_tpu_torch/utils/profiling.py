"""Profiling: torch.profiler traces, median wall-clock of a call, and model
FLOP utilization against the card's published peak.

JAX counterpart: calm_vit_dte_tpu/utils/profiling.py (jax.profiler traces,
XLA cost analysis, TPU MXU peaks). The peaks here are the H100's and
H200's; no TPU figure applies to the port.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

# Dense bf16 tensor-core peak per card, TFLOP/s (NVIDIA's data sheets, SXM
# parts at their full power limit).
_PEAK_TFLOPS = {"H100": 989.0, "H200": 989.0}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the host and, where there is a card, the device under
    torch.profiler; on exit the trace is written to
    `<log_dir>/trace.json` (Chrome trace format). Yields the profiler, so
    the caller can read `key_averages()`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card when `out` holds a CUDA tensor."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn, *args, warmup: int = 3, iters: int = 10):
    """Median wall-clock seconds of `fn(*args)` over `iters` calls after
    `warmup`, each call waited for on the card. Returns (seconds, last
    output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50)), out


def chip_peak_tflops(device_name: str | None = None) -> float:
    """Dense bf16 peak TFLOP/s of the named card (default: card 0). Raises
    for a card whose peak is not in the table."""
    name = device_name or torch.cuda.get_device_name(0)
    for key, peak in _PEAK_TFLOPS.items():
        if key in name.upper():
            return peak
    raise ValueError(f"no bf16 peak known for {name!r}; known: "
                     f"{sorted(_PEAK_TFLOPS)}")


def cost_flops(fn, *args) -> float | None:
    """FLOPs of one `fn(*args)` as torch.utils.flop_counter.FlopCounterMode
    counts them (matrix products and convolutions of PyTorch operators);
    None when it counts none. The port's own kernels are launched through
    ctypes and are invisible to it: their operations are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops()) or None


def mfu(step_time_s: float, flops: float,
        device_name: str | None = None) -> float:
    """Model FLOP utilization: flops per second over the card's bf16 peak."""
    return flops / step_time_s / (chip_peak_tflops(device_name) * 1e12)


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter (kernels/*.py), by name: each
    adds one where it launches its kernel on the card."""
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.kernels import relayout as kr

    return {fn.__name__: fn.launches for fn in (
        ka.fused_rope_attention, ka.fused_rope_attention_bwd,
        kc.fused_conv_residual, kc.conv_residual_fwd_resid,
        kc.conv_residual_bwd, kc.conv_weight_grad_sum,
        kh.fused_hires_attention, kh.hires_dq, kh.hires_weight_grads,
        kh.hires_dkv, kh.fused_attention_forward, kr.swap_seq_heads)}


def stage_counts() -> dict[str, int]:
    """The rope and hires wrappers' stage launches (the kernels each call
    launches past its counted one, as the C entries report them), by
    name."""
    from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    return {fn.__name__: fn.stage_launches for fn in (
        ka.fused_rope_attention, ka.fused_rope_attention_bwd,
        kh.fused_hires_attention, kh.hires_dq, kh.fused_attention_forward)}
