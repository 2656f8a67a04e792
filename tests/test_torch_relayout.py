"""The head-split relayout (kernels/relayout.py) against the JAX package's
probe kernel, and the port's profiling helpers, on the CPU.

The probe's Pallas kernel (scripts/canary_probes.py::probe_swap, the same
body as scripts/mosaic_swap_probe.py) is rebuilt here at a small shape and
run in interpret mode; the port's wrapper runs its plain version on a CPU
tensor. The function is a copy, so every comparison is exact.
tests/test_torch_gpu.py holds the CUDA kernel against the plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from calm_vit_dte_tpu_torch.kernels import relayout as kr
from calm_vit_dte_tpu_torch.utils import profiling

torch.set_num_threads(1)

B, S, H = 2, 16, 3


def _probe_kernel(x_ref, o_ref):
    o_ref[0] = jnp.swapaxes(x_ref[0], 0, 1)


def _probe_call(shape, dtype):
    """probe_swap's pallas_call, one grid step per batch element, at
    `shape` (B, S, H, D), in interpret mode."""
    b, s, h, d = shape
    return pl.pallas_call(
        _probe_kernel, grid=(b,),
        in_specs=[pl.BlockSpec((1, s, h, d), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, h, s, d), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, h, s, d), dtype),
        interpret=True)


@pytest.mark.parametrize("d", [20, 44, 56])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_seq_heads_matches_the_probe_kernel(d, dtype):
    x_np = np.random.default_rng(d).standard_normal(
        (B, S, H, d)).astype(np.float32)
    x_jax = jnp.asarray(x_np, getattr(jnp, dtype))
    x = torch.from_numpy(x_np).to(getattr(torch, dtype))
    n0 = kr.swap_seq_heads.launches
    y = kr.swap_seq_heads(x)
    assert kr.swap_seq_heads.launches == n0   # the plain version: no launch
    assert y.shape == (B, H, S, d) and y.is_contiguous()
    want = [np.asarray(jnp.swapaxes(x_jax, 1, 2).astype(jnp.float32)),
            np.asarray(_probe_call(x_np.shape, x_jax.dtype)(x_jax)
                       .astype(jnp.float32))]
    for w in want:
        np.testing.assert_array_equal(y.float().numpy(), w)


def test_swap_seq_heads_rejects_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        kr.swap_seq_heads(torch.zeros(1, 2, 3, 4, device="meta"))


def test_profiling_helpers_on_the_cpu(tmp_path):
    x, w = torch.randn(8, 32), torch.randn(16, 32)
    seconds, out = profiling.time_fn(F.linear, x, w, warmup=1, iters=3)
    assert seconds > 0 and out.shape == (8, 16)
    assert profiling.cost_flops(F.linear, x, w) == 2 * 8 * 16 * 32
    assert profiling.cost_flops(torch.relu, x) is None
    assert profiling.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert profiling.mfu(1.0, 989e12, "NVIDIA H100 80GB HBM3") == 1.0
    with pytest.raises(ValueError, match="no bf16 peak"):
        profiling.chip_peak_tflops("TPU v5 lite")
    with profiling.trace(str(tmp_path / "trace")) as prof:
        F.linear(x, w)
    assert prof.key_averages()
    assert (tmp_path / "trace" / "trace.json").exists()
