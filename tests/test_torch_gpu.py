"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Without one every test here skips (the decision is taken inside the
`cuda_device` fixture). The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import math

import numpy as np
import pytest
import torch

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.ops.rope import rope_tables

H = 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    # fp32 comparisons: no TF32 in the plain versions' products and convs.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, device, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("s,dc,dr", [(80, 10, 10), (80, 0, 20),
                                     (224, 28, 28), (224, 0, 56)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_kernel_matches_plain(cuda_device, s, dc, dr,
                                             use_mask):
    rng = np.random.default_rng(s + dc)
    b, d = 2, dc + dr

    def n(*shape, scale=0.3):
        return _normal(rng, cuda_device, *shape, scale=scale)

    inv = 1.0 / (10000.0 ** (torch.arange(0, dr, 2, dtype=torch.float32,
                                          device=cuda_device) / dr))
    cq, sq = rope_tables(inv, s)
    ck, sk = rope_tables(inv * 1.1, s)
    args = (n(b, H, s, dc) if dc else None, n(b, H, s, dr),
            n(b, H, s, dc) if dc else None, n(b, H, s, dr), n(b, H, s, d),
            cq, sq, ck, sk, n(2 * s, s, scale=0.05), n(2 * s, scale=0.05),
            n(s, 2 * s, scale=0.05), n(s, scale=0.05))
    kw = dict(scale=1.0 / math.sqrt(d), dtype=torch.float32,
              use_mask=use_mask)
    n0 = ka.fused_rope_attention.launches
    out = ka.fused_rope_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ka.fused_rope_attention.launches == n0 + 1
    ref = ka.fused_rope_attention_plain(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s,dc,dr,tensor_cores", [
    (44, 6, 6, False), (44, 0, 12, False), (80, 10, 10, False),
    (80, 10, 10, True), (224, 0, 56, False), (224, 0, 56, True)])
def test_rope_attention_kernel_bf16_error(cuda_device, s, dc, dr,
                                          tensor_cores):
    """bf16: each kernel's error against the fp32 plain version is at most
    twice the plain bf16 version's (the CUDA-core kernel, and the WMMA one
    where S % 16 == 0)."""
    rng = np.random.default_rng(s + dr)
    b, d = 2, dc + dr

    def n(*shape, scale=0.3, dtype=torch.bfloat16):
        return _normal(rng, cuda_device, *shape, scale=scale).to(dtype)

    inv = 1.0 / (10000.0 ** (torch.arange(0, dr, 2, dtype=torch.float32,
                                          device=cuda_device) / dr))
    cq, sq = rope_tables(inv, s)
    f32 = torch.float32
    args = [n(b, H, s, dc) if dc else None, n(b, H, s, dr),
            n(b, H, s, dc) if dc else None, n(b, H, s, dr), n(b, H, s, d),
            cq, sq, cq, sq, n(2 * s, s, scale=0.05, dtype=f32),
            n(2 * s, scale=0.05, dtype=f32),
            n(s, 2 * s, scale=0.05, dtype=f32), n(s, scale=0.05, dtype=f32)]
    scale = 1.0 / math.sqrt(d)
    out = ka._launch(*args, scale=scale, dtype=torch.bfloat16, use_mask=True,
                     tensor_cores=tensor_cores)
    plain = ka.fused_rope_attention_plain(*args, scale=scale,
                                          dtype=torch.bfloat16)
    ref = ka.fused_rope_attention_plain(
        *[a if a is None or a.dim() < 4 else a.float() for a in args],
        scale=scale, dtype=f32)
    err = (out.float() - ref).abs().max()
    assert err <= 2 * (plain.float() - ref).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("s", [80, 224])
def test_conv_residual_kernel_matches_plain(cuda_device, s):
    rng = np.random.default_rng(s)
    args = [_normal(rng, cuda_device, 2, s, s, 3),
            _normal(rng, cuda_device, 32, 3, scale=0.3),
            _normal(rng, cuda_device, 32, scale=0.1),
            _normal(rng, cuda_device, 3, 3, 32, scale=0.3),
            _normal(rng, cuda_device, 32, scale=0.1),
            _normal(rng, cuda_device, 3, 32, scale=0.2),
            _normal(rng, cuda_device, 3, scale=0.1)]
    n0 = kc.fused_conv_residual.launches
    out = kc.fused_conv_residual(*args, dtype=torch.float32)
    torch.cuda.synchronize()
    assert kc.fused_conv_residual.launches == n0 + 1
    ref = kc.fused_conv_residual_plain(*args, dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
