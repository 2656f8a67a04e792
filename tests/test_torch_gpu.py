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


def _attention_inputs(rng, device, b, s, dc, dr, dtype):
    """The 13 inputs of the fused attention plus an output gradient; q, k, v
    and g in `dtype`, tables and mask weights fp32."""
    d = dc + dr

    def n(*shape, scale=0.3, dt=dtype):
        return _normal(rng, device, *shape, scale=scale).to(dt)

    tables = [None] * 4
    if dr:
        inv = 1.0 / (10000.0 ** (torch.arange(
            0, dr, 2, dtype=torch.float32, device=device) / dr))
        tables = [*rope_tables(inv, s), *rope_tables(inv * 1.1, s)]
    f32 = torch.float32
    args = [n(b, H, s, dc) if dc else None, n(b, H, s, dr) if dr else None,
            n(b, H, s, dc) if dc else None, n(b, H, s, dr) if dr else None,
            n(b, H, s, d), *tables, n(2 * s, s, scale=0.05, dt=f32),
            n(2 * s, scale=0.05, dt=f32), n(s, 2 * s, scale=0.05, dt=f32),
            n(s, scale=0.05, dt=f32)]
    return args, n(b, H, s, d)


GRAD_NAMES = ("dqc", "dqr", "dkc", "dkr", "dv", "dcos_q", "dsin_q", "dcos_k",
              "dsin_k", "dw1", "db1", "dw2", "db2")
# Every flagship attention shape (S, Dc, Dr), with and without content
# halves, and the no-rope case (Dr = 0) of the `_make_fused` kernels.
BWD_SHAPES = [(224, 28, 28), (224, 0, 56), (176, 22, 22), (176, 0, 44),
              (128, 16, 16), (128, 0, 32), (80, 10, 10), (80, 0, 20),
              (224, 56, 0), (80, 20, 0)]


def _norm_err(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("s,dc,dr", BWD_SHAPES)
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_bwd_kernel_matches_plain(cuda_device, s, dc, dr,
                                                 use_mask):
    """fp32: all 13 gradients within 1e-4 of the output's largest value (the
    sums run in another order than torch's; nothing is atomic, so the kernel
    gives the same bits on every run)."""
    rng = np.random.default_rng(s + dc)
    args, g = _attention_inputs(rng, cuda_device, 2, s, dc, dr,
                                torch.float32)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=torch.float32,
              use_mask=use_mask)
    n0 = ka.fused_rope_attention_bwd.launches
    got = ka.fused_rope_attention_bwd(g, *args, **kw)
    again = ka.fused_rope_attention_bwd(g, *args, **kw)
    torch.cuda.synchronize()
    assert ka.fused_rope_attention_bwd.launches == n0 + 2
    want = ka.fused_rope_attention_bwd_plain(g, *args, **kw)
    for name, x, y, z in zip(GRAD_NAMES, got, want, again):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert _norm_err(x, y) <= 1e-4, name
        assert torch.equal(x, z), f"{name} differs between two runs"
    if not use_mask:
        assert all(x is None for x in got[9:])


@pytest.mark.gpu
@pytest.mark.parametrize("s,dc,dr", BWD_SHAPES)
def test_rope_attention_bwd_kernel_bf16_error(cuda_device, s, dc, dr):
    """bf16: each gradient's error against the fp32 plain version is at most
    twice the bf16 plain version's (same rounding points)."""
    rng = np.random.default_rng(s + dr)
    bf16, f32 = torch.bfloat16, torch.float32
    args, g = _attention_inputs(rng, cuda_device, 2, s, dc, dr, bf16)
    scale = 1.0 / math.sqrt(dc + dr)
    got = ka.fused_rope_attention_bwd(g, *args, scale=scale, dtype=bf16)
    plain = ka.fused_rope_attention_bwd_plain(g, *args, scale=scale,
                                              dtype=bf16)
    ref = ka.fused_rope_attention_bwd_plain(
        g.float(), *[a if a is None else a.float() for a in args],
        scale=scale, dtype=f32)
    for name, x, y, r in zip(GRAD_NAMES, got, plain, ref):
        if x is None:
            continue
        assert x.dtype == y.dtype, name
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name


@pytest.mark.gpu
@pytest.mark.parametrize("s,dc,dr", [(80, 10, 10), (80, 20, 0)])
def test_rope_attention_function_matches_autograd(cuda_device, s, dc, dr):
    """The autograd Function (forward and backward kernels) against torch
    autograd of the plain forward: an independent check of the formulas."""
    rng = np.random.default_rng(s)
    args, g = _attention_inputs(rng, cuda_device, 2, s, dc, dr,
                                torch.float32)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=torch.float32)

    def grads(fn):
        leaves = [None if a is None else a.clone().requires_grad_()
                  for a in args]
        fn(*leaves, **kw).backward(g)
        return [None if a is None else a.grad for a in leaves]

    for name, x, y in zip(GRAD_NAMES, grads(ka.fused_rope_attention),
                          grads(ka.fused_rope_attention_plain)):
        if x is not None:
            assert _norm_err(x, y) <= 1e-4, name


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
