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
@pytest.mark.parametrize("s,dc,dr", [
    (44, 6, 6), (44, 0, 12), (80, 10, 10), (224, 0, 56), (224, 28, 28),
    (256, 32, 32), (208, 26, 26), (160, 20, 20), (112, 14, 14)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_kernel_bf16_error(cuda_device, s, dc, dr, use_mask):
    """bf16: the tensor-core kernel's error against the fp32 plain version
    is at most twice the plain bf16 version's, at the flagship's and
    imagenet-cls-256's shapes and at a ragged S (44, padded to 48)."""
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
    kw = dict(scale=scale, use_mask=use_mask)
    out = ka.fused_rope_attention(*args, dtype=torch.bfloat16, **kw)
    plain = ka.fused_rope_attention_plain(*args, dtype=torch.bfloat16, **kw)
    ref = ka.fused_rope_attention_plain(
        *[a if a is None or a.dim() < 4 else a.float() for a in args],
        dtype=f32, **kw)
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
# imagenet-cls-256's shapes sit at every limit of the rope route (S 256,
# D 64, Dv 64); S = 44 is ragged (padded to 48 in the bf16 kernels).
BWD_SHAPES = [(224, 28, 28), (224, 0, 56), (176, 22, 22), (176, 0, 44),
              (128, 16, 16), (128, 0, 32), (80, 10, 10), (80, 0, 20),
              (224, 56, 0), (80, 20, 0), (256, 32, 32), (208, 26, 26),
              (160, 20, 20), (112, 14, 14), (44, 6, 6)]


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
@pytest.mark.parametrize("s,dc,dr", [(224, 28, 28), (256, 32, 32),
                                     (80, 20, 0)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_bwd_kernel_bf16_deterministic(cuda_device, s, dc, dr,
                                                      use_mask):
    """The bf16 backward (rows kernel, keys kernel, weight-grad products and
    their fixed-order reductions) gives the same bits on every run."""
    rng = np.random.default_rng(s + 7)
    bf16 = torch.bfloat16
    args, g = _attention_inputs(rng, cuda_device, 4, s, dc, dr, bf16)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=bf16, use_mask=use_mask)
    n0 = ka.fused_rope_attention_bwd.stage_launches
    first = ka.fused_rope_attention_bwd(g, *args, **kw)
    second = ka.fused_rope_attention_bwd(g, *args, **kw)
    torch.cuda.synchronize()
    # Per call beside the rows kernel: the prologue, the keys kernel, the
    # table-grad reduction (Dr > 0), two weight-grad products and their
    # reduction (with the mask).
    per_call = 2 + (dr > 0) + 3 * use_mask
    assert ka.fused_rope_attention_bwd.stage_launches == n0 + 2 * per_call
    for name, x, y in zip(GRAD_NAMES, first, second):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), f"{name} differs between two runs"


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,dv", [(224, 56, 56), (176, 44, 44),
                                    (256, 64, 64), (208, 52, 52),
                                    (44, 12, 12)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_layout_helpers_match_the_launch(cuda_device, s, d, dv,
                                                        use_mask):
    """The wrapper's shared-memory helpers give the sizes and K/V stages the
    C launches use."""
    assert ka.card_layout(s, d, dv, use_mask) == {
        "forward": (ka.smem_bytes(s, d, dv, use_mask),
                    ka.fwd_kv_stages(s, d, dv, use_mask)),
        "rows": ka.bwd_rows_smem_bytes(s, d, dv, use_mask),
        "keys": ka.bwd_keys_smem_bytes(s, d, dv, use_mask)}


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


# Conv shapes (S, B): flagship sizes, ragged S that no tile divides (the
# bf16 forward's 64 x 16 and backward's 16 x 32 tiles, the fp32 kernels'
# 8 x 32), B = 1, and a hires-cls-1024 conv S at B = 1.
CONV_SHAPES = [(80, 2), (224, 2), (83, 2), (20, 2), (176, 1), (1024, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", CONV_SHAPES)
def test_conv_residual_kernel_matches_plain(cuda_device, s, b):
    rng = np.random.default_rng(s)
    args = [_normal(rng, cuda_device, b, s, s, 3),
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", CONV_SHAPES)
def test_conv_residual_bf16_kernel_matches_plain(cuda_device, s, b):
    """The bf16 forward: within twice the plain bf16 version's error against
    the fp32 plain version; two launches bit-identical."""
    args, _ = _conv_args(np.random.default_rng(s + 3), cuda_device, b, s,
                         torch.bfloat16)
    n0 = kc.fused_conv_residual.launches
    got = kc.fused_conv_residual(*args, dtype=torch.bfloat16)
    again = kc.fused_conv_residual(*args, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert kc.fused_conv_residual.launches == n0 + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    plain = kc.fused_conv_residual_plain(*args, dtype=torch.bfloat16)
    ref = kc.fused_conv_residual_plain(args[0].float(), *args[1:],
                                       dtype=torch.float32)
    assert (got.float() - ref).abs().max() <= 2 * (
        plain.float() - ref).abs().max()


def _conv_args(rng, device, b, s, dtype=torch.float32):
    """x (B,S,S,3) in `dtype`, the fp32 weights, and an output gradient in
    `dtype`."""
    return ([_normal(rng, device, b, s, s, 3).to(dtype),
             _normal(rng, device, 32, 3, scale=0.3),
             _normal(rng, device, 32, scale=0.1),
             _normal(rng, device, 3, 3, 32, scale=0.3),
             _normal(rng, device, 32, scale=0.1),
             _normal(rng, device, 3, 32, scale=0.2),
             _normal(rng, device, 3, scale=0.1)],
            _normal(rng, device, b, s, s, 3, scale=0.5).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_fwd_resid_kernel_matches_plain(cuda_device, s, b, dtype):
    """y, h and acc: fp32 at rtol 2e-4 / atol 2e-5; bf16 each within twice
    the plain bf16 version's error against the fp32 plain version, and two
    launches bit-identical."""
    args, _ = _conv_args(np.random.default_rng(s + 1), cuda_device, b, s,
                         dtype)
    n0 = kc.conv_residual_fwd_resid.launches
    got = kc.conv_residual_fwd_resid(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert kc.conv_residual_fwd_resid.launches == n0 + 1
    plain = kc.conv_residual_fwd_resid_plain(*args, dtype=dtype)
    if dtype == torch.float32:
        for x, y in zip(got, plain):
            torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        return
    again = kc.conv_residual_fwd_resid(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = kc.conv_residual_fwd_resid_plain(args[0].float(), *args[1:],
                                           dtype=torch.float32)
    for name, x, y, r in zip(("y", "h", "acc"), got, plain, ref):
        assert x.dtype == y.dtype == dtype, name
        assert (x.float() - r).abs().max() <= 2 * (
            y.float() - r).abs().max(), name


def _conv_bwd_outputs(dx, wg):
    """dx and each of the 24 packed weight-grad columns."""
    return [("dx", dx)] + [(f"wg[:, {j}]", wg[:, j]) for j in range(24)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bwd_kernel_matches_plain(cuda_device, s, b, dtype):
    """fp32: dx and every weight-grad column within 1e-4 of its largest
    value; bf16: within twice the plain bf16 version's error against the
    fp32 plain version. Each call launches the kernel and the ordered
    weight-grad sum once."""
    args, g = _conv_args(np.random.default_rng(s + 2), cuda_device, b, s,
                         dtype)
    w = args[1:6]
    n0 = kc.conv_residual_bwd.launches
    n1 = kc.conv_weight_grad_sum.launches
    got = kc.conv_residual_bwd(args[0], g, *w, dtype=dtype)
    torch.cuda.synchronize()
    assert kc.conv_residual_bwd.launches == n0 + 1
    assert kc.conv_weight_grad_sum.launches == n1 + 1
    plain = kc.conv_residual_bwd_plain(args[0], g, *w, dtype=dtype)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    if dtype == torch.float32:
        for (name, x), (_, y) in zip(_conv_bwd_outputs(*got),
                                     _conv_bwd_outputs(*plain)):
            assert _norm_err(x, y) <= 1e-4, name
        return
    ref = kc.conv_residual_bwd_plain(args[0].float(), g.float(), *w,
                                     dtype=torch.float32)
    for (name, x), (_, y), (_, r) in zip(_conv_bwd_outputs(*got),
                                         _conv_bwd_outputs(*plain),
                                         _conv_bwd_outputs(*ref)):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", [(83, 2), (20, 1)])
def test_conv_bwd_bf16_partial_rows_match_staged_plain(cuda_device, s, b):
    """The bf16 backward's first launch at a ragged S: each of its
    partial weight-grad rows (one a CTA, in the grid's order) and dx within
    twice the staged plain version's bf16 error against its fp32 one."""
    args, g = _conv_args(np.random.default_rng(s + 5), cuda_device, b, s,
                         torch.bfloat16)
    w = args[1:6]
    dx, part = kc.launch_bwd(args[0], g, *w, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    plain = kc.conv_residual_bwd_partials_plain(args[0], g, *w,
                                                dtype=torch.bfloat16)
    ref = kc.conv_residual_bwd_partials_plain(args[0].float(), g.float(), *w,
                                              dtype=torch.float32)
    assert part.shape == plain[1].shape == ref[1].shape
    assert _norm_err(dx, ref[0]) <= 2 * _norm_err(plain[0], ref[0]) + 1e-6
    # One column of the row per (channel, sum): 32 x 17.
    for k in range(17):
        got, p, r = (t_[:, k::17] for t_ in (part, plain[1], ref[1]))
        assert _norm_err(got, r) <= 2 * _norm_err(p, r) + 1e-6, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bwd_kernel_deterministic(cuda_device, dtype):
    """No atomics: two launches give the same bits."""
    args, g = _conv_args(np.random.default_rng(9), cuda_device, 4, 176,
                         dtype)
    one = kc.conv_residual_bwd(args[0], g, *args[1:6], dtype=dtype)
    two = kc.conv_residual_bwd(args[0], g, *args[1:6], dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.gpu
def test_conv_bf16_gelu_error_bound(cuda_device):
    """The bf16 kernels' erf (csrc/conv_residual_common.cuh) within its
    stated bound of erff over 2^20 + 1 points of [-10, 10]; their GELU and
    its derivative within the bounds that follow (|x| / 2 and 1 / 2 times
    the erf's), plus a few fp32 ulps for the rounding and the SFU's exp."""
    x = torch.linspace(-10.0, 10.0, 2**20 + 1, device=cuda_device)
    erf, gelu, dgelu = kc.erf_bf16_probe(x)
    torch.cuda.synchronize()
    bound = kc.ERF_BF16_MAX_ERR
    err = float((erf - torch.erf(x * 0.7071067811865476)).abs().max())
    assert err <= bound, err
    x64 = x.double().cpu()
    want = kc.erf_bf16_probe(x64)   # the exact functions, float64
    ulp = 2.0 ** -23
    scale_g = x64.abs() / 2 * bound + ulp * want[1].abs() + 1e-12
    scale_d = 0.5 * bound + 4 * ulp
    for name, got, w, scale in (("gelu", gelu, want[1], scale_g),
                                ("dgelu", dgelu, want[2], scale_d)):
        over = (got.cpu().double() - w).abs() / scale
        assert float(over.max()) <= 1.0, (name, float(over.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [224, 83, 1024])
def test_conv_bf16_geometry_matches_helpers(cuda_device, s):
    """The C launches' grid, threads, shared memory and partial rows are
    the Python helpers' (which the CPU tests hold to the sources' notes);
    every bf16 kernel keeps the CTAs an SM its launch bound asks for and
    spills nothing."""
    got = kc.card_geometry(3, s)
    assert got["forward"] == (*kc.fwd_bf16_grid(3, s), kc.THREADS_BF16,
                              kc.fwd_bf16_smem() - kc._FWD_WEIGHTS_SMEM)
    assert got["backward"] == (*kc.bwd_bf16_grid(3, s), kc.THREADS_BF16,
                               kc.bwd_bf16_smem())
    assert got["bwd_rows"] == math.prod(kc.bwd_bf16_grid(3, s))
    occ = kc.card_occupancy()
    for name, smem, what in (
            ("conv_fwd_bf16_kernel<0>", kc.fwd_bf16_smem(), "forward"),
            ("conv_fwd_bf16_kernel<1> (save)", kc.fwd_bf16_smem(),
             "forward with residuals"),
            ("conv_bwd_bf16_kernel<31>", kc.bwd_bf16_smem(), "backward")):
        assert occ[name]["smem_bytes"] == smem, name
        assert occ[name]["ctas_per_sm"] >= kc.MIN_CTAS_BF16[what], name
        assert occ[name]["spill_bytes"] == 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_conv_function_matches_autograd(cuda_device, route, monkeypatch):
    """`fused_conv_residual_train` on both backward routes against torch
    autograd of the plain forward, all seven gradients, fp32; each route
    launches its own kernels and no other."""
    monkeypatch.setenv("CALM_CONV_BWD", route)
    args, g = _conv_args(np.random.default_rng(11), cuda_device, 2, 80)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, dtype=torch.float32).backward(g)
        return [a.grad for a in leaves]

    counters = (kc.fused_conv_residual, kc.conv_residual_fwd_resid,
                kc.conv_residual_bwd)
    before = [c.launches for c in counters]
    got = grads(kc.fused_conv_residual_train)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    assert launched == ([1, 0, 1] if route == "pallas" else [0, 1, 0])
    want = grads(kc.fused_conv_residual_plain)
    for name, x, y in zip("x w1 b1 wd bd w2 b2".split(), got, want):
        assert _norm_err(x, y) <= 1e-4, name


# ---------------------------------------------------------------------------
# The long-sequence kernels (kernels/hires_attention.py) at the four stages
# of hires-cls-1024 (S, D = Dv).
HIRES_SHAPES = [(448, 112), (640, 160), (832, 208), (1024, 256)]
HIRES_BWD_NAMES = ("dq", "dssum", "dw1", "db1", "dw2", "db2", "dk", "dv")
SMEM_PER_BLOCK = 232_448   # the H100's dynamic shared memory per CTA


def _hires_inputs(rng, device, b, s, d, dtype):
    """q, k, v (B,H,S,D) in `dtype` and the mask weights (fp32), scaled so
    that scores, the mask hidden layer and m are all of order one."""
    def n(*shape, scale, dt=torch.float32):
        return _normal(rng, device, *shape, scale=scale).to(dt)

    return [n(b, H, s, d, scale=0.3, dt=dtype),
            n(b, H, s, d, scale=0.3, dt=dtype),
            n(b, H, s, d, scale=0.3, dt=dtype),
            n(2 * s, s, scale=0.2 / math.sqrt(s)), n(2 * s, scale=0.1),
            n(s, 2 * s, scale=1 / math.sqrt(2 * s)), n(s, scale=0.1)]


def _hires_bwd_all(kh, args, g, m, lse, delta, scale, dtype, plain):
    q, k, v, w1, b1, w2, _ = args
    kw = dict(scale=scale, dtype=dtype)
    dq_fn = kh.hires_dq_plain if plain else kh.hires_dq
    dkv_fn = kh.hires_dkv_plain if plain else kh.hires_dkv
    dq, dssum, dw1, db1, dw2, db2 = dq_fn(q, k, v, g, m, lse, delta, w1, b1,
                                          w2, **kw)
    dk, dv = dkv_fn(q, k, v, g, m, lse, delta, dssum, **kw)
    return dq, dssum, dw1, db1, dw2, db2, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("s,d", HIRES_SHAPES)
def test_hires_forward_kernels_match_plain(cuda_device, s, d):
    """The forward with residuals (kernel 1: o, m, lse) and the
    forward-only kernel (4, mask on and off) against their plain versions:
    fp32 at rtol 2e-4 / atol 2e-5, bf16 at most twice the plain bf16
    error."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(s)
    f32, bf16 = torch.float32, torch.bfloat16
    args = _hires_inputs(rng, cuda_device, 2, s, d, f32)
    scale = 1.0 / math.sqrt(d)
    n1, n4 = kh.fused_hires_attention.launches, \
        kh.fused_attention_forward.launches
    got = kh.hires_fwd_res(*args, scale=scale, dtype=f32)
    want = kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
    for use_mask in (True, False):
        out = kh.fused_attention_forward(*args, scale=scale, dtype=f32,
                                         use_mask=use_mask)
        ref = ka.attention_core(*args, scale=scale, dtype=f32,
                                use_mask=use_mask)
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    torch.cuda.synchronize()
    assert kh.fused_hires_attention.launches == n1 + 1
    assert kh.fused_attention_forward.launches == n4 + 2

    a16 = [a.to(bf16) if a.dim() == 4 else a for a in args]
    a32 = [a.float() for a in a16]
    k16 = kh.hires_fwd_res(*a16, scale=scale, dtype=bf16)
    p16 = kh.hires_fwd_res_plain(*a16, scale=scale, dtype=bf16)
    r32 = kh.hires_fwd_res_plain(*a32, scale=scale, dtype=f32)
    for x, y, r in zip(k16, p16, r32):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6
    out = kh.fused_attention_forward(*a16, scale=scale, dtype=bf16)
    plain = ka.attention_core(*a16, scale=scale, dtype=bf16, use_mask=True)
    assert _norm_err(out, r32[0]) <= 2 * _norm_err(plain, r32[0]) + 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("s,d", HIRES_SHAPES)
def test_hires_forward_kernels_bf16_deterministic(cuda_device, s, d):
    """The bf16 forward with residuals (o, m, lse) and the forward-only
    kernel give the same bits from two launches."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(s + 2)
    bf16 = torch.bfloat16
    args = _hires_inputs(rng, cuda_device, 2, s, d, bf16)
    kw = dict(scale=1.0 / math.sqrt(d), dtype=bf16)
    first = kh.hires_fwd_res(*args, **kw)
    again = kh.hires_fwd_res(*args, **kw)
    for name, x, y in zip(("o", "m", "lse"), first, again):
        assert torch.equal(x, y), f"{name} differs between two runs"
    assert torch.equal(kh.fused_attention_forward(*args, **kw),
                       kh.fused_attention_forward(*args, **kw))


def _assert_dkv_launches(kh, launches, stages, calls):
    """`calls` dk/dv passes since the counts were `launches`, `stages`: each
    one kernel (no stage launches) whose CTA fits the card's shared
    memory."""
    assert kh.hires_dkv.launches == launches + calls
    assert kh.hires_dkv.stage_launches == stages
    assert 0 < kh.hires_dkv.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.gpu
@pytest.mark.parametrize("s,d", HIRES_SHAPES)
def test_hires_backward_kernels_match_plain(cuda_device, s, d):
    """The dq pass (kernel 2, with its weight-grad reduction) and the dk/dv
    pass (kernel 3): fp32 within 1e-4 of each output's largest value, the
    same bits from two launches, bf16 at most twice the plain bf16 error;
    the dk/dv launches and stage launches as its C entry reports them."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(s + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    args = _hires_inputs(rng, cuda_device, 2, s, d, f32)
    g = _normal(rng, cuda_device, 2, H, s, d, scale=0.3)
    o, m, lse = kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)
    delta = (g * o).sum(-1)
    n2, n3 = kh.hires_dq.launches, kh.hires_dkv.launches
    s3 = kh.hires_dkv.stage_launches
    got = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, False)
    again = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, False)
    want = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, True)
    torch.cuda.synchronize()
    assert kh.hires_dq.launches == n2 + 2
    _assert_dkv_launches(kh, n3, s3, 2)
    for name, x, y, z in zip(HIRES_BWD_NAMES, got, want, again):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert _norm_err(x, y) <= 1e-4, name
        assert torch.equal(x, z), f"{name} differs between two runs"

    a16 = [a.to(bf16) if a.dim() == 4 else a for a in args]
    g16 = g.to(bf16)
    o16, m16, lse16 = kh.hires_fwd_res_plain(*a16, scale=scale, dtype=bf16)
    delta16 = (g16.float() * o16.float()).sum(-1)
    k16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         False)
    p16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         True)
    r32 = _hires_bwd_all(kh, [a.float() for a in a16], g16.float(), m16,
                         lse16, delta16, scale, f32, True)
    again16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                             False)
    torch.cuda.synchronize()
    _assert_dkv_launches(kh, n3, s3, 4)
    for name, x, y, r, z in zip(HIRES_BWD_NAMES, k16, p16, r32, again16):
        assert x.dtype == y.dtype, name
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name
        assert torch.equal(x, z), f"bf16 {name} differs between two runs"


@pytest.mark.gpu
def test_hires_kernels_ragged_shape_match_plain(cuda_device):
    """S = 520 and D = Dv = 120, multiples of none of the bf16 kernels'
    tiles (64 rows, 64-column chunks, k-steps of 16): the ragged rows and
    keys are masked and the columns zero-padded. Forward and both backward
    passes in fp32 against plain, and in bf16 at most twice the plain bf16
    error, the bf16 dk/dv the same bits from two launches and one kernel a
    call; a bf16 shape that is not a multiple of 8 raises."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(520)
    f32, bf16 = torch.float32, torch.bfloat16
    s, d = 520, 120
    scale = 1.0 / math.sqrt(d)
    args = _hires_inputs(rng, cuda_device, 2, s, d, f32)
    g = _normal(rng, cuda_device, 2, H, s, d, scale=0.3)
    for x, y in zip(kh.hires_fwd_res(*args, scale=scale, dtype=f32),
                    kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
    o, m, lse = kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)
    delta = (g * o).sum(-1)
    got = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, False)
    want = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, True)
    for name, x, y in zip(HIRES_BWD_NAMES, got, want):
        assert _norm_err(x, y) <= 1e-4, name

    a16 = [a.to(bf16) if a.dim() == 4 else a for a in args]
    a32 = [a.float() for a in a16]
    g16 = g.to(bf16)
    k16 = kh.hires_fwd_res(*a16, scale=scale, dtype=bf16)
    p16 = kh.hires_fwd_res_plain(*a16, scale=scale, dtype=bf16)
    r32 = kh.hires_fwd_res_plain(*a32, scale=scale, dtype=f32)
    for x, y, r in zip(k16, p16, r32):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6
    for use_mask in (True, False):
        out = kh.fused_attention_forward(*a16, scale=scale, dtype=bf16,
                                         use_mask=use_mask)
        plain = ka.attention_core(*a16, scale=scale, dtype=bf16,
                                  use_mask=use_mask)
        ref = ka.attention_core(*a32, scale=scale, dtype=f32,
                                use_mask=use_mask)
        assert _norm_err(out, ref) <= 2 * _norm_err(plain, ref) + 1e-6
    o16, m16, lse16 = p16
    delta16 = (g16.float() * o16.float()).sum(-1)
    n3, s3 = kh.hires_dkv.launches, kh.hires_dkv.stage_launches
    k16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         False)
    again16 = kh.hires_dkv(*a16[:3], g16, m16, lse16, delta16, k16[1],
                           scale=scale, dtype=bf16)
    torch.cuda.synchronize()
    _assert_dkv_launches(kh, n3, s3, 2)
    b16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         True)
    r32 = _hires_bwd_all(kh, a32, g16.float(), m16, lse16, delta16, scale,
                         f32, True)
    for name, x, y, r in zip(HIRES_BWD_NAMES, k16, b16, r32):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name
    for name, x, z in zip(("dk", "dv"), k16[6:], again16):
        assert torch.equal(x, z), f"bf16 {name} differs between two runs"

    odd = [a[:, :, :-4] if a.dim() == 4 else a for a in a16[:3]]
    with pytest.raises(ValueError, match="multiples of 8"):
        kh.fused_attention_forward(*odd, *a16[3:], scale=scale, dtype=bf16,
                                   use_mask=False)


@pytest.mark.gpu
def test_hires_function_matches_autograd(cuda_device):
    """`fused_hires_attention` (kernels 1-3) against torch autograd of the
    plain forward, all seven gradients."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(5)
    s, d = 448, 112
    args = _hires_inputs(rng, cuda_device, 2, s, d, torch.float32)
    g = _normal(rng, cuda_device, 2, H, s, d, scale=0.3)
    kw = dict(scale=1.0 / math.sqrt(d), dtype=torch.float32)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, **kw).backward(g)
        return [a.grad for a in leaves]

    got = grads(kh.fused_hires_attention)
    want = grads(lambda *a, **k: ka.attention_core(*a, use_mask=True, **k))
    for name, x, y in zip("q k v w1 b1 w2 b2".split(), got, want):
        assert _norm_err(x, y) <= 1e-4, name


@pytest.mark.gpu
def test_train_cls_main_on_the_card_with_fused_conv(cuda_device, tmp_path,
                                                   monkeypatch):
    """The trainer CLI on the card, tiny-cls, CALM_CONV_FUSED=1: two steps,
    8 forward and 8 backward conv launches each (one per Block), a
    checkpoint, finite loss."""
    from calm_vit_dte_tpu_torch.train import train_cls

    monkeypatch.setenv("CALM_CONV_FUSED", "1")
    monkeypatch.delenv("CALM_CONV_BWD", raising=False)
    counters = (kc.fused_conv_residual, kc.conv_residual_bwd,
                kc.conv_weight_grad_sum, kc.conv_residual_fwd_resid)
    before = [c.launches for c in counters]
    state = train_cls.main(["--config", "tiny-cls", "--max-steps", "2",
                            f"checkpoint_dir={tmp_path}", "epochs=1",
                            "dataset_root=synthetic", "num_workers=2"])
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [16, 16,
                                                                  16, 0]
    assert state.step == 2 and state.device.type == "cuda"
    assert (tmp_path / "step_2.pt").exists()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


RELAYOUT_SHAPES = [(224, 56), (176, 44), (128, 32), (80, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,d", RELAYOUT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relayout_kernel_bit_identical(cuda_device, s, d, dtype):
    """The (s, h, d) -> (h, s, d) relayout at each flagship head split, B=128:
    a copy, so bit-identical to the transpose."""
    from calm_vit_dte_tpu_torch.kernels import relayout as kr

    x = _normal(np.random.default_rng(s), cuda_device, 128, s, H, d).to(dtype)
    n0 = kr.swap_seq_heads.launches
    y = kr.swap_seq_heads(x)
    torch.cuda.synchronize()
    assert kr.swap_seq_heads.launches == n0 + 1
    assert y.shape == (128, H, s, d) and y.is_contiguous()
    assert torch.equal(y, kr.swap_seq_heads_plain(x))


@pytest.mark.gpu
def test_relayout_kernel_rejects_what_it_does_not_take(cuda_device):
    from calm_vit_dte_tpu_torch.kernels import relayout as kr

    x = torch.zeros(2, 8, H, 20, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kr.swap_seq_heads(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        kr.swap_seq_heads(x.half())


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", ["int8", "int8-wo"])
def test_quantized_tiny_predictor_card_vs_cpu(cuda_device, quantize):
    """The int8 tiny-cls Predictor, fp32, on the card against the same
    weights on the CPU (2 images). Weight-only (int8-wo): exact int8 weights
    and fp32 products on both, so the fp32 full-model limit of
    tests/test_parity_full224.py applies. w8a8 (int8): the int32 products
    are exact on both, but an activation within a last bit of a rounding
    boundary lands on different int8 values on the two devices, a whole
    quantization step, so the JAX package's limits for a quantized forward
    apply (tests/test_quantize.py:157-162: relative error < 0.15, top-1
    agreement)."""
    import copy

    from calm_vit_dte_tpu_torch.quantize import int8_matmul
    from calm_vit_dte_tpu_torch.serve import Predictor

    p = Predictor.fresh("tiny-cls", device=cuda_device, dtype=torch.float32)
    cpu_model = copy.deepcopy(p.model).cpu()
    p_gpu = Predictor(p.model, crop=p.crop, dtype=torch.float32,
                      quantize=quantize)
    p_cpu = Predictor(cpu_model, crop=p.crop, dtype=torch.float32,
                      quantize=quantize)
    assert torch.equal(p_gpu.model.head["0"].w_q.cpu(),
                       cpu_model.head["0"].w_q)
    images = np.random.default_rng(0).integers(0, 256, (2, 56, 56, 3),
                                               dtype=np.uint8)
    got, _ = p_gpu.predict(images)
    want, _ = p_cpu.predict(images)
    got = got.cpu()
    if quantize == "int8-wo":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    else:
        assert torch.linalg.norm(got - want) < 0.15 * torch.linalg.norm(want)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    # The int8 product itself: card (torch._int_mm, padded) == CPU, exactly.
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 44), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (36, 44), dtype=np.int8))
    assert torch.equal(int8_matmul(a.to(cuda_device), w.to(cuda_device))
                       .cpu(), int8_matmul(a, w))
