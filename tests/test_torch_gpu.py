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
from calm_vit_dte_tpu_torch.ops import attention as ops_attention
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


# The fp32 route (CUDA cores) at B = 1 and 2: shapes whose Dc and Dv are
# odd (the fp32 route alone takes them; D off the multiple of 4 is padded),
# a flagship shape and Dr = 0.
F32_SHAPES = [(80, 9, 10, 19), (44, 3, 4, 5), (224, 28, 28, 56),
              (80, 20, 0, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s,dc,dr,dv", F32_SHAPES)
@pytest.mark.parametrize("use_mask", [True, False])
def test_rope_attention_f32_route_matches_plain(cuda_device, b, s, dc, dr,
                                                dv, use_mask):
    """fp32: the forward at rtol 2e-4 / atol 2e-5 and all 13 gradients
    within 1e-4 of each one's largest value against the plain versions; the
    backward twice bit for bit; each call's stage launches
    `f32_stage_launches` and its hires calls' shared memory a CTA
    `f32_smem_bytes`."""
    rng = np.random.default_rng(100 * b + s + dc + dv)
    args, _ = _attention_inputs(rng, cuda_device, b, s, dc, dr,
                                torch.float32)
    args[4] = _normal(rng, cuda_device, b, H, s, dv, scale=0.3)
    g = _normal(rng, cuda_device, b, H, s, dv, scale=0.3)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=torch.float32,
              use_mask=use_mask)
    counters = (ka.fused_rope_attention, ka.fused_rope_attention_bwd)
    before = [(w.launches, w.stage_launches) for w in counters]
    out = ka.fused_rope_attention(*args, **kw)
    got = ka.fused_rope_attention_bwd(g, *args, **kw)
    again = ka.fused_rope_attention_bwd(g, *args, **kw)
    torch.cuda.synchronize()
    per = ka.f32_stage_launches(use_mask)
    assert [(w.launches - n, w.stage_launches - m)
            for w, (n, m) in zip(counters, before)] == [
        (1, per["forward"]), (2, 2 * per["backward"])]
    assert ka.fused_rope_attention_bwd.f32_smem_bytes == \
        ka.f32_smem_bytes(s, dc + dr, dv)
    torch.testing.assert_close(
        out, ka.fused_rope_attention_plain(*args, **kw), rtol=2e-4,
        atol=2e-5)
    want = ka.fused_rope_attention_bwd_plain(g, *args, **kw)
    for name, x, y, z in zip(GRAD_NAMES, got, want, again):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert _norm_err(x, y) <= 1e-4, name
        assert torch.equal(x, z), f"{name} differs between two runs"


@pytest.mark.gpu
def test_rope_attention_f32_route_kernels_do_not_spill(cuda_device):
    """The fp32 route's own kernels, the strided product and the CUDA-core
    hires kernels it runs, as the runtime reports them: no spill, at least
    one CTA an SM."""
    occ = ka.f32_occupancy()
    assert set(ka.F32_OCCUPANCY_KERNELS) <= set(occ)
    for name, o in occ.items():
        assert o["spill_bytes"] == 0 and o["ctas_per_sm"] >= 1, (name, o)


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
# forward's 64 x 16 and the backward's 16 x 32 tiles, in both compute
# types), B = 1, and a hires-cls-1024 conv S at B = 1.
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
    again = kc.fused_conv_residual(*args, dtype=torch.float32)
    torch.cuda.synchronize()
    assert kc.fused_conv_residual.launches == n0 + 2
    assert torch.equal(out, again)   # two fp32 launches, the same bits
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
@pytest.mark.parametrize("s,b", [(83, 2), (20, 1), (224, 1)])
def test_conv_bwd_f32_partial_rows_match_staged_plain(cuda_device, s, b):
    """The fp32 backward's first launch, on the bf16 kernel's grid: each of
    its partial weight-grad rows (one a CTA, in the grid's order) and dx
    within 1e-4 of the staged plain version's largest value (the sums are
    taken in another order)."""
    args, g = _conv_args(np.random.default_rng(s + 6), cuda_device, b, s)
    w = args[1:6]
    dx, part = kc.launch_bwd(args[0], g, *w, dtype=torch.float32)
    torch.cuda.synchronize()
    want_dx, want = kc.conv_residual_bwd_partials_plain(
        args[0], g, *w, dtype=torch.float32)
    assert part.shape == want.shape == (math.prod(kc.bwd_grid(b, s)),
                                        32 * 17)
    assert _norm_err(dx, want_dx) <= 1e-4
    for k in range(17):
        assert _norm_err(part[:, k::17], want[:, k::17]) <= 1e-4, k


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


def _conv_geometry_matches_helpers(s, dtype):
    """The C launches' grid, threads, shared memory and partial rows in
    `dtype` are the Python helpers' (which the CPU tests hold to the
    sources' notes); every kernel of `dtype` keeps the CTAs an SM its
    launch bound asks for and spills nothing."""
    got = kc.card_geometry(3, s, dtype)
    for what, save in (("forward", False), ("forward with residuals", True)):
        assert got[what] == (*kc.fwd_grid(3, s, dtype, save), kc.THREADS,
                             kc.fwd_smem(dtype, save) - kc._FWD_WEIGHTS_SMEM)
    assert got["backward"] == (*kc.bwd_grid(3, s), kc.THREADS,
                               kc.bwd_smem())
    assert got["bwd_rows"] == math.prod(kc.bwd_grid(3, s))
    occ = kc.card_occupancy()
    for what, want in kc.MIN_CTAS[dtype].items():
        name = kc.KERNEL_NAMES[(dtype, what)]
        smem = (kc.bwd_smem() if what == "backward" else
                kc.fwd_smem(dtype, what == "forward with residuals"))
        assert occ[name]["smem_bytes"] == smem, name
        assert occ[name]["ctas_per_sm"] >= want, name
        assert occ[name]["spill_bytes"] == 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("s", [224, 83, 1024])
def test_conv_bf16_geometry_matches_helpers(cuda_device, s):
    _conv_geometry_matches_helpers(s, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [224, 83, 1024])
def test_conv_f32_geometry_matches_helpers(cuda_device, s):
    _conv_geometry_matches_helpers(s, torch.float32)


@pytest.mark.gpu
def test_conv_f32_gelu_matches_exact(cuda_device):
    """The fp32 kernels' GELU and GELU' (one erff, one expf) against the
    exact functions in float64, over 2^20 + 1 points of [-10, 10]: within a
    few fp32 ulps of each value plus erff's own error scaled by |x|."""
    x = torch.linspace(-10.0, 10.0, 2**20 + 1, device=cuda_device)
    gelu, dgelu = kc.gelu_f32_probe(x)
    torch.cuda.synchronize()
    x64 = x.double().cpu()
    want = kc.gelu_f32_probe(x64)
    ulp = 2.0 ** -23
    # erff is within 2 ulps (<= 1.2e-7 near +-1): Phi within 6e-8.
    tols = (4 * ulp * want[0].abs() + 2e-7 * x64.abs() + 1e-30,
            8 * ulp * want[1].abs() + 2e-7 * (1 + x64.abs()))
    for name, got, w, tol in zip(("gelu", "dgelu"), (gelu, dgelu), want,
                                 tols):
        over = (got.cpu().double() - w).abs() / tol
        assert float(over.max()) <= 1.0, (name, float(over.max()))


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


# The CUDA-core dk/dv kernel at its edges, (dtype, H, S, D, Dv, mask):
# the rope route's shapes (D = pad4(Dc + Dr), S 80-256, NV 1), mask on and
# off; S a multiple of neither 64 nor 128; D != Dv with one output's second
# slice empty (each way); two and three slices; bf16 off the multiple of 8
# (the register path: D 44, S 1020).
DKV_EDGES = [("float32", 12, 80, 20, 20, True),
             ("float32", 12, 80, 20, 20, False),
             ("float32", 12, 224, 56, 56, True),
             ("float32", 12, 256, 64, 64, False),
             ("float32", 4, 200, 72, 40, True),
             ("float32", 2, 192, 264, 56, True),
             ("float32", 2, 192, 56, 264, True),
             ("float32", 2, 256, 512, 512, True),
             ("float32", 2, 136, 520, 520, True),
             ("bfloat16", 4, 200, 44, 44, True),
             ("bfloat16", 2, 1020, 64, 64, True)]


@pytest.mark.gpu
def test_hires_dkv_cuda_cores_occupancy(cuda_device):
    """The CUDA-core dk/dv kernel (cp.async staging) as the runtime reports
    it: `dkv_smem` of shared memory a CTA and no spill at NV 1-4, and two
    CTAs an SM at NV 1, the rope route's widths."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    occ = kh.cuda_core_occupancy()
    for nv in range(1, 5):
        o = occ[f"hires_dkv_kernel<float, {nv}>"]
        assert o["smem_bytes"] == ka.dkv_smem(nv), (nv, o)
        assert o["spill_bytes"] == 0, (nv, o)
        assert o["ctas_per_sm"] >= (2 if nv == 1 else 1), (nv, o)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,s,d,dv,use_mask", DKV_EDGES)
def test_hires_dkv_cuda_cores_edges(cuda_device, dtype, h, s, d, dv,
                                    use_mask):
    """The CUDA-core dk/dv kernel against `hires_dkv_plain`: fp32 within
    1e-4 of each output's largest value, bf16 at most twice the plain bf16
    error; two launches the same bits; one kernel a call on the CUDA cores,
    whose CTA asks for `dkv_smem` of its slice's NV (`dkv_split`)."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    dt, f32 = getattr(torch, dtype), torch.float32
    rng = np.random.default_rng(s + d + 3 * dv)

    def n(*shape, scale):
        return _normal(rng, cuda_device, *shape, scale=scale)

    w = [n(2 * s, s, scale=0.2 / math.sqrt(s)), n(2 * s, scale=0.1),
         n(s, 2 * s, scale=1 / math.sqrt(2 * s)), n(s, scale=0.1)]
    if not use_mask:
        w = [torch.zeros_like(t) for t in w]
    args = [n(2, h, s, d, scale=0.3).to(dt), n(2, h, s, d, scale=0.3).to(dt),
            n(2, h, s, dv, scale=0.3).to(dt), *w]
    g = n(2, h, s, dv, scale=0.3).to(dt)
    scale = 1.0 / math.sqrt(d)
    o, m, lse = kh.hires_fwd_res_plain(*args, scale=scale, dtype=dt)
    delta = (g.float() * o.float()).sum(-1)
    q, k, v, w1, b1, w2, _ = args
    dssum = kh.hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2,
                              scale=scale, dtype=dt)[1]
    res = (m, lse, delta, dssum)
    n3, s3 = kh.hires_dkv.launches, kh.hires_dkv.stage_launches
    cc = kh.hires_dkv.cuda_core_launches
    got = kh.hires_dkv(q, k, v, g, *res, scale=scale, dtype=dt)
    again = kh.hires_dkv(q, k, v, g, *res, scale=scale, dtype=dt)
    torch.cuda.synchronize()
    _assert_dkv_launches(kh, n3, s3, 2)
    assert kh.hires_dkv.cuda_core_launches == cc + 2
    nv = ka.dkv_split(d, dv)[2]
    if (dt != f32 or d % 4 or dv % 4) and nv == 3:   # the register path
        nv = 4
    assert kh.hires_dkv.smem_bytes == ka.dkv_smem(nv)
    want = kh.hires_dkv_plain(q, k, v, g, *res, scale=scale, dtype=dt)
    ref = kh.hires_dkv_plain(q.float(), k.float(), v.float(), g.float(),
                             *res, scale=scale, dtype=f32)
    for name, x, y, r, z in zip(("dk", "dv"), got, want, ref, again):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert torch.equal(x, z), f"{name} differs between two runs"
        if dt == f32:
            assert _norm_err(x, y) <= 1e-4, name
        else:
            assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name


@pytest.mark.gpu
def test_hires_kernels_ragged_shape_match_plain(cuda_device):
    """S = 520 and D = Dv = 120, multiples of none of the bf16 kernels'
    tiles (64 rows, 64-column chunks, k-steps of 16): the ragged rows and
    keys are masked and the columns zero-padded. Forward and both backward
    passes in fp32 against plain, and in bf16 at most twice the plain bf16
    error, the bf16 dk/dv the same bits from two launches and one kernel a
    call; a bf16 S that is not a multiple of 8 runs the CUDA-core kernels
    within twice the plain bf16 error."""
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

    # A bf16 S off the multiple of 8 takes the CUDA-core kernels.
    odd = [a[:, :, :-4].contiguous() for a in a16[:3]]
    assert not kh.tensor_cores(s - 4, d, d, bf16)
    out = kh.fused_attention_forward(*odd, *a16[3:], scale=scale, dtype=bf16,
                                     use_mask=False)
    plain = ka.attention_core(*odd, *a16[3:], scale=scale, dtype=bf16,
                              use_mask=False)
    ref = ka.attention_core(*[a.float() for a in odd], *a16[3:], scale=scale,
                            dtype=f32, use_mask=False)
    assert _norm_err(out, ref) <= 2 * _norm_err(plain, ref) + 1e-6


# Shapes of the CUDA-core kernels (every fp32 call) and past the D, Dv <=
# 256 tensor-core kernels, (H, S, D, Dv): the six-head hires-cls-1024
# stages (D over 256: the output split over the grid or the dq CTA's warp
# groups), a D unequal to Dv on both sides of 256 (a partial slice on the D
# side; Dv past 256 with D below it), D = Dv 16 past the wide dq kernel's
# limit (its pass on the CUDA cores), a bf16 S off the multiple of 8, and
# bf16 head dims off the multiple with an S off it; then the CUDA-core
# kernels' tiling edges: S off the multiple of 64 (and of the 128-key
# tile), fp32 D off the multiple of 4 (no cp.async staging), D = Dv = 520
# (just past the 512 output columns of one CTA), D and Dv unequal on both
# sides of 512, and a twelve-head fp32 shape at D <= 256.
WIDE_SHAPES = [(6, 1024, 512, 512), (6, 832, 416, 416), (6, 640, 320, 320),
               (4, 256, 264, 200), (4, 256, 200, 264), (1, 128, 560, 560),
               (4, 1020, 256, 256), (3, 192, 130, 300), (2, 132, 76, 36),
               (2, 200, 64, 96), (2, 130, 66, 34), (1, 192, 520, 520),
               (1, 192, 576, 136), (1, 192, 136, 576), (12, 448, 112, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,s,d,dv", WIDE_SHAPES,
                         ids=lambda x: str(x))
def test_hires_cuda_core_kernels_match_plain(cuda_device, h, s, d, dv):
    """The four hires kernels at WIDE_SHAPES: in fp32 the CUDA-core
    kernels; in bf16 the tensor-core kernels where S, D, Dv are multiples of
    8 (the wide ones past 256; the dq pass past D, Dv 544 on the CUDA
    cores), else the CUDA-core kernels, as the wrappers' counters show.
    fp32 forward at rtol 2e-4 / atol 2e-5 and backward within 1e-4 of each
    output's largest value, bf16 at most twice the plain bf16 error and the
    same bits from two launches."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    rng = np.random.default_rng(s + d + dv)
    f32, bf16 = torch.float32, torch.bfloat16
    assert kh.refusal(s, d, dv, bf16) is None
    aligned = not (s % 8 or d % 8 or dv % 8)
    dq_tc = aligned and max(d, dv) <= kh.TC_MAX_D["dq"][0]
    assert kh.tensor_cores(s, d, dv, bf16) == dq_tc
    assert kh.tensor_cores(s, d, dv, bf16, "fwd") == aligned
    assert kh.tensor_cores(s, d, dv, bf16, "dkv") == aligned
    assert kh.tensor_cores(s, d, dv, bf16, "dq") == dq_tc
    wrappers = (kh.fused_hires_attention, kh.fused_attention_forward,
                kh.hires_dq, kh.hires_dkv)

    def families():
        return [(fn.cuda_core_launches, fn.wide_launches)
                for fn in wrappers]

    def n(*shape, scale):
        return _normal(rng, cuda_device, *shape, scale=scale)

    args = [n(2, h, s, d, scale=0.3), n(2, h, s, d, scale=0.3),
            n(2, h, s, dv, scale=0.3), n(2 * s, s, scale=0.2 / math.sqrt(s)),
            n(2 * s, scale=0.1), n(s, 2 * s, scale=1 / math.sqrt(2 * s)),
            n(s, scale=0.1)]
    g = n(2, h, s, dv, scale=0.3)
    scale = 1.0 / math.sqrt(d)
    for x, y in zip(kh.hires_fwd_res(*args, scale=scale, dtype=f32),
                    kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
    for use_mask in (True, False):
        torch.testing.assert_close(
            kh.fused_attention_forward(*args, scale=scale, dtype=f32,
                                       use_mask=use_mask),
            ka.attention_core(*args, scale=scale, dtype=f32,
                              use_mask=use_mask), rtol=2e-4, atol=2e-5)
    o, m, lse = kh.hires_fwd_res_plain(*args, scale=scale, dtype=f32)
    delta = (g * o).sum(-1)
    got = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, False)
    want = _hires_bwd_all(kh, args, g, m, lse, delta, scale, f32, True)
    for name, x, y in zip(HIRES_BWD_NAMES, got, want):
        assert x.shape == y.shape, name
        assert _norm_err(x, y) <= 1e-4, name

    a16 = [a.to(bf16) if a.dim() == 4 else a for a in args]
    a32 = [a.float() for a in a16]
    g16 = g.to(bf16)
    before = families()
    k16 = kh.hires_fwd_res(*a16, scale=scale, dtype=bf16)
    p16 = kh.hires_fwd_res_plain(*a16, scale=scale, dtype=bf16)
    r32 = kh.hires_fwd_res_plain(*a32, scale=scale, dtype=f32)
    for x, y, r in zip(k16, p16, r32):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6
    for x, y in zip(k16, kh.hires_fwd_res(*a16, scale=scale, dtype=bf16)):
        assert torch.equal(x, y)
    out = kh.fused_attention_forward(*a16, scale=scale, dtype=bf16)
    plain = ka.attention_core(*a16, scale=scale, dtype=bf16, use_mask=True)
    assert _norm_err(out, r32[0]) <= 2 * _norm_err(plain, r32[0]) + 1e-6
    assert torch.equal(out, kh.fused_attention_forward(*a16, scale=scale,
                                                       dtype=bf16))
    o16, m16, lse16 = p16
    delta16 = (g16.float() * o16.float()).sum(-1)
    k16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         False)
    again = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                           False)
    # Two launches of each forward, then of each backward pass, counted by
    # the family that ran them.
    counts = {"cuda_core": (2, 0), "wide": (0, 2), "tensor_cores": (0, 0)}
    assert [(c - c0, w - w0) for (c, w), (c0, w0) in
            zip(families(), before)] == [
                counts[kh.family(s, d, dv, bf16, p_)]
                for p_ in ("fwd", "fwd", "dq", "dkv")]
    b16 = _hires_bwd_all(kh, a16, g16, m16, lse16, delta16, scale, bf16,
                         True)
    r32 = _hires_bwd_all(kh, a32, g16.float(), m16, lse16, delta16, scale,
                         f32, True)
    for name, x, y, r, z in zip(HIRES_BWD_NAMES, k16, b16, r32, again):
        assert _norm_err(x, r) <= 2 * _norm_err(y, r) + 1e-6, name
        assert torch.equal(x, z), f"bf16 {name} differs between two runs"


# The strided product's stagings, (A's, B's unit-stride axis): the heads'
# summed scores (k, k), the mask MLP (k, n), the weight grads (m, n).
STRIDE_ORDERS = [("k", "k"), ("k", "n"), ("m", "n"), ("m", "k")]


# (M, N, K): off every multiple (the register staging), multiples of 4
# (fp32: cp.async staging), and, in fp32, enough 128 x 128 tiles for that
# tiling.
PRODUCT_DIMS = [(197, 141, 83), (196, 140, 84), (1540, 1544, 84)]


@pytest.mark.gpu
@pytest.mark.parametrize("dims", PRODUCT_DIMS, ids=lambda x: str(x))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_fast,b_fast", STRIDE_ORDERS)
def test_hires_cuda_core_product_epilogues(cuda_device, a_fast, b_fast,
                                           dtype, dims):
    """The CUDA-core strided product (`gemm_kernel`) against torch at each
    staging of its operands and each epilogue: C = A B (+ bias) in fp32,
    rounded to the compute type, through the GELU with gelu' beside it,
    and times a given gelu'. Two batches, two heads summed (the outer
    contraction); each output within 1e-6 of the sum of its terms' sizes
    (the factor the epilogue puts on it included) of fp64 products of the
    same operands, plus one bf16 rounding where the output is bf16."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(17)
    z, ko = 2, 2
    m, n, k = dims
    a = _normal(rng, cuda_device, z, ko, m, k).to(dt)
    b = _normal(rng, cuda_device, z, ko, k, n).to(dt)
    # Stored with the unit-stride axis each staging asks for.
    a_st = a if a_fast == "k" else a.transpose(-1, -2).contiguous()
    b_st = b.transpose(-1, -2).contiguous() if b_fast == "k" else b
    sa = (ko * m * k, m * k) + ((k, 1) if a_fast == "k" else (1, m))
    sb = (ko * k * n, k * n) + ((1, k) if b_fast == "k" else (n, 1))
    want = (a.double() @ b.double()).sum(1)          # (z, m, n)
    # Sums of |terms|: an fp32 sum of them errs by a small multiple of
    # eps32 times this; 1e-6 (8.4 eps32) is well above its typical error.
    mag = (a.double().abs() @ b.double().abs()).sum(1)
    bias = _normal(rng, cuda_device, n, scale=0.5)
    gp = _normal(rng, cuda_device, z, m, n)
    h = want + bias.double()
    gelu = torch.nn.functional.gelu(h)
    dgelu = (0.5 * (1 + torch.erf(h / math.sqrt(2)))
             + h * torch.exp(-0.5 * h * h) / math.sqrt(2 * math.pi))
    # (reference, the factor the epilogue puts on the sum's error, gelu')
    cases = {"f32": (h, 1.0, None), "t": (h, 1.0, None),
             "gelu": (gelu, 1.2, dgelu),
             "dgelu_mul": (want * gp.double(), gp.double().abs(), None)}
    for epilogue, (ref, factor, ref2) in cases.items():
        out_dt = torch.float32 if epilogue == "f32" else dt
        c = torch.full((z, m, n), float("nan"), device=cuda_device,
                       dtype=out_dt)
        c2 = gp.clone() if epilogue == "dgelu_mul" else \
            torch.full((z, m, n), float("nan"), device=cuda_device)
        launched = kh.strided_product_cuda_cores(
            a_st, b_st, c, dims=(m, n, k, ko, z),
            strides=sa + sb + (m * n, n), epilogue=epilogue, dtype=dt,
            c2=c2, bias=None if epilogue == "dgelu_mul" else bias)
        torch.cuda.synchronize()
        assert launched == 1
        # One rounding to bf16 of the output, where it is bf16.
        rounding = 2 ** -8 if out_dt == torch.bfloat16 else 0.0
        bound = 1e-6 * mag * factor + 1e-6 + rounding * ref.abs()
        err = (c.double() - ref).abs()
        assert bool((err <= bound).all()), (
            epilogue, float((err - bound).max()))
        if ref2 is not None:
            err2 = (c2.double() - ref2).abs()
            assert bool((err2 <= 1e-6 * mag + 1e-6).all()), (
                "gelu'", float((err2 - 1e-6 * mag - 1e-6).max()))


# (B, S) of the weight grads alone: B*S rows that 8 ranges do not divide
# (the last ranges short, at (1, 9) three of them empty), an odd S (the
# partials' rows off 16 bytes), and S = 64 (bf16 split on the tensor cores).
WGRAD_SHAPES = [(1, 9), (2, 37), (3, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", WGRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hires_weight_grads_split_ranges_match_plain(cuda_device, b, s,
                                                     dtype):
    """`hires_weight_grads` against its plain version: fp32 (its products
    split over 8 fixed row ranges at every S; bf16 split on the tensor
    cores where S is a multiple of 8) within 1e-5 of each output's largest
    value; the same bits from two launches."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(b * 100 + s)
    ssum, dm = (_normal(rng, cuda_device, b, s, s).to(dt) for _ in "12")
    a, dh1 = (_normal(rng, cuda_device, b, s, 2 * s).to(dt) for _ in "12")
    got = kh.hires_weight_grads(ssum, dm, a, dh1)
    again = kh.hires_weight_grads(ssum, dm, a, dh1)
    want = kh.hires_weight_grads_plain(*(t.float() for t in
                                         (ssum, dm, a, dh1)))
    torch.cuda.synchronize()
    for name, x, y, z in zip(("dw1", "db1", "dw2", "db2"), got, want,
                             again):
        assert x.shape == y.shape and x.dtype == torch.float32, name
        assert _norm_err(x, y) <= 1e-5, name
        assert torch.equal(x, z), f"{name} differs between two runs"


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


@pytest.mark.gpu
def test_jax_init_weights_reconstruct_on_the_card(cuda_device):
    """The JAX package's seed-0 imagenet-reg-224 weights, rebuilt from the
    committed table with every digest matched, go to the card, and one
    bf16 reconstruct at B=2 runs through 24 attention and 9 conv launches
    with outputs in [0, 1]."""
    from calm_vit_dte_tpu_torch.compat import jax_init
    from calm_vit_dte_tpu_torch.models.vit import ViT
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    from calm_vit_dte_tpu_torch.serve import (
        WARMUP_POWER_ITERATIONS,
        Predictor,
    )
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    cfg = get_config("imagenet-reg-224")
    sd = jax_init.state_dict_from_jax_init(
        jax_init.table_path("imagenet-reg-224", 0))
    model = ViT(cfg.model, torch.Generator().manual_seed(1))
    model.load_state_dict(sd)
    model = model.eval().to(cuda_device)
    for k, v in model.state_dict().items():
        assert torch.equal(v.cpu(), sd[k]), k
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    pred = Predictor(model, crop=cfg.crop, config_name="imagenet-reg-224")
    images = np.random.default_rng(5).integers(
        0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    n_attn = ka.fused_rope_attention.launches
    n_conv = kc.fused_conv_residual.launches
    recon = pred.reconstruct(images)
    assert ka.fused_rope_attention.launches - n_attn == 24
    assert kc.fused_conv_residual.launches - n_conv == 9
    assert recon.shape == (2, cfg.crop, cfg.crop, 3)
    assert np.isfinite(recon).all() and 0 <= recon.min() <= recon.max() <= 1


@pytest.mark.gpu
def test_stage_dataset_on_the_cards_host(cuda_device, tmp_path, capsys):
    """tools/stage_dataset.py on the card's machine: a local tar staged,
    skipped on a re-run, and extracted to the class layout."""
    import io
    import tarfile

    from calm_vit_dte_tpu_torch.tools import stage_dataset

    src = tmp_path / "src"
    src.mkdir()
    inner = io.BytesIO()
    with tarfile.open(fileobj=inner, mode="w") as tf:
        info = tarfile.TarInfo("n01440764_1.JPEG")
        info.size = 3
        tf.addfile(info, io.BytesIO(b"img"))
    with tarfile.open(src / "ILSVRC2012_img_train.tar", "w") as tf:
        info = tarfile.TarInfo("n01440764.tar")
        info.size = len(inner.getvalue())
        tf.addfile(info, io.BytesIO(inner.getvalue()))
    argv = ["--src", str(src), "--dest", str(tmp_path / "dest"), "--files",
            "ILSVRC2012_img_train.tar", "--extract"]
    stage_dataset.main(argv)
    stage_dataset.main(argv)
    assert "already staged" in capsys.readouterr().out
    assert (tmp_path / "dest" / "train" / "n01440764" /
            "n01440764_1.JPEG").read_bytes() == b"img"


@pytest.mark.gpu
def test_dataplane_standalone_decode_on_the_cards_host(cuda_device,
                                                       tmp_path):
    """tools/bench_dataplane.py's standalone decode at 16 images: the native
    decoder builds and decodes on the card's host, beside Pillow."""
    from calm_vit_dte_tpu_torch.tools import bench_dataplane

    out = bench_dataplane.main([
        "--images", "16", "--n-train", "16", "--repeat", "1",
        "--skip-integrated", "--root", str(tmp_path / "corpus"),
        "--out", str(tmp_path / "out")])
    sa = out["standalone"]
    assert sa["n_images"] == 16 and "native" not in sa, sa
    assert all(sa[f"native_{t}t_img_per_s"] > 0 for t in (1, 2, 4))
    assert out["card"]["nvidia_smi"]


@pytest.mark.gpu
def test_profile_opt_on_the_card(cuda_device, tmp_path):
    """tools/profile_opt.py at 2 repetitions: FusedAdamW's variants and the
    yardsticks in ms between CUDA events and in device-busy ms from a
    profiler trace, beside a training step."""
    from calm_vit_dte_tpu_torch.tools import profile_opt

    out = profile_opt.main(["--reps", "2", "--warmup", "1", "--step-reps",
                            "2", "--step-batch", "8", "--out",
                            str(tmp_path)])
    assert out["timing"] == "event_ms"
    assert {"fused_adamw_fp32", "fused_adamw_bf16", "global_norm",
            "apply_fp32", "apply_bf16", "torch_adamw_fused",
            "torch_clip_adamw_fused"} == set(out["variants"])
    assert all(v["event_ms"] > 0 for v in out["variants"].values())
    assert all(v["busy_ms"] is None or v["busy_ms"] > 0
               for v in out["variants"].values())
    assert out["step"]["ms"] > 0


# Each limit of the dispatcher, as chip_smoke.py phase 15 (a) drives it:
# (inside, past, the route each takes, the dtypes).
ROUTE_LIMITS = [limit[1:] for limit in ops_attention.ROUTE_LIMITS]


def _route_leaves(rng, device, shape):
    """fp32 leaves of one attention call, {qc, qr, kc, kr, v, fq, fk} (or q,
    k, v with Dr = 0) and the mask tensors w1, b1, w2, b2."""
    b, h, sq, skv, dc, dr, dv = shape

    def n(*shp, scale=0.3):
        return _normal(rng, device, *shp, scale=scale)

    x = ({"q": n(b, h, sq, dc), "k": n(b, h, skv, dc)} if not dr else
         {"qc": n(b, h, sq, dc), "qr": n(b, h, sq, dr),
          "kc": n(b, h, skv, dc), "kr": n(b, h, skv, dr)})
    if dr:
        x["fq"] = 1.0 / (10000.0 ** (torch.arange(
            0, dr, 2, dtype=torch.float32, device=device) / dr))
        x["fk"] = x["fq"] * 1.1
    x.update(v=n(b, h, skv, dv), w1=n(2 * skv, skv, scale=0.2 / skv ** 0.5),
             b1=n(2 * skv, scale=0.1), w2=n(skv, 2 * skv,
                                             scale=(2 * skv) ** -0.5),
             b2=n(skv, scale=0.1))
    return x


def _kernel_call(x, kernel, dtype, use_mask):
    """The kernel's own wrapper on the leaves (q, k rotated in torch for the
    hires kernels; the rope kernel takes its tables)."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh

    w = [x[k] for k in ("w1", "b1", "w2", "b2")]
    if kernel == "hires":
        scale = 1.0 / math.sqrt(x["q"].shape[-1])
        return kh.fused_attention_forward(x["q"], x["k"], x["v"], *w,
                                          scale=scale, dtype=dtype,
                                          use_mask=use_mask)
    sq, skv = x["qr"].shape[2], x["kr"].shape[2]
    tabs = [*rope_tables(x["fq"], sq), *rope_tables(x["fk"], skv)]
    d = x["qc"].shape[-1] + x["qr"].shape[-1]
    cast = [x[k].to(dtype) for k in ("qc", "qr", "kc", "kr", "v")]
    return ka.fused_rope_attention(*cast, *tabs, *w, scale=d ** -0.5,
                                   dtype=dtype, use_mask=use_mask)


def _route_call(x, dtype, use_mask):
    from calm_vit_dte_tpu_torch.ops import attention as ops

    mask = tuple(x[k] for k in ("w1", "b1", "w2", "b2"))
    if "q" in x:
        return ops.masked_attention(x["q"], x["k"], x["v"], mask,
                                    dtype=dtype, use_mask=use_mask)
    return ops.masked_rope_attention(x["qc"], x["qr"], x["kc"], x["kr"],
                                     x["v"], x["fq"], x["fk"], mask,
                                     dtype=dtype, use_mask=use_mask)


@pytest.mark.gpu
@pytest.mark.parametrize("limit", ROUTE_LIMITS,
                         ids=["rope-dv", "hires-d", "hires-bf16-s", "sq-skv"])
def test_kernel_limits_launch_inside_and_past(cuda_device, limit):
    """At each limit the shape just inside launches its kernel once through
    its wrapper and through `masked_attention`; just past, a shape the
    kernel refuses raises from its wrapper and under 'auto' takes the next
    route without launching it, and a hires shape past the tensor-core
    kernels launches the hires kernels (each pass on the kernels
    `tensor_cores` names for it)."""
    from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
    from calm_vit_dte_tpu_torch.ops import attention as ops

    inside, past, kernel, after, dtypes = limit
    counter = (kh.fused_attention_forward if kernel == "hires"
               else ka.fused_rope_attention)
    rng = np.random.default_rng(15)
    for dtype in (getattr(torch, n) for n in dtypes):
        for use_mask in (True, False):
            for shape, want in ((inside, kernel), (past, after)):
                b, h, sq, skv, dc, dr, dv = shape
                why = "Sq != Skv" if sq != skv else (
                    kh.refusal(sq, dc + dr, dv, dtype) if kernel == "hires"
                    else ka.refusal(sq, dc, dr, dv, dtype, use_mask))
                assert (why is None) == (want == kernel), shape
                x = _route_leaves(rng, cuda_device, shape)
                n = counter.launches
                if why is None:
                    out = _kernel_call(x, kernel, dtype, use_mask)
                    torch.cuda.synchronize()
                    assert counter.launches == n + 1
                    assert torch.isfinite(out.float()).all()
                else:
                    with pytest.raises(ValueError):
                        _kernel_call(x, kernel, dtype, use_mask)
                    assert counter.launches == n
                calls = dict(ops.route_calls)
                hires = kh.fused_attention_forward.launches
                rope = ka.fused_rope_attention.launches
                with torch.no_grad():
                    out = _route_call(x, dtype, use_mask)
                torch.cuda.synchronize()
                assert (kh.fused_attention_forward.launches - hires,
                        ka.fused_rope_attention.launches - rope) == (
                    int(want == "hires"), int(want == "rope")), shape
                if want in ops.route_calls:
                    assert ops.route_calls[want] == calls[want] + 1
                assert out.shape == (b, h, sq, dv) and out.dtype == dtype
                assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("limit", [ROUTE_LIMITS[1], ROUTE_LIMITS[3]],
                         ids=["d264", "sq-skv"])
def test_route_on_the_card_matches_the_cpu(cuda_device, limit):
    """The shape past a limit through the attention ops, fp32, mask on and
    off (D = Dv = 264 on the hires kernels, Sq != Skv on the 'xla' route):
    the forward at rtol 2e-4 / atol 2e-5 and every leaf's gradient within
    1e-4 of its largest value, card against CPU."""
    b, h, sq, _, _, _, dv = past = limit[1]
    rng = np.random.default_rng(16)
    for use_mask in (True, False):
        x = {k: t.requires_grad_() for k, t in
             _route_leaves(rng, cuda_device, past).items()}
        xc = {k: t.detach().cpu().requires_grad_() for k, t in x.items()}
        g = _normal(rng, cuda_device, b, h, sq, dv)
        out = _route_call(x, torch.float32, use_mask)
        oc = _route_call(xc, torch.float32, use_mask)
        (out * g).sum().backward()
        (oc * g.cpu()).sum().backward()
        torch.testing.assert_close(out.detach().cpu(), oc.detach(),
                                   rtol=2e-4, atol=2e-5)
        for k, t in x.items():
            if xc[k].grad is not None:
                assert _norm_err(t.grad.cpu(), xc[k].grad) <= 1e-4, k
