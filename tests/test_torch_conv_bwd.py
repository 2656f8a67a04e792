"""The port's conv residual training path against the JAX package's Pallas
kernels (interpret mode), on the CPU.

On the CPU the port's wrappers run their plain versions: the forward that
saves h and acc, the recomputing backward, and the CALM_CONV_BWD=xla
backward over the saved residuals. They are held against
`fused_conv_residual(..., interpret=True)` and `jax.grad` through it, on the
same numpy inputs, at the JAX kernel tests' limits
(tests/test_kernels.py:249-275): forward rtol 2e-5 / atol 2e-5, gradients
rtol 1e-4 / atol 1e-5, fp32. CALM_CONV_BWD is set on both sides, so each
route of the port meets the same route of the JAX package. S = 20 is a
multiple of neither the kernels' 8-row nor their 32-column tile.
tests/test_torch_gpu.py holds the CUDA kernels against these plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.kernels.conv_residual import (
    fused_conv_residual as jax_fused_conv_residual,
)
from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.models.block import ConvResidual
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

NAMES = "x w1 b1 wd bd w2 b2".split()


def _inputs(s, seed=0, b=2):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(b, s, s, 3), n(32, 3, scale=0.3), n(32, scale=0.1),
            n(3, 3, 32, scale=0.3), n(32, scale=0.1), n(3, 32, scale=0.2),
            n(3, scale=0.1)]


@jax.jit
def _jax_forward(*args):
    return jax_fused_conv_residual(*args, dtype=jnp.float32, interpret=True)


def _jax_grads(args):
    """jax.grad of sum(sin(y)) through the interpret-mode kernels, with the
    backward route CALM_CONV_BWD selects at trace time."""
    def loss(*a):
        return jnp.sum(jnp.sin(jax_fused_conv_residual(
            *a, dtype=jnp.float32, interpret=True)))

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(
        *map(jnp.asarray, args))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("s", [32, 20])
def test_fwd_resid_plain_matches_jax(s):
    args = _inputs(s, seed=s)
    want = np.asarray(_jax_forward(*map(jnp.asarray, args)))
    y, h, acc = kc.conv_residual_fwd_resid(*map(torch.from_numpy, args),
                                           dtype=torch.float32)
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-5, atol=2e-5)
    assert h.shape == acc.shape == (2, s, s, 32)
    # h = gelu(W1 x + b1) and acc = dw3x3(h) + bd, the middle activations
    # the JAX kernel saves in its bordered layout.
    x, w1, b1, wd, bd = (torch.from_numpy(a) for a in args[:5])
    a1 = x @ w1.t() + b1
    torch.testing.assert_close(h, torch.nn.functional.gelu(a1), rtol=1e-6,
                               atol=1e-6)
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    ref_acc = bd + sum(hp[:, a:a + s, c:c + s] * wd[a, c]
                       for a in range(3) for c in range(3))
    torch.testing.assert_close(acc, ref_acc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("s", [32, 20])
def test_function_grads_match_jax(route, s, monkeypatch):
    monkeypatch.setenv("CALM_CONV_BWD", route)
    args = _inputs(s, seed=10 + s)
    want = _jax_grads(args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    torch.sin(kc.fused_conv_residual_train(*leaves, dtype=torch.float32)
              ).sum().backward()
    for name, leaf, w in zip(NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5, err_msg=f"grad of {name}")


def test_bwd_plain_packs_weight_grads_like_the_kernel():
    """conv_residual_bwd returns dx and the (32, 24) rows the TPU kernel
    packs (dwd 0:9, dbd 9, dw1 10:13, db1 13, dw2^T 14:17, zero 17:24); they
    unpack to torch autograd's gradients of the same forward."""
    args = [torch.from_numpy(a) for a in _inputs(20, seed=3)]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 20, 20, 3)).astype(np.float32))
    dx, wg = kc.conv_residual_bwd(args[0], g, *args[1:6],
                                  dtype=torch.float32)
    assert wg.shape == (32, 24) and not wg[:, 17:].any()
    leaves = [a.clone().requires_grad_() for a in args]
    kc.fused_conv_residual_plain(*leaves, dtype=torch.float32).backward(g)
    got = (dx,) + kc.unpack_weight_grads(wg)
    for name, x, leaf in zip(NAMES, got, leaves):
        torch.testing.assert_close(x, leaf.grad, rtol=1e-4, atol=1e-5,
                                   msg=f"grad of {name}")


@pytest.mark.parametrize("var,value", [("CALM_CONV_FUSED", "2"),
                                       ("CALM_CONV_FUSED", "true"),
                                       ("CALM_CONV_BWD", "lax"),
                                       ("CALM_CONV_BWD", "")])
def test_unknown_env_values_raise(var, value, monkeypatch):
    """An unknown value never selects another formulation silently."""
    monkeypatch.setenv("CALM_CONV_FUSED", "1")
    monkeypatch.setenv(var, value)
    conv = ConvResidual(torch.Generator().manual_seed(0)).train()
    x = torch.zeros(1, 8, 24)
    with pytest.raises(ValueError, match=var):
        conv(x, torch.float32)


@pytest.mark.parametrize("fused", ["", "0", "1"])
def test_conv_residual_dispatch(fused, monkeypatch):
    """CALM_CONV_FUSED picks the formulation, as `conv_residual_apply` does
    (only '1' trains through the Function); on the same weights every
    choice gives the same residual and the same input gradient."""
    gen = torch.Generator().manual_seed(1)
    conv = ConvResidual(gen)
    x = torch.randn(2, 12, 36, generator=gen)
    g = torch.randn(2, 12, 36, generator=gen)
    calls = []
    monkeypatch.setattr(kc._FusedConvResidual, "apply",
                        _recording(kc._FusedConvResidual.apply, calls))

    def run(mode, training):
        monkeypatch.setenv("CALM_CONV_FUSED", mode)
        leaf = x.clone().requires_grad_()
        conv.train(training)
        with prenormalized_scope(normalize_tree(conv, training=False)):
            y = conv(leaf, torch.float32)
        if not training:
            return y.detach(), None
        y.backward(g)
        return y.detach(), leaf.grad

    y_train, dx = run(fused, True)
    assert len(calls) == (1 if fused == "1" else 0)
    y_eval, _ = run(fused, False)
    y_ref, dx_ref = run("0", True)
    for got in (y_train, y_eval):
        torch.testing.assert_close(got, y_ref, rtol=1e-5, atol=1e-6)
    # The Function's explicit formulas against autograd of the conv chain:
    # the gradient limits of tests/test_kernels.py:275.
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-5)


def _recording(fn, calls):
    def wrapped(*a):
        calls.append(a[0])
        return fn(*a)

    return wrapped
