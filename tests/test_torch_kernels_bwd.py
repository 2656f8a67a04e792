"""The port's attention backward against the JAX package's Pallas backward.

On the CPU the port's backward wrapper runs its plain PyTorch version
(explicit formulas, not autograd); it is held here against `jax.grad`
through the Pallas kernels in interpret mode, on the same numpy inputs, at
the JAX kernel tests' own limits (fp32 rtol 5e-4 / atol 5e-5), and the
autograd Function against torch autograd of the plain forward.
tests/test_torch_gpu.py holds the CUDA kernel against the plain version on
the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.kernels.axial_attention import (
    fused_masked_attention as jax_fused_masked_attention,
)
from calm_vit_dte_tpu.kernels.axial_attention import (
    fused_rope_attention as jax_fused_rope_attention,
)
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.utils import remat

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

NAMES = "qc qr kc kr v cq sq ck sk w1 b1 w2 b2".split()
B, H, S = 2, 3, 48


def _inputs(dc, dr, seed=1):
    """numpy inputs of fused_rope_attention plus an output gradient; mask
    weights scaled like the JAX kernel tests. dr == 0: no rope half."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d = dc + dr
    t = np.arange(S, dtype=np.float32)
    inv = 1.0 / (10.0 ** (np.arange(0, max(dr, 2), 2, dtype=np.float32)
                          / max(dr, 2)))
    fr = np.concatenate([np.outer(t, inv)] * 2, axis=-1).astype(np.float32)
    rope = dict(qr=n(B, H, S, dr), kr=n(B, H, S, dr), cq=np.cos(fr),
                sq=np.sin(fr), ck=np.cos(fr * 1.1), sk=np.sin(fr * 1.1))
    inputs = {
        "qc": n(B, H, S, dc) if dc else None,
        "kc": n(B, H, S, dc) if dc else None,
        "v": n(B, H, S, d),
        "w1": n(2 * S, S, scale=1 / math.sqrt(S)), "b1": n(2 * S, scale=0.1),
        "w2": n(S, 2 * S, scale=1 / math.sqrt(2 * S)), "b2": n(S, scale=0.1),
        **{k: (v if dr else None) for k, v in rope.items()},
    }
    return inputs, n(B, H, S, d)


def _torch_args(inputs):
    return [None if inputs[k] is None else torch.from_numpy(inputs[k])
            for k in NAMES]


def _jax_grads(inputs, g, scale, use_mask):
    """jax.grad of sum(out * g) through the interpret-mode Pallas kernels,
    with respect to every input that is present."""
    present = [k for k in NAMES if inputs[k] is not None]
    if not use_mask:
        present = [k for k in present if k not in ("w1", "b1", "w2", "b2")]

    def loss(*vals):
        a = {k: (None if inputs[k] is None else jnp.asarray(inputs[k]))
             for k in NAMES}
        a.update(dict(zip(present, vals)))
        if a["qr"] is None:
            out = jax_fused_masked_attention(
                a["qc"], a["kc"], a["v"], a["w1"], a["b1"], a["w2"], a["b2"],
                scale=scale, dtype=jnp.float32, use_mask=use_mask,
                interpret=True)
        else:
            out = jax_fused_rope_attention(
                *(a[k] for k in NAMES), scale=scale, dtype=jnp.float32,
                use_mask=use_mask, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    grads = jax.grad(loss, argnums=tuple(range(len(present))))(
        *(jnp.asarray(inputs[k]) for k in present))
    return dict(zip(present, map(np.asarray, grads)))


@pytest.mark.parametrize("dc,dr", [(8, 8), (0, 8), (16, 0)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_plain_backward_matches_pallas_grad(dc, dr, use_mask):
    inputs, g = _inputs(dc, dr)
    scale = 1.0 / math.sqrt(dc + dr)
    got = ka.fused_rope_attention_bwd(
        torch.from_numpy(g), *_torch_args(inputs), scale=scale,
        dtype=torch.float32, use_mask=use_mask)
    assert ka.fused_rope_attention_bwd.launches == 0   # CPU: plain version
    want = _jax_grads(inputs, g, scale, use_mask)
    n_checked = 0
    for name, grad in zip(NAMES, got):
        if name not in want:
            assert grad is None, name
            continue
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)
        n_checked += 1
    assert n_checked == len(want)
    assert n_checked == (13 if dc and dr else 11 if dr else 7) - (
        0 if use_mask else 4)


@pytest.mark.parametrize("dc,dr", [(8, 8), (0, 8), (16, 0)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_function_matches_autograd_of_plain_forward(dc, dr, use_mask):
    """The autograd Function on the CPU (plain forward, explicit plain
    backward) against torch autograd of the plain forward."""
    inputs, g = _inputs(dc, dr, seed=2)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=torch.float32,
              use_mask=use_mask)

    def grads(fn):
        leaves = [None if a is None else a.requires_grad_()
                  for a in _torch_args(inputs)]
        fn(*leaves, **kw).backward(torch.from_numpy(g))
        return [None if a is None else a.grad for a in leaves]

    got = grads(ka.fused_rope_attention)
    want = grads(ka.fused_rope_attention_plain)
    for name, x, y in zip(NAMES, got, want):
        if use_mask or name not in ("w1", "b1", "w2", "b2"):
            assert (x is None) == (y is None), name
        if x is not None and y is not None:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=5e-4,
                                       atol=5e-5, err_msg=name)


def test_bf16_backward_returns_the_kernel_dtypes():
    """dqc/dqr in the compute dtype, everything else fp32, as the kernel
    writes them; the Function casts to the inputs' dtypes."""
    inputs, g = _inputs(8, 8)
    args = _torch_args(inputs)
    bf = [a.bfloat16() if a is not None and a.dim() == 4 else a for a in args]
    got = ka.fused_rope_attention_bwd(
        torch.from_numpy(g).bfloat16(), *bf, scale=0.25,
        dtype=torch.bfloat16)
    assert [x.dtype for x in got[:5]] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32,
        torch.float32]
    assert all(x.dtype == torch.float32 for x in got[5:])
    ref = ka.fused_rope_attention_bwd(torch.from_numpy(g), *args, scale=0.25,
                                      dtype=torch.float32)
    for name, x, y in zip(NAMES, got, ref):
        err = (x.float() - y).abs().max() / y.abs().max()
        assert err < 0.05, (name, float(err))
    leaves = [a.clone().requires_grad_() for a in bf]
    ka.fused_rope_attention(*leaves, scale=0.25, dtype=torch.bfloat16).sum(
        ).backward()
    assert all(a.grad.dtype == a.dtype for a in leaves)


def test_checkpoint_replay_reuses_the_attention_output(monkeypatch):
    """Under utils.remat.checkpoint the backward's replay does not run the
    attention forward again, and the gradients equal the un-checkpointed
    ones."""
    inputs, g = _inputs(8, 8, seed=3)
    kw = dict(scale=0.25, dtype=torch.float32)
    calls = []
    plain = ka.fused_rope_attention_plain
    monkeypatch.setattr(ka, "fused_rope_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))

    def run(checkpointed):
        leaves = [a.requires_grad_() for a in _torch_args(inputs)]

        def fn(*xs):
            return torch.tanh(ka.fused_rope_attention(*xs, **kw)) * 2.0

        out = remat.checkpoint(fn, *leaves) if checkpointed else fn(*leaves)
        out.backward(torch.from_numpy(g))
        return [a.grad for a in leaves]

    want = run(False)
    assert len(calls) == 1
    got = run(True)
    assert len(calls) == 2      # one forward, none in the replay
    for name, x, y in zip(NAMES, got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
