"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the Pallas kernels in interpret mode and against the XLA
oracle, on the same numpy inputs. tests/test_torch_gpu.py holds each CUDA
kernel against its plain version on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.kernels.axial_attention import (
    fused_rope_attention as jax_fused_rope_attention,
)
from calm_vit_dte_tpu.kernels.conv_residual import (
    fused_conv_residual as jax_fused_conv_residual,
)
from calm_vit_dte_tpu.ops import attention as jax_attention
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.ops import attention as port_attention

NAMES = "qc qr kc kr v cq sq ck sk w1 b1 w2 b2".split()


def _rope_inputs(b=2, h=3, s=48, dc=8, dr=8, seed=1):
    """numpy inputs of fused_rope_attention, mask weights scaled like the
    JAX kernel tests."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d = dc + dr
    t = np.arange(s, dtype=np.float32)
    inv = 1.0 / (10.0 ** (np.arange(0, dr, 2, dtype=np.float32) / dr))
    fr = np.concatenate([np.outer(t, inv)] * 2, axis=-1).astype(np.float32)
    return {
        "qc": n(b, h, s, dc) if dc else None,
        "qr": n(b, h, s, dr),
        "kc": n(b, h, s, dc) if dc else None,
        "kr": n(b, h, s, dr),
        "v": n(b, h, s, d),
        "cq": np.cos(fr), "sq": np.sin(fr),
        "ck": np.cos(fr * 1.1), "sk": np.sin(fr * 1.1),
        "w1": n(2 * s, s, scale=1 / math.sqrt(s)), "b1": n(2 * s, scale=0.1),
        "w2": n(s, 2 * s, scale=1 / math.sqrt(2 * s)), "b2": n(s, scale=0.1),
    }


def _as(kind, inputs):
    conv = jnp.asarray if kind == "jax" else torch.from_numpy
    return [None if inputs[k] is None else conv(inputs[k]) for k in NAMES]


def _xla_rope_oracle(qc, qr, kc, kr, v, cq, sq, ck, sk, w1, b1, w2, b2, *,
                     scale, use_mask):
    """Rotate/concat in XLA, then the JAX package's `_attention_core`."""
    def rot(x, c, s_):
        half = x.shape[-1] // 2
        return x * c + jnp.concatenate([-x[..., half:], x[..., :half]],
                                       axis=-1) * s_

    q, k = rot(qr, cq, sq), rot(kr, ck, sk)
    if qc is not None:
        q = jnp.concatenate([qc, q], axis=-1)
        k = jnp.concatenate([kc, k], axis=-1)
    return jax_attention._attention_core(q, k, v, w1, b1, w2, b2, scale=scale,
                                         dtype=jnp.float32, use_mask=use_mask)


@pytest.mark.parametrize("dc", [8, 0])
@pytest.mark.parametrize("use_mask", [True, False])
def test_plain_rope_attention_matches_pallas_and_xla(dc, use_mask):
    inputs = _rope_inputs(dc=dc)
    scale = 1.0 / math.sqrt(dc + 8)
    out = ka.fused_rope_attention(*_as("torch", inputs), scale=scale,
                                  dtype=torch.float32, use_mask=use_mask)
    pallas = jax_fused_rope_attention(*_as("jax", inputs), scale=scale,
                                      dtype=jnp.float32, use_mask=use_mask,
                                      interpret=True)
    xla = _xla_rope_oracle(*_as("jax", inputs), scale=scale,
                           use_mask=use_mask)
    assert ka.fused_rope_attention.launches == 0  # CPU: plain version only
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=1e-5,
                               atol=1e-5)


def _mask_tree(inputs):
    """JAX mask params and a spectral-norm state holding each weight's top
    singular vectors, so eval sigma is the true spectral norm (u, v far
    from them give a tiny sigma and an ill-conditioned, peaky softmax)."""
    params, state = {}, {}
    for fc, w, b in (("fc1", "w1", "b1"), ("fc2", "w2", "b2")):
        u, _, vt = np.linalg.svd(inputs[w].astype(np.float64))
        params[fc] = {"w": jnp.asarray(inputs[w]),
                      "b": jnp.asarray(inputs[b])}
        state[fc] = {"u": jnp.asarray(u[:, 0], jnp.float32),
                     "v": jnp.asarray(vt[0], jnp.float32)}
    return params, state


def _normalized_mask(params, state):
    from calm_vit_dte_tpu.nn.spectral_norm import spectral_normalize

    out = []
    for fc in ("fc1", "fc2"):
        w, _ = spectral_normalize(params[fc]["w"], state[fc], training=False)
        out += [torch.from_numpy(np.array(w)),
                torch.from_numpy(np.array(params[fc]["b"]))]
    return tuple(out)


@pytest.mark.parametrize("dc", [8, 0])
def test_masked_rope_attention_matches_jax(dc):
    """The ops entry point (tables from learned frequencies) vs the JAX
    package's CPU path."""
    dr = 8
    inputs = _rope_inputs(dc=dc, dr=dr)
    inv = (1.0 / (10.0 ** (np.arange(0, dr, 2, dtype=np.float32) / dr))
           ).astype(np.float32)
    mask_params, mask_state = _mask_tree(inputs)
    ref, _ = jax_attention.masked_rope_attention(
        *(None if inputs[k] is None else jnp.asarray(inputs[k])
          for k in ("qc", "qr", "kc", "kr", "v")),
        {"inv_freq": jnp.asarray(inv)}, {"inv_freq": jnp.asarray(inv * 1.3)},
        mask_params, mask_state, training=False, dtype=jnp.float32)
    out = port_attention.masked_rope_attention(
        *(None if inputs[k] is None else torch.from_numpy(inputs[k])
          for k in ("qc", "qr", "kc", "kr", "v")),
        torch.from_numpy(inv), torch.from_numpy(inv * 1.3),
        _normalized_mask(mask_params, mask_state), dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_mask", [True, False])
def test_masked_attention_matches_jax(use_mask):
    inputs = _rope_inputs(dc=16, dr=0)
    q, k, v = (inputs[n] for n in ("qc", "kc", "v"))
    mask_params, mask_state = _mask_tree(inputs)
    with jax_attention.attention_impl("xla"):
        ref, _ = jax_attention.masked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_params,
            mask_state, training=False, dtype=jnp.float32, use_mask=use_mask)
    out = port_attention.masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        _normalized_mask(mask_params, mask_state), dtype=torch.float32,
        use_mask=use_mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _conv_inputs(b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(b, s, s, 3), n(32, 3, scale=0.3), n(32, scale=0.1),
            n(3, 3, 32, scale=0.3), n(32, scale=0.1), n(3, 32, scale=0.2),
            n(3, scale=0.1)]


def test_plain_conv_residual_matches_pallas():
    args = _conv_inputs()
    ref = jax_fused_conv_residual(*map(jnp.asarray, args), dtype=jnp.float32,
                                  interpret=True)
    out = kc.fused_conv_residual(*map(torch.from_numpy, args),
                                 dtype=torch.float32)
    assert kc.fused_conv_residual.launches == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
