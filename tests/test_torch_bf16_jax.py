"""The port's bf16 step against the JAX package's at tiny-reg on the CPU:
one reg loss and its gradient (the spectral-norm pre-pass, the forward and
the Huber + 0.1 KL loss) on carried weights and u/v, one batch and the same
injected noise, in fp32 and in bf16. The two fp32 gradients agree to fp32
noise; in bf16 each side's gradient departs from its own fp32 one, and the
two departures are held leaf by leaf: where both packages round alike,
they are of one size.

The conv residuals' biases are the exception, and are held apart: the JAX
package adds them in bf16 (`sn_conv2d_apply`), so its bias gradient is a
bf16 sum over every pixel, while the port's plain conv chain sums it in
fp32 (measured here: the JAX bias gradients 2-39% off their fp32 values,
the port's within 6.4%)."""

import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _sn_warmup import converged_sn_state
from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig
from calm_vit_dte_tpu.models.vit import vit_apply, vit_init
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree as jax_normalize
from calm_vit_dte_tpu.nn.spectral_norm import (
    prenormalized_scope as jax_prenormalized,
)
from calm_vit_dte_tpu.ops.variational import noise_override as jax_noise
from calm_vit_dte_tpu.train.losses import (
    reconstruction_loss as jax_reconstruction_loss,
)
from calm_vit_dte_tpu_torch.compat.from_jax import (
    params_to_jax,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.losses import reconstruction_loss
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

torch.set_num_threads(1)


class NoiseSeq:
    """Call n returns standard normal noise from seed 1000 + n."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def _conv_bias(path: str) -> bool:
    return "['proj']" in path and path.endswith("['b']")


def test_bf16_gradient_departs_from_fp32_as_jax_does():
    cfg = replace(TINY_VIT, out_features=144, generate=True)
    jcfg = JViTConfig(**{f: getattr(cfg, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    params, sn = vit_init(jcfg, jax.random.PRNGKey(0))
    sn = converged_sn_state(cfg, params, sn)
    image = np.clip(np.random.default_rng(0).standard_normal(
        (8, 48, 48, 3)) * 0.6, -2, 2).astype(np.float32)

    def jax_loss(p, x, dtype):
        norm, _ = jax_normalize(p, sn, training=True)
        with jax_prenormalized():
            out, kl, _ = vit_apply(jcfg, norm, sn, x, training=True,
                                   rng=jax.random.PRNGKey(5), dtype=dtype)
        return jax_reconstruction_loss(out, x, kl)

    base = ViT(cfg, torch.Generator().manual_seed(0))
    base.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                             jax.tree.map(np.asarray, sn)))
    loss, grads = {}, {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        fn = jax.jit(jax.value_and_grad(lambda p, x: jax_loss(p, x, jdt)))
        with jax_noise(NoiseSeq()):
            fn = fn.lower(params, jnp.asarray(image)).compile()
        value, g = fn(params, jnp.asarray(image))
        loss["jax", name] = float(value)
        grads["jax", name] = jax.tree.map(np.asarray, g)

        model = copy.deepcopy(base).train()
        normed = normalize_tree(model, training=True)
        with noise_override(NoiseSeq()), prenormalized_scope(normed):
            out, kl = model(torch.from_numpy(image), dtype=tdt,
                            generator=torch.Generator().manual_seed(0))
            value = reconstruction_loss(out, torch.from_numpy(image), kl)
        value.backward()
        as_grads = copy.deepcopy(base)
        with torch.no_grad():
            for (_, p), q in zip(as_grads.named_parameters(),
                                 model.parameters()):
                p.copy_(q.grad)
        loss["port", name] = float(value)
        grads["port", name] = params_to_jax(
            as_grads, jax.tree.map(np.asarray, params))

    np.testing.assert_allclose(loss["port", "fp32"], loss["jax", "fp32"],
                               rtol=2e-6)
    np.testing.assert_allclose(loss["port", "bf16"], loss["jax", "bf16"],
                               rtol=1e-4)
    leaves = {key: jax.tree_util.tree_leaves_with_path(g)
              for key, g in grads.items()}
    rows = []
    for (path, j32), (_, j16), (_, p32), (_, p16) in zip(
            leaves["jax", "fp32"], leaves["jax", "bf16"],
            leaves["port", "fp32"], leaves["port", "bf16"]):
        name = jax.tree_util.keystr(path)
        scale = max(float(np.linalg.norm(j32)), 1e-30)
        # fp32 against fp32: the same gradient.
        np.testing.assert_allclose(p32, j32, rtol=1e-3,
                                   atol=1e-4 * np.abs(j32).max() + 1e-12,
                                   err_msg=name)
        rows.append((name, float(np.linalg.norm(j16 - j32)) / scale,
                     float(np.linalg.norm(p16 - p32)) / scale))
    shared = [(j, p) for name, j, p in rows if not _conv_bias(name)]
    ratio = np.median([p / j for j, p in shared if j > 0])
    both = (np.sqrt(sum(p * p for _, p in shared))
            / np.sqrt(sum(j * j for j, _ in shared)))
    bias = [(j, p) for name, j, p in rows if _conv_bias(name)]
    print(f"leaves {len(shared)}: median port/JAX bf16 departure {ratio:.3f},"
          f" of their root sum of squares {both:.3f}; conv biases: JAX "
          f"{min(j for j, _ in bias):.3g}-{max(j for j, _ in bias):.3g}, "
          f"port {min(p for _, p in bias):.3g}-{max(p for _, p in bias):.3g}")
    assert 0.8 < ratio < 1.25 and 0.8 < both < 1.25
    assert max(p for _, p in bias) < 0.1
