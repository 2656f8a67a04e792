"""The port's Encoder8 and CALMLatentDiffusion (models/encoder_decoder.py)
against the golden encoder8.npz and against the JAX package's
`encoder8_apply` / `calm_latent_diffusion_apply` on weights carried by
compat/from_jax.py (fp32, CPU, eval mode, the tiny widths of
tests/test_models.py).

Limits: the golden's rtol 1e-3 / atol 1e-4 (tests/test_parity_torch.py:
146-147); against the JAX functions the per-layer eval limit rtol 2e-4 /
atol 2e-5 (tests/test_parity_torch.py:86), the KL at rtol 1e-4.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.models.encoder_decoder import (
    CALMLatentDiffusionConfig as JCALMLatentDiffusionConfig,
)
from calm_vit_dte_tpu.models.encoder_decoder import (
    Encoder8Config as JEncoder8Config,
)
from calm_vit_dte_tpu.models.encoder_decoder import (
    calm_latent_diffusion_apply,
    calm_latent_diffusion_init,
    encoder8_apply,
    encoder8_init,
)
from calm_vit_dte_tpu.nn.spectral_norm import (
    normalize_tree as jax_normalize_tree,
)
from calm_vit_dte_tpu_torch.compat.from_jax import (
    LATENT_DIFFUSION_NAMES,
    latent_diffusion_state_dict_from_jax,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.models import (
    CALMLatentDiffusion,
    CALMLatentDiffusionConfig,
    Encoder8,
    Encoder8Config,
)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
TINY = dict(heads=3, dim1=144, dim_step=12, mean_var_hidden=24,
            seq_length=48, seq_len_step=4, seq_len_reduce=8)
TINY_LD = dict(TINY, mean_var_hidden_diffusion=8, seq_len_reduce_diffusion=4)


def _gen():
    return torch.Generator().manual_seed(0)


def _converged(params, state):
    """A converged power iteration: at raw init the sigma estimates are far
    too small and a deep eval forward overflows, where fp32 comparisons say
    nothing (tests/test_torch_modules.py)."""
    step = jax.jit(lambda p, s: jax_normalize_tree(p, s, training=True)[1])
    for _ in range(30):
        state = step(params, state)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _image(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 48, 48, 3)).astype(np.float32)


def test_encoder8_golden():
    d = np.load(GOLDEN / "encoder8.npz")
    sd = {k[3:]: torch.from_numpy(d[k]) for k in d.files
          if k.startswith("sd/")}
    model = Encoder8(Encoder8Config(**TINY), _gen()).eval()
    model.load_state_dict(sd)
    x = torch.from_numpy(d["in/x"]).permute(0, 2, 3, 1)   # NCHW -> NHWC
    with torch.no_grad():
        y = model(x)
    assert y.shape == (2, 24, 72)
    np.testing.assert_allclose(y.numpy(), d["out/y"], rtol=1e-3, atol=1e-4)


def test_encoder8_matches_jax_on_carried_weights():
    cfg = JEncoder8Config(**TINY)
    params, state = _converged(*encoder8_init(cfg, jax.random.PRNGKey(3)))
    model = Encoder8(Encoder8Config(**TINY), _gen()).eval()
    model.load_state_dict(state_dict_from_jax(params, state))
    x = _image(4)
    ref, _ = jax.jit(lambda p, s, x: encoder8_apply(
        cfg, p, s, x, training=False))(params, state, jnp.asarray(x))
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_latent_diffusion_matches_jax_on_carried_weights():
    cfg = JCALMLatentDiffusionConfig(**TINY_LD)
    params, state = _converged(
        *calm_latent_diffusion_init(cfg, jax.random.PRNGKey(5)))
    model = CALMLatentDiffusion(CALMLatentDiffusionConfig(**TINY_LD),
                                _gen()).eval()
    model.load_state_dict(latent_diffusion_state_dict_from_jax(params,
                                                               state))
    x = _image(6)

    def fwd(p, s, x):
        y, kl, _ = calm_latent_diffusion_apply(cfg, p, s, x, training=False)
        return y, kl

    ref, kl_ref = jax.jit(fwd)(params, state, jnp.asarray(x))
    with torch.no_grad():
        y, kl = model(torch.from_numpy(x))
    assert y.shape == (2, 48, 144)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=1e-4)


def test_latent_diffusion_names():
    """The table maps every JAX top-level name onto a port submodule, and
    every port parameter and buffer comes from one of them."""
    assert LATENT_DIFFUSION_NAMES == {
        "encoder_0": "encoder_blocks.0", "encoder_1": "encoder_blocks.1",
        "encoder_2": "encoder_blocks.2", "decoder_0": "decoder_blocks.0",
        "decoder_1": "decoder_blocks.1", "decoder_2": "decoder_blocks.2",
        "ln_final": "ln_final"}
    cfg = CALMLatentDiffusionConfig(**TINY_LD)
    trees = jax.tree.map(np.asarray, calm_latent_diffusion_init(
        JCALMLatentDiffusionConfig(**TINY_LD), jax.random.PRNGKey(0)))
    sd = latent_diffusion_state_dict_from_jax(*trees)
    model = CALMLatentDiffusion(cfg, _gen())
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    with pytest.raises(KeyError):
        latent_diffusion_state_dict_from_jax(
            {**trees[0], "bottleneck_1": {}}, trees[1])
