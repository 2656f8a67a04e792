"""The port's whole serving forward: ViT goldens, and the port's Predictor
against the JAX package's Predictor on the same carried weights (fp32,
CPU)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu.serve import Predictor as JaxPredictor
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.serve import Predictor
from calm_vit_dte_tpu_torch.utils.configs import get_config

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.mark.parametrize("name,config", [("vit_cls_tiny", "tiny-cls"),
                                         ("vit_reg_tiny", "tiny-reg")])
def test_vit_golden(name, config):
    d = np.load(GOLDEN / f"{name}.npz")
    model = ViT(get_config(config).model,
                torch.Generator().manual_seed(0)).eval()
    model.load_state_dict({k[3:]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith("sd/")})
    x = torch.from_numpy(d["in/x"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    with torch.no_grad():
        y, kl = model(x)
    np.testing.assert_allclose(y.numpy(), d["out/y"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(kl), d["out/kl"], rtol=1e-4)


@jax.jit
def _converge_and_freeze(params, state):
    """The JAX Predictor.fresh warm-up (30 power iterations), then the eval
    weights its constructor would freeze, as one compiled program."""
    state = jax.lax.fori_loop(
        0, 30, lambda _, s: normalize_tree(params, s, training=True)[1],
        state)
    return normalize_tree(params, state, training=False)[0], state


def _jax_and_port(config):
    """A JAX model from the JAX factory with its power iteration converged,
    the JAX Predictor serving it, and the port's Predictor on the same
    carried weights."""
    cfg, params, state = jax_create_vit(config, seed=0)
    frozen, state = _converge_and_freeze(params, state)
    crop = get_config(config).crop
    jp = JaxPredictor(cfg, frozen, state, crop=crop, dtype=jnp.float32,
                      _prefrozen=True)
    tp = Predictor.from_jax(config, jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, state), device="cpu",
                            dtype=torch.float32)
    images = np.random.default_rng(0).integers(0, 256, (3, 56, 56, 3),
                                               dtype=np.uint8)
    return jp, tp, images


def test_predictor_classify_matches_jax():
    jp, tp, images = _jax_and_port("tiny-cls")
    ref_logits, ref_kl = jp._predict(jp.params, jp.sn_state,
                                     jnp.asarray(images))
    logits, kl = tp.predict(images)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=1e-4)
    labels, probs = tp.classify(images, top_k=3)
    ref_labels, ref_probs = jp.classify(images, top_k=3)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=1e-3, atol=1e-5)
    assert (np.diff(probs, axis=-1) <= 0).all()


def test_predictor_reconstruct_matches_jax():
    jp, tp, images = _jax_and_port("tiny-reg")
    out = tp.reconstruct(images)
    assert out.shape == (3, 48, 48, 3)
    np.testing.assert_allclose(out, jp.reconstruct(images), rtol=1e-3,
                               atol=1e-4)
