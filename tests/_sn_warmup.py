"""Converged spectral-norm state for the port's JAX-oracle tests, without a
JAX compile: the JAX Predictor's 30 warm-up power iterations, run by the
port's `normalize_tree` on weights carried from the JAX package. Both
sides of a comparison then start from these u/v."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from calm_vit_dte_tpu_torch.compat.from_jax import (
    jax_trees,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree


def converged_sn_state(cfg, params, sn, iterations: int = 30):
    """`sn` after `iterations` power iterations of the port's ViT of `cfg`
    (the port's config) on the JAX `params`, as a JAX tree."""
    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, sn)))
    with torch.no_grad():
        for _ in range(iterations):
            normalize_tree(model, training=True)
    return jax.tree.map(jnp.asarray, jax_trees(model.state_dict())[1])
