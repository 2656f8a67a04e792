"""Spectral-norm layers, LayerNorm and initializers
(JAX counterpart: calm_vit_dte_tpu/nn)."""
