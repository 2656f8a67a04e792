"""Model math primitives (JAX counterpart: calm_vit_dte_tpu/ops)."""
