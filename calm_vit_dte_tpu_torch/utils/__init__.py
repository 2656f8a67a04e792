"""Configs and device selection (JAX counterpart: calm_vit_dte_tpu/utils)."""
