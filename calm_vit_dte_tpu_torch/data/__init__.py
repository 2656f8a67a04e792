"""Input preprocessing on the device (JAX counterpart: calm_vit_dte_tpu/data);
this slice ports the eval path only."""
