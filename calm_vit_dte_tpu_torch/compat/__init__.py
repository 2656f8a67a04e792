"""Weight carry between the JAX package and the port
(JAX counterpart: calm_vit_dte_tpu/compat)."""
