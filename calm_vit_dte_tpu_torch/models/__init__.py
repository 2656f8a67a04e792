"""VMLA layer, CALM Block, EncoderDecoder8 and the ViT wrapper
(JAX counterpart: calm_vit_dte_tpu/models)."""
