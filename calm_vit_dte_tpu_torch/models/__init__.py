"""VMLA layer, CALM Block, the model stacks (EncoderDecoder8, Encoder8,
CALMLatentDiffusion) and the ViT wrapper (JAX counterpart:
calm_vit_dte_tpu/models)."""

from calm_vit_dte_tpu_torch.models.encoder_decoder import (
    CALMLatentDiffusion,
    CALMLatentDiffusionConfig,
    Encoder8,
    Encoder8Config,
    EncoderDecoder8,
    EncoderDecoder8Config,
)

__all__ = ["CALMLatentDiffusion", "CALMLatentDiffusionConfig", "Encoder8",
           "Encoder8Config", "EncoderDecoder8", "EncoderDecoder8Config"]
