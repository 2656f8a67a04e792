"""CALM-ViT-DTE on PyTorch and CUDA: the port of `calm_vit_dte_tpu` to one
NVIDIA H100.

The JAX package beside this one is the reference. This package imports
neither `jax` nor anything of `calm_vit_dte_tpu`; it keeps its own copies of
the configs and constants it needs.

Layer map (bottom-up), module for module the same as the JAX package's:

  nn/       spectral-norm linears/convs (torch names weight_orig/weight_u/
            weight_v), scale-only LayerNorm, torch-distribution initializers
  ops/      learned RoPE, variational bottleneck, latent residual state,
            masked attention (dispatches to the kernel on a CUDA tensor)
  kernels/  CUDA C++ kernels written for Hopper (csrc/*.cu) with their
            ctypes wrappers and plain PyTorch versions
  models/   VMLA layer, CALM Block, EncoderDecoder8, ViT wrapper
  data/     eval preprocessing (center crop + normalize) on the device
  compat/   weight carry from the JAX package's pytrees
  utils/    named configs, device selection
  serve.py  Predictor: frozen eval-normalized weights, classify/reconstruct

Every entry point takes `device=` and defaults to "cuda"; without a card it
raises instead of falling back to the CPU. On a CPU tensor each kernel
wrapper runs its plain version, which is what the CPU tests use.
"""

__version__ = "0.1.0"
