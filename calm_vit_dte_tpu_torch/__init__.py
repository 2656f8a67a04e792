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
  models/   VMLA layer, CALM Block, EncoderDecoder8, Encoder8,
            CALMLatentDiffusion, ViT wrapper (eval and training forward)
  data/     sharded sampler, threaded loader with the native JPEG decoder
            (native/decoder.cpp through ctypes), augmentation and
            CutMix/MixUp on the device, the preprocessing callables of the
            steps, the generated JPEG corpus, the CSV dataset
  train/    losses, fused AdamW and schedules, TrainState, the train and
            eval steps (hoisted spectral-norm pre-pass, microbatches,
            activation checkpointing that keeps the kernels' outputs),
            checkpoints, sample PNGs, the trainer and its CLIs
            (train_cls, train_reg)
  parallel/ the (data, model) mesh over torch.distributed ranks (torchrun:
            NCCL on cards, gloo on the CPU), the tensor-parallel rule and
            the collectives of the data- and tensor-parallel step
  compat/   weight and optimizer-state carry from the JAX package's pytrees
  utils/    named configs, device selection, checkpointing with kept
            tensors, metric logging
  tools/    profiling on the card (the conv backward's ablation, kernel
            timers, layout canaries) and the training proof
  serve.py  Predictor: frozen eval-normalized weights, classify/reconstruct

Every entry point takes `device=` and defaults to "cuda"; without a card it
raises instead of falling back to the CPU. On a CPU tensor each kernel
wrapper runs its plain version, which is what the CPU tests use.
"""

__version__ = "0.1.0"
