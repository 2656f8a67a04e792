"""The data plane (JAX counterpart: calm_vit_dte_tpu/data): sampler, loader,
augmentation and CutMix/MixUp on the device, and the preprocessing callables
of the train and eval steps. The native decode, the corpus and the CSV
dataset are not ported yet."""
