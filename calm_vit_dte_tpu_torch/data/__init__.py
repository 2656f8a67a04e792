"""The data plane (JAX counterpart: calm_vit_dte_tpu/data): sampler, loader
with the native batch decoder (native.py) and its Pillow fallback,
augmentation and CutMix/MixUp on the device, the preprocessing callables of
the train and eval steps, the generated JPEG corpus (corpus.py) and the CSV
dataset (csv_dataset.py)."""
