"""CUDA C++ kernels written for Hopper (sources in ../csrc), their ctypes
wrappers and plain PyTorch versions (JAX counterpart:
calm_vit_dte_tpu/kernels, the Pallas TPU kernels)."""
