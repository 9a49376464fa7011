"""PyTorch port of the Memory-Augmented VLM for NVIDIA Hopper GPUs.

The JAX package `memory_augmented_vlm_tpu` is the reference each module is
held against. This package imports `torch` and never `jax`; its kernels are
CUDA C++ under `csrc/`, built at first use (`ops/cuda_lib.py`).
"""
