"""Tensor ops of the port: norms, RoPE, pooling, attention, quantization,
and the wrappers of the CUDA kernels with their plain versions."""
