"""Tensor ops of the port: norms, RoPE, pooling, attention and the flash
kernel's wrapper."""
