"""Kernel micro-benchmarks of the port, counterparts of the JAX package's
`tools_int8_ceiling.py` and `tools_gemv_bench.py`: each module holds its
kernel's wrapper and plain version, and measures on the card when run as
`python -m memory_augmented_vlm_torch.microbench.<name>`."""
