"""Training of the port: the optimizer with JAX's parameter groups and the
multimodal train step."""
