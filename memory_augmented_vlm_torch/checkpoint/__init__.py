"""Checkpoints of the port: the safetensors format, HF import and export,
train-state save and restore, and weight deltas."""
