"""Registries, checkpoints in the JAX package's format, weight
conversion, device selection."""
