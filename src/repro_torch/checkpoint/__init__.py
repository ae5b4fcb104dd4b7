"""Checkpoints of the port (`checkpoint.manager`), in the JAX package's format."""
