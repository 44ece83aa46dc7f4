"""Checkpoint interchange with the JAX reference."""
