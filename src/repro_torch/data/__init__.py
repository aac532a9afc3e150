"""Deterministic synthetic datasets (numpy; the same arrays as the JAX package's)."""
