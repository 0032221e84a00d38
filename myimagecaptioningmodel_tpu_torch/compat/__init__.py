"""Bridges from the JAX package's params and bundles."""
