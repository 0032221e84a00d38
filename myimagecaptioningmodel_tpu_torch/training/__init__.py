"""Inference bundles (export/load)."""
