"""Shared utilities: profiling/tracing, small file helpers."""
