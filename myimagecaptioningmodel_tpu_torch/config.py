"""Typed configuration.

The JAX package's ``config`` module imports no JAX, so the port shares it
rather than copying it: a port bundle's ``config.json`` and a JAX bundle's
are the same file. This module re-exports it under the port's name.
"""

from myimagecaptioningmodel_tpu.config import Config, default, replace_nested

__all__ = ["Config", "default", "replace_nested"]
