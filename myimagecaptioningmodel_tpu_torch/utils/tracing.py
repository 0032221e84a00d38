"""Decoding under ``torch.export``: a decode loop that ends once every row is
done asks the host (``bool(done.all())``), which a traced program cannot.
Inside ``exporting()`` the loops run every step instead; the early-stop fill
(done rows emit ``<pad>``) gives the same ids."""

from __future__ import annotations

from contextlib import contextmanager

import torch

_DEPTH = 0


@contextmanager
def exporting():
    """Decode loops traced inside this block run every step."""
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1


def all_done(flags: torch.Tensor) -> bool:
    """Whether every flag is set, False while a decode is being exported."""
    return _DEPTH == 0 and bool(flags.all())
