"""Tracing / profiling as a thin subsystem; port of
``myimagecaptioningmodel_tpu/utils/profiling.py``.

The reference has no profiler — only wall-clock prints around epochs and the
dataset build (SURVEY §5.1). Here:

- ``trace(dir)``: context manager around ``torch.profiler.profile`` (CPU and
  CUDA activities) writing a Chrome trace into ``dir`` (Perfetto reads it);
- ``StepTimer``: cheap wall-clock histogram of a named hot loop (per-step
  p50/p90/max) that serializes to the structured run log;
- ``annotate(name)``: ``torch.profiler.record_function``, labelling a
  host-side phase inside a trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (and, with a card, device) profile into
    ``log_dir/trace.json``; yields the profiler."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a host-side region inside an active trace."""
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock stats for a named hot loop.

    Usage::

        timer = StepTimer("train_step")
        for batch in feeder:
            with timer:
                run(batch)
        stats = timer.summary()   # {count, mean_ms, p50_ms, p90_ms, max_ms}
    """

    def __init__(self, name: str, capacity: int = 100_000) -> None:
        self.name = name
        self.capacity = capacity
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if len(self._times) < self.capacity:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"name": self.name, "count": 0}
        ts = sorted(self._times)
        n = len(ts)

        def pct(p: float) -> float:
            return ts[min(n - 1, int(p * n))] * 1000.0

        return {
            "name": self.name,
            "count": n,
            "mean_ms": sum(ts) / n * 1000.0,
            "p50_ms": pct(0.50),
            "p90_ms": pct(0.90),
            "max_ms": ts[-1] * 1000.0,
        }

    def dump(self, path: str) -> None:
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(self.summary()) + "\n")
