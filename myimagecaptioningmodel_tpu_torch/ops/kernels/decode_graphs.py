"""The CUDA-graph cache of the whole-decode kernels: kernels D and E
(``fused_transformer.py``) and kernel B's LSTM greedy and beam decodes
(``fused_step.py``) share one ``GRAPHS``.

A decode's kernel sequence is fixed by its shape (early stop is a device
flag), so each wrapper captures its decode once per key (the C call's ints,
the device and the packed weights' addresses) and replays it; every call
first copies its batch's inputs into the graph's own tensors.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch


class _Captured(NamedTuple):
    graph: object
    work: dict
    kernel_launches: int  # kernels a replay runs
    capture_ms: float
    nbytes: int


def _nbytes(work: dict) -> int:
    return sum(t.numel() * t.element_size() for t in work.values() if t is not None)


class DecodeGraphs:
    """Captured decodes, one CUDA graph per key, the least recently used
    dropped first: at most ``max_graphs`` of them and ``max_bytes`` of the
    tensors ``make_work`` allocates for them (a single larger one is kept
    alone; what a capture itself allocates, in the graph's memory pool, is
    not counted). ``run`` captures a new key once and replays it on every
    later call, after copying the batch's inputs into the graph's own
    tensors."""

    def __init__(self, max_graphs: int = 8, max_bytes: int = 3 << 30):
        self.max_graphs, self.max_bytes = max_graphs, max_bytes
        self.entries: "OrderedDict[tuple, _Captured]" = OrderedDict()
        self.captures = 0
        self.replays = 0
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    @staticmethod
    def capture(record, device):
        """The CUDA graph of ``record()``'s work -> (graph, its result)."""
        graph = torch.cuda.CUDAGraph()
        # relaxed: the kernels' first launch sets their shared-memory limits
        with torch.cuda.device(device), torch.cuda.graph(graph, capture_error_mode="relaxed"):
            out = record()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    @staticmethod
    def load(work: dict, inputs: dict) -> None:
        """The batch's inputs into the graph's own tensors."""
        for name, t in inputs.items():
            if t is not None:
                work[name].copy_(t)

    def _evict(self, incoming: int) -> None:
        while self.entries and (len(self.entries) >= self.max_graphs
                                or self.nbytes + incoming > self.max_bytes):
            self.entries.popitem(last=False)

    def run(self, key, make_work, record, inputs: dict, outputs, device):
        """Replay (capturing first if new) the decode of ``key`` on
        ``inputs`` -> (outputs(work), the captured entry, whether this call
        captured)."""
        with self._lock:
            entry = self.entries.get(key)
            captured = entry is None
            if captured:
                work = make_work()
                nbytes = _nbytes(work)
                self._evict(nbytes)
                t0 = time.perf_counter()
                graph, launches = self.capture(lambda: record(work), device)
                entry = _Captured(graph, work, launches, (time.perf_counter() - t0) * 1e3, nbytes)
                self.entries[key] = entry
                self.captures += 1
            else:
                self.entries.move_to_end(key)
            self.load(entry.work, inputs)
            self.replay(entry.graph)
            self.replays += 1
            return outputs(entry.work), entry, captured


GRAPHS = DecodeGraphs()
