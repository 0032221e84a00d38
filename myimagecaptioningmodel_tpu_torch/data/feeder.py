"""Host->device input pipeline: background batch assembly + asynchronous
copies to the card; the counterpart of
``myimagecaptioningmodel_tpu/data/feeder.py``.

Replaces the reference's ``fluid.io.DataLoader.from_generator`` (a C++ async
feed queue, train.py:46, capacity 128) with a host-side prefetcher:

- a worker thread pulls sample lists from the reader, stacks them into
  numpy batches (images converted to float32 NHWC by the native converter,
  or kept as raw float16/uint8 NCHW rows with ``device_convert``), pins them
  when the target is a CUDA device, and pushes them onto a bounded queue;
- the consumer copies each batch to the device with ``non_blocking=True``
  one batch ahead of use, so the next batch's host-to-device copy overlaps
  the current step.

Batches whose trailing remainder would give another shape are dropped
(``drop_remainder``), as the JAX package drops them to keep one compiled
step.

Multi-process training feeds process-locally: each process's reader yields
only its rows of every global batch (``DataReader.get_reader(...,
process_shard=...)``) and its feeder copies them to its own device
(``cuda:LOCAL_RANK``), pinned and one batch ahead as in one process. The JAX
package's ``process_local`` assembles a global array from those rows; the
port has none to assemble, since each rank's step sees its own rows and the
collectives join them (``parallel/train_step.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch import native

_STOP = object()


class PrefetchingFeeder:
    """Iterate device-ready training batches ahead of consumption.

    ``device`` None yields numpy ``(imgs, caps)``; a ``torch.device`` yields
    tensors on it (pinned host buffers and non-blocking copies on CUDA).
    ``wait_seconds`` accumulates the time the consumer spent blocked on the
    queue (the feeder's share of a loop's wall)."""

    def __init__(
        self,
        reader: Callable[[], Iterator],
        capacity: int = 128,
        drop_remainder: bool = True,
        device: Optional[torch.device] = None,
        image_norm: Optional[Tuple] = None,
        device_convert: bool = False,
    ) -> None:
        self.reader = reader
        self.capacity = max(2, capacity)
        self.drop_remainder = drop_remainder
        self.device = None if device is None else torch.device(device)
        # (mean, std) for raw uint8 shard rows (storage_dtype="uint8");
        # ignored for float16/float32 rows, which are already normalized
        self.image_norm = image_norm
        # ship the raw storage batch (float16/uint8 NCHW) and let the device
        # convert it (models/captioner.prepare_images): the host stacks and
        # copies only, and a quarter (uint8) or half (float16) of float32's
        # bytes cross to the card
        self.device_convert = device_convert
        self.wait_seconds = 0.0

    @staticmethod
    def _batch_len(item) -> int:
        if isinstance(item, tuple):  # pre-stacked (imgs, caps) batch
            return item[0].shape[0]
        return len(item)

    def _assemble(self, samples) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(samples, tuple):
            imgs, caps = samples
        else:
            imgs = np.stack([s[0] for s in samples])
            caps = np.stack([s[1] for s in samples])
        if self.device_convert:
            return imgs, caps
        if imgs.dtype == np.uint8:
            mean, std = self.image_norm or ((0.0,) * 3, (1.0,) * 3)
            return native.convert_u8chw_to_f32nhwc(imgs, mean, std), caps
        return native.convert_chw_to_nhwc_f32(imgs), caps

    def _host_item(self, samples):
        """The worker's product: numpy, or (pinned) host tensors for a device."""
        imgs, caps = self._assemble(samples)
        if self.device is None:
            return imgs, caps
        out = (torch.from_numpy(np.ascontiguousarray(imgs)),
               torch.from_numpy(np.ascontiguousarray(caps)))
        if self.device.type == "cuda":
            out = tuple(t.pin_memory() for t in out)
        return out

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        stop = threading.Event()
        batch_size: Optional[int] = None

        def blocking_put(item) -> bool:
            """q.put that stays responsive to shutdown: a consumer that
            breaks mid-epoch would otherwise leave the worker blocked on a
            full bounded queue forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            nonlocal batch_size
            it = None
            try:
                it = self.reader()
                for samples in it:
                    if stop.is_set():
                        break
                    if batch_size is None:
                        batch_size = self._batch_len(samples)
                    if self.drop_remainder and self._batch_len(samples) != batch_size:
                        continue
                    if not blocking_put(self._host_item(samples)):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                blocking_put(e)
                return
            finally:
                # the reader generator's own cleanup, now rather than at GC
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            blocking_put(_STOP)

        t = threading.Thread(target=worker, daemon=True, name="feeder")
        self._active = (t, stop, q)
        t.start()

        put = None
        if self.device is not None:
            dev = self.device

            def put(b):
                return tuple(x.to(dev, non_blocking=True) for x in b)

        pending = None  # one batch in flight to the device
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                if put is not None:
                    item = put(item)
                if pending is not None:
                    yield pending
                pending = item
            if pending is not None:
                yield pending
        finally:
            # normal exhaustion, consumer break (GeneratorExit), or error:
            # always release the worker and its reader
            self._shutdown(t, stop, q)

    @staticmethod
    def _shutdown(t: threading.Thread, stop: threading.Event, q: "queue.Queue") -> None:
        stop.set()
        while True:  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)

    def close(self) -> None:
        """Stop the most recent iteration's worker (idempotent; the
        iterator's own ``finally`` normally does this)."""
        active = getattr(self, "_active", None)
        if active is not None:
            self._shutdown(*active)
            self._active = None
