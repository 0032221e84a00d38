"""Long-running caption server with dynamic batching; port of
``myimagecaptioningmodel_tpu/inference/server.py``.

The bundle is loaded once onto one device. Concurrent requests are collected
into batches (dispatch when ``batch_size`` are waiting or ``max_wait_ms``
after the first), decoded in one call (greedy, or beam search with
``--beam N``; float or, with ``--quantize``, int8 decoder weights), and
answered individually. On CUDA each decode step runs the hand-written
fused-step kernels and a vocab-head kernel (argmax greedy, top-k beam).
Unlike the reference, which pads every batch to one compiled shape, a
partial batch is decoded at its own size: the kernels take any batch.

Stdlib-only HTTP:

    python -m myimagecaptioningmodel_tpu_torch.inference.server \
        [--config cfg.json] [--device cuda] [--port 8765] [--batch 8] \
        [--beam N] [--quantize] [--length-norm A] [--early-stop] [--max-wait-ms 5]

    POST /caption   body = raw image bytes (JPEG/PNG/...)
                    -> {"ids": [...], "caption": "..."}
    GET  /healthz   -> {"status": "ok", "batch": B, "beam": W, ...}

Image decoding (PIL) is its own step (``prepare``); in-process callers can
submit already-normalized ``[H, W, 3]`` float32 arrays with
``caption_array`` through the same queue and batcher.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.evaluation import metrics
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import (
    load_bundle,
    load_index_word,
)


def decode_image_bytes(data: bytes, shape, mean, std) -> np.ndarray:
    """Image bytes -> normalized [H, W, 3] float32 (NHWC row). Raises
    ValueError for undecodable bytes or non-RGB images."""
    import io

    from PIL import Image

    from myimagecaptioningmodel_tpu_torch.data import image as image_mod

    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
    except Exception as e:
        raise ValueError(f"cannot decode image: {e}") from e
    arr = image_mod.process_image(img, shape, mean, std)
    return image_mod.chw_to_nhwc(arr[None])[0]


class _Request:
    __slots__ = ("arr", "event", "ids", "error")

    def __init__(self, arr: np.ndarray):
        self.arr = arr  # [H, W, 3] float32 NHWC (normalized)
        self.event = threading.Event()
        self.ids: Optional[List[int]] = None
        self.error: Optional[str] = None


class CaptionService:
    """Bundle on one device + dynamic batcher thread; the device is CUDA
    unless ``device="cpu"`` is given (``load_bundle``)."""

    def __init__(self, cfg, bundle: str = "infer", batch_size: int = 8,
                 beam_size: int = 0, quantize: bool = False,
                 early_stop: bool = False, max_wait_ms: float = 5.0,
                 length_norm: float = 0.0, device=None) -> None:
        self.cfg = cfg
        self.batch_size = batch_size
        self.beam_size = beam_size
        self.max_wait = max_wait_ms / 1000.0
        self.model, _bcfg, self.opts, self.decode = load_bundle(
            cfg, bundle, beam_size, quantize, early_stop=early_stop, device=device,
            length_norm=length_norm,
        )
        self.device = self.model.device
        self.index_word = load_index_word(cfg, bundle)
        self.shape = tuple(cfg.data.image_shape)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        # serving counters (read by /healthz): guarded by _stats_lock
        self._stats_lock = threading.Lock()
        self._served = 0
        self._dispatches = 0
        self._batch_fill = 0
        self._lat_ms: List[float] = []  # rolling decode latencies
        self.warmup()
        self._thread = threading.Thread(
            target=self._batcher, daemon=True, name="caption-batcher"
        )
        self._thread.start()

    # -- request path -------------------------------------------------------

    def prepare(self, data: bytes) -> np.ndarray:
        """image bytes -> normalized [H, W, 3] float32 (ValueError -> 400)."""
        return decode_image_bytes(
            data, self.shape, self.cfg.data.image_mean, self.cfg.data.image_std
        )

    def caption_bytes(self, data: bytes, timeout: float = 60.0) -> dict:
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        return self.caption_array(self.prepare(data), timeout)

    def caption_array(self, arr: np.ndarray, timeout: float = 60.0) -> dict:
        """Caption one normalized [H, W, 3] float32 image."""
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        arr = np.asarray(arr, np.float32)
        if arr.shape != (*self.shape, 3):
            raise ValueError(f"image must be {(*self.shape, 3)}, got {arr.shape}")
        req = _Request(arr)
        self._q.put(req)
        if self._stop.is_set():
            # close() raced our enqueue: re-drain so this request fails fast
            self._drain_queue()
        if not req.event.wait(timeout):
            raise TimeoutError("decode queue timeout")
        if req.error:
            raise RuntimeError(req.error)
        words = metrics.filter_ids(
            req.ids, self.index_word, self.cfg.data.stop_idx,
            self.cfg.data.padding_idx,
        )
        return {"ids": req.ids, "caption": metrics.words2sentence(words)}

    def warmup(self) -> None:
        """Build the kernels and run one full batch before serving traffic."""
        x = np.zeros((self.batch_size, *self.shape, 3), np.float32)
        self.decode(self.model, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats(self) -> dict:
        """Serving counters: totals, mean batch fill, decode latency p50/p90."""
        with self._stats_lock:
            lat = sorted(self._lat_ms)
            d = max(self._dispatches, 1)
            return {
                "served": self._served,
                "dispatches": self._dispatches,
                "mean_batch_fill": round(self._batch_fill / d, 2),
                "decode_ms_p50": round(lat[len(lat) // 2], 2) if lat else None,
                "decode_ms_p90": (
                    round(lat[int(len(lat) * 0.9)], 2) if lat else None
                ),
            }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        # fail fast any requests still queued
        self._drain_queue()

    def _drain_queue(self) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error = "server shutting down"
            r.event.set()

    # -- batcher ------------------------------------------------------------

    def _batcher(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                t0 = time.monotonic()
                imgs = np.stack([r.arr for r in batch])
                ids = self.decode(self.model, imgs).cpu().numpy()
                for i, r in enumerate(batch):
                    r.ids = [int(v) for v in ids[i]]
                with self._stats_lock:
                    self._served += len(batch)
                    self._dispatches += 1
                    self._batch_fill += len(batch)
                    self._lat_ms.append((time.monotonic() - t0) * 1000.0)
                    del self._lat_ms[:-512]  # rolling window
            except Exception as e:  # surface decode errors to every waiter
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
            for r in batch:
                r.event.set()


def make_server(service: CaptionService, port: int = 8765,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "batch": service.batch_size,
                    "beam": service.beam_size,
                    "max_wait_ms": service.max_wait * 1000.0,
                    "device": str(service.device),
                    **service.stats(),
                })
            else:
                self._send(404, {"error": "unknown path"})

        MAX_BODY = 32 * 1024 * 1024  # images only; reject absurd bodies

        def do_POST(self):
            if self.path != "/caption":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send(400, {"error": "bad Content-Length"})
                return
            if n <= 0 or n > self.MAX_BODY:
                self._send(413, {"error": f"body must be 1..{self.MAX_BODY} bytes"})
                return
            try:
                data = self.rfile.read(n)
                self._send(200, service.caption_bytes(data))
            except ValueError as e:  # undecodable image = client error
                self._send(400, {"error": str(e)})
            except TimeoutError:
                self._send(503, {"error": "decode queue timeout"})
            except Exception as e:  # device/internal failure
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    import argparse

    from myimagecaptioningmodel_tpu_torch import config as config_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", help="JSON config file")
    ap.add_argument("--bundle", default="infer")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam", type=int, default=0, help="beam size (0/1: greedy)")
    ap.add_argument("--quantize", action="store_true", help="int8 decoder weights")
    ap.add_argument("--early-stop", action="store_true")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--length-norm", type=float, default=0.0,
                    help="beam only: normalize final scores by len**alpha")
    args = ap.parse_args(argv)

    cfg = (
        config_mod.Config.from_json_file(args.config)
        if args.config
        else config_mod.default
    )
    service = CaptionService(
        cfg, args.bundle, args.batch, args.beam, args.quantize, args.early_stop,
        args.max_wait_ms, args.length_norm, device=args.device,
    )
    server = make_server(service, args.port, args.host)
    print(f"caption server on http://{args.host}:{args.port} "
          f"(batch {args.batch}, beam {args.beam}, device {service.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


if __name__ == "__main__":
    main()
