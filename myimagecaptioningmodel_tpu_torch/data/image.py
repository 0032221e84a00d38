"""Image preprocessing; port of ``myimagecaptioningmodel_tpu/data/image.py``
(matching reference reader.py:13-28).

PIL decode -> Lanczos resize to the configured shape -> float32 -> HWC->CHW
-> /255 -> per-channel mean/std normalize. Non-3-channel images are rejected
(None), like the reference. PIL is imported where an image is processed, so
the module imports on a machine without it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def process_image(
    img,
    shape: Tuple[int, int] = (224, 224),
    mean: Sequence[float] = (0.0, 0.0, 0.0),
    std: Sequence[float] = (1.0, 1.0, 1.0),
) -> Optional[np.ndarray]:
    """PIL image -> normalized CHW float32 array, or None if not 3-channel."""
    from PIL import Image

    if not isinstance(img, Image.Image):
        raise ValueError(f"image must be a PIL Image, got {type(img)}")
    lanczos = getattr(Image, "LANCZOS", getattr(Image, "ANTIALIAS", None))
    img = img.resize(tuple(shape), lanczos)
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return None
    arr = arr.transpose(2, 0, 1) / 255.0
    arr -= np.asarray(mean, dtype=np.float32).reshape(3, 1, 1)
    arr /= np.asarray(std, dtype=np.float32).reshape(3, 1, 1)
    return arr


def read_image(path: str):
    from PIL import Image

    return Image.open(path)


def resize_chw_uint8(img, shape: Tuple[int, int] = (224, 224)) -> Optional[np.ndarray]:
    """PIL image -> raw resized CHW uint8 (the ``storage_dtype="uint8"``
    shard row; /255 + mean/std normalization happens at feed time).
    None if not 3-channel, like ``process_image``."""
    from PIL import Image

    lanczos = getattr(Image, "LANCZOS", getattr(Image, "ANTIALIAS", None))
    img = img.resize(tuple(shape), lanczos)
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return None
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def normalize_uint8_chw(
    batch: np.ndarray,
    mean: Sequence[float] = (0.0, 0.0, 0.0),
    std: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Raw uint8 CHW rows ([3,H,W] or [B,3,H,W]) -> normalized float32, the
    same float32 operations in the same order as ``process_image`` and as
    the device-side ``models.captioner.prepare_images``."""
    arr = batch.astype(np.float32) / 255.0
    ch = (3, 1, 1) if arr.ndim == 3 else (1, 3, 1, 1)
    arr -= np.asarray(mean, np.float32).reshape(ch)
    arr /= np.asarray(std, np.float32).reshape(ch)
    return arr


def chw_to_nhwc(batch: np.ndarray) -> np.ndarray:
    """[B,3,H,W] (storage layout) -> [B,H,W,3] (the model's input layout)."""
    return np.ascontiguousarray(np.transpose(batch, (0, 2, 3, 1)))
