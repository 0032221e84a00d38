"""Single-image inference; port of
``myimagecaptioningmodel_tpu/inference/infer.py``.

``python -m myimagecaptioningmodel_tpu_torch.inference.infer <path-or-url>``
loads the image (http(s) URL via ``requests``, else a local path),
preprocesses it, loads the inference bundle, greedy-decodes one image (B=1),
and prints the raw id list and the detokenized sentence.
"""

from __future__ import annotations

import sys
from io import BytesIO
from typing import List, Tuple

import numpy as np

from myimagecaptioningmodel_tpu.evaluation import metrics
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import (
    load_bundle,
    load_index_word,
)


def fetch_image(url_or_path: str):
    from PIL import Image

    if url_or_path.startswith(("http://", "https://")):
        import requests

        resp = requests.get(url_or_path)
        if resp.status_code != 200:
            raise ConnectionError(
                f"failed to download image {url_or_path}: {resp.status_code}"
            )
        return Image.open(BytesIO(resp.content))
    return Image.open(url_or_path)


def caption_array(
    cfg, arr: np.ndarray, bundle: str = "infer", early_stop: bool = False,
    device=None,
) -> Tuple[List[int], str]:
    """Normalized [H, W, 3] float32 image -> (raw id list, sentence)."""
    model, _bcfg, _opts, decode = load_bundle(
        cfg, bundle, early_stop=early_stop, device=device
    )
    ids = decode(model, np.asarray(arr, np.float32)[None])[0].cpu().tolist()
    words = metrics.filter_ids(
        ids, load_index_word(cfg, bundle), cfg.data.stop_idx, cfg.data.padding_idx
    )
    return ids, metrics.words2sentence(words)


def caption_image(
    cfg, img, bundle: str = "infer", early_stop: bool = False, device=None,
) -> Tuple[List[int], str]:
    """PIL image -> (raw id list, detokenized sentence)."""
    from myimagecaptioningmodel_tpu.data import image as image_mod

    arr = image_mod.process_image(
        img, cfg.data.image_shape, cfg.data.image_mean, cfg.data.image_std
    )
    if arr is None:
        raise ValueError("image is not a 3-channel RGB image")
    return caption_array(
        cfg, image_mod.chw_to_nhwc(arr[None])[0], bundle, early_stop, device
    )


def main(url: str, cfg=None, bundle: str = "infer", early_stop: bool = False,
         device=None) -> str:
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    ids, sentence = caption_image(
        cfg, fetch_image(url), bundle=bundle, early_stop=early_stop, device=device
    )
    print(ids)
    print(sentence)
    return sentence


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m myimagecaptioningmodel_tpu_torch.inference.infer "
                 "<image-path-or-url>")
    main(sys.argv[1])
