"""Single-image inference; port of
``myimagecaptioningmodel_tpu/inference/infer.py``.

``python -m myimagecaptioningmodel_tpu_torch.inference.infer <path-or-url>``
loads the image (http(s) URL via ``requests``, else a local path),
preprocesses it, loads the inference bundle, decodes one image (B=1; greedy,
or beam search with ``beam_size > 1``; int8 decoder weights with
``quantize``, for either decoder family), and prints the raw id list and the detokenized sentence.
"""

from __future__ import annotations

from io import BytesIO
from typing import List, Tuple

import numpy as np

from myimagecaptioningmodel_tpu_torch.evaluation import metrics
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
    cfg, arr: np.ndarray, bundle: str = "infer", beam_size: int = 0,
    quantize: bool = False, early_stop: bool = False, length_norm: float = 0.0,
    device=None,
) -> Tuple[List[int], str]:
    """Normalized [H, W, 3] float32 image -> (raw id list, sentence).
    ``beam_size > 1`` = beam search; ``quantize`` = int8 decoder weights;
    ``length_norm`` = beam score normalization by len**alpha. Runs on CUDA
    unless ``device="cpu"`` is given."""
    model, _bcfg, _opts, decode = load_bundle(
        cfg, bundle, beam_size, quantize, early_stop=early_stop, device=device,
        length_norm=length_norm,
    )
    ids = decode(model, np.asarray(arr, np.float32)[None])[0].cpu().tolist()
    words = metrics.filter_ids(
        ids, load_index_word(cfg, bundle), cfg.data.stop_idx, cfg.data.padding_idx
    )
    return ids, metrics.words2sentence(words)


def caption_image(
    cfg, img, bundle: str = "infer", beam_size: int = 0, quantize: bool = False,
    early_stop: bool = False, length_norm: float = 0.0, device=None,
) -> Tuple[List[int], str]:
    """PIL image -> (raw id list, detokenized sentence)."""
    from myimagecaptioningmodel_tpu_torch.data import image as image_mod

    arr = image_mod.process_image(
        img, cfg.data.image_shape, cfg.data.image_mean, cfg.data.image_std
    )
    if arr is None:
        raise ValueError("image is not a 3-channel RGB image")
    return caption_array(
        cfg, image_mod.chw_to_nhwc(arr[None])[0], bundle, beam_size, quantize,
        early_stop, length_norm, device,
    )


def main(url: str, cfg=None, bundle: str = "infer", beam_size: int = 0,
         quantize: bool = False, early_stop: bool = False, length_norm: float = 0.0,
         device=None) -> str:
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    ids, sentence = caption_image(
        cfg, fetch_image(url), bundle=bundle, beam_size=beam_size, quantize=quantize,
        early_stop=early_stop, length_norm=length_norm, device=device,
    )
    print(ids)
    print(sentence)
    return sentence


def cli(argv=None) -> str:
    """``python -m myimagecaptioningmodel_tpu_torch.inference.infer <image>
    [--config cfg.json] [--bundle infer] [--beam N] [--quantize]
    [--early-stop] [--length-norm A] [--device cuda]``, the flags of the
    repo's root ``infer.py``."""
    import argparse

    from myimagecaptioningmodel_tpu_torch import config as config_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("url", help="image URL or local path")
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--bundle", default="infer")
    ap.add_argument("--beam", type=int, default=0, help="beam size (0/1: greedy)")
    ap.add_argument("--quantize", action="store_true", help="int8 decoder weights")
    ap.add_argument("--early-stop", action="store_true")
    ap.add_argument("--length-norm", type=float, default=0.0,
                    help="beam only: normalize final scores by len**alpha")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else None
    return main(args.url, cfg, args.bundle, args.beam, args.quantize, args.early_stop,
                args.length_norm, args.device)


if __name__ == "__main__":
    cli()
