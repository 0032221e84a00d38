"""``chip_smoke.quality_rows`` (phase 30's corpus on the card) against the
generator of ``tests/test_quality_bar_hard.py``: the same uint8 pixels and
captions, image by image, taken from the original before its JPEG step."""

import json

import numpy as np

import chip_smoke
import test_quality_bar_hard as original


class _Capture:
    """Stands in for PIL's ``Image`` in the original's generator: keeps each
    array it is given and writes no file."""

    def __init__(self):
        self.arrays = []

    def fromarray(self, arr):
        self.arrays.append(np.array(arr))
        return self

    def save(self, *_args, **_kwargs):
        pass


def test_quality_rows_equal_the_original_generator(tmp_path, monkeypatch):
    capture = _Capture()
    monkeypatch.setattr(original, "Image", capture)
    _img_dir, ann = original._make_corpus(tmp_path)
    records = json.loads(ann.read_text(encoding="utf-8"))
    rows, caps = chip_smoke.quality_rows()
    assert len(capture.arrays) == len(records) == len(rows) == original.N_IMAGES
    want = np.stack(capture.arrays).transpose(0, 3, 1, 2)
    assert want.dtype == rows.dtype == np.uint8
    np.testing.assert_array_equal(rows, want)
    assert caps == [r["caption"][0] for r in records]
    assert chip_smoke.QUALITY_EPOCHS == original.EPOCHS
