"""Chinese word segmentation with a pluggable backend; a copy of
``myimagecaptioningmodel_tpu/data/segmenter.py``. Each backend is imported
inside ``get_segmenter``: on a machine with neither pkuseg nor jieba,
"auto" resolves to "space".

The reference hard-depends on pkuseg (dataset_gen.py:3,19). pkuseg is not
always installable, so segmentation is a small strategy interface:
- 'pkuseg'   — the reference's segmenter, used when importable;
- 'jieba'    — a widely available fallback;
- 'space'    — whitespace split (for pre-segmented corpora and tests).

Segmenter choice affects vocabulary ids, so the dataset build records
``{segmenter, version}`` into ``dataset_meta.json`` next to ``word_dict.npy``
(data/dataset_gen.py:word_seg); BLEU comparisons are only meaningful within
one segmenter's output (SURVEY §7 "hard parts": pin the segmenter, snapshot
golden vocab stats — see tests/test_tokenizer.py golden-stats scaffold).
"""

from __future__ import annotations

from typing import Callable, List

SegmentFn = Callable[[str], List[str]]


def segmenter_version(name: str) -> str:
    """Installed version of the segmenter package ('-' for 'space')."""
    if name == "space":
        return "-"
    try:
        from importlib.metadata import version

        return version(name)
    except Exception:
        try:
            import importlib

            return getattr(importlib.import_module(name), "__version__", "unknown")
        except Exception:
            return "unknown"


def get_segmenter(name: str = "auto") -> tuple[str, SegmentFn]:
    """Return (resolved_name, segment_fn). 'auto' prefers pkuseg, then jieba."""
    candidates = [name] if name != "auto" else ["pkuseg", "jieba", "space"]
    last_err: Exception | None = None
    for cand in candidates:
        try:
            if cand == "pkuseg":
                import pkuseg  # type: ignore

                seg = pkuseg.pkuseg()
                return "pkuseg", seg.cut
            if cand == "jieba":
                import jieba  # type: ignore

                jieba.setLogLevel(60)
                return "jieba", lambda s: list(jieba.cut(s))
            if cand == "space":
                return "space", lambda s: s.split()
        except Exception as e:  # pragma: no cover - import availability
            last_err = e
    raise ImportError(f"no segmenter available (tried {candidates}): {last_err}")
