"""Caption detokenization; port of the part of
``myimagecaptioningmodel_tpu/evaluation/metrics.py`` that serving calls (a
copy: the port imports nothing of the JAX package), matching reference
evaluate.py:15-25. ``filter_ids`` maps ids to words, truncates at ``<stop>``
and skips ``<pad>``; ``<unk>`` is intentionally *not* filtered, matching the
reference (SURVEY §2.2 quirk 7). BLEU comes with the dev-BLEU slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

# token ids of the reference vocabulary's specials (data/tokenizer.py)
PAD_ID, STOP_ID = 0, 3


def filter_ids(
    ids: Iterable[int],
    index_word: Dict[int, str],
    stop_idx: int = STOP_ID,
    padding_idx: int = PAD_ID,
) -> List[str]:
    """Convert an id sequence to a word list (truncate at <stop>, drop <pad>)."""
    words: List[str] = []
    for idx in ids:
        idx = int(idx)
        if idx == stop_idx:
            break
        if idx == padding_idx:
            continue
        words.append(index_word[idx])
    return words


def words2sentence(words: Sequence[str]) -> str:
    return " ".join(words)
