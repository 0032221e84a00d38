"""Caption detokenization + BLEU, matching reference evaluate.py:15-43; a copy
of ``myimagecaptioningmodel_tpu/evaluation/metrics.py`` (the port imports
nothing of the JAX package).

- ``filter_ids``: ids -> words, truncate at ``<stop>``, skip ``<pad>``; note
  ``<unk>`` is intentionally *not* filtered, matching the reference
  (evaluate.py:15-25 — SURVEY §2.2 quirk 7).
- ``calc_bleu``: per-sentence BLEU with Chen & Cherry smoothing "method4",
  averaged over the *full* batch length while predictions of <=1 word are
  skipped (their score counts as 0) — the same weighting the reference uses
  (evaluate.py:28-39). Float id arrays are rounded back to ints, preserving
  the reference's float-ids-from-eval-graph tolerance (SURVEY §2.2 quirk 2).
- ``sentence_bleu``: a fast native implementation numerically equivalent to
  ``nltk.translate.bleu_score.sentence_bleu(..., SmoothingFunction().method4)``
  (verified against NLTK in tests/test_metrics.py). Host-side BLEU is the
  eval hot loop (reference train.py:158-167), so this avoids NLTK's
  per-sentence object churn.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from myimagecaptioningmodel_tpu_torch.data.tokenizer import PAD_ID, STOP_ID


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


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _modified_precision(
    references: Sequence[Sequence[str]], hypothesis: Sequence[str], n: int
) -> Tuple[int, int]:
    """Clipped n-gram match count and total n-gram count (numerator, denominator)."""
    counts = _ngram_counts(hypothesis, n)
    if not counts:
        return 0, 1  # NLTK: denominator = max(1, total)
    max_counts: Dict[tuple, int] = {}
    for ref in references:
        for ng, c in _ngram_counts(ref, n).items():
            if ng in counts:
                prev = max_counts.get(ng, 0)
                if c > prev:
                    max_counts[ng] = c
    numerator = sum(min(c, max_counts.get(ng, 0)) for ng, c in counts.items())
    denominator = max(1, sum(counts.values()))
    return numerator, denominator


def _closest_ref_length(references: Sequence[Sequence[str]], hyp_len: int) -> int:
    # NLTK picks the reference length closest to the hypothesis; ties -> shortest.
    return min((abs(len(r) - hyp_len), len(r)) for r in references)[1]


def sentence_bleu(
    references: Sequence[Sequence[str]],
    hypothesis: Sequence[str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    smoothing_k: int = 5,
) -> float:
    """Sentence BLEU with Chen & Cherry (2014) smoothing method 4.

    Numerically equivalent to NLTK's
    ``sentence_bleu(refs, hyp, weights, smoothing_function=SmoothingFunction().method4)``.
    """
    hyp_len = len(hypothesis)
    p_frac = [
        _modified_precision(references, hypothesis, n)
        for n in range(1, len(weights) + 1)
    ]

    # NLTK short-circuits when there are no unigram matches at all.
    if p_frac[0][0] == 0:
        return 0.0

    ref_len = _closest_ref_length(references, hyp_len)
    if hyp_len > ref_len:
        bp = 1.0
    elif hyp_len == 0:
        bp = 0.0
    else:
        bp = math.exp(1.0 - ref_len / hyp_len)

    # Smoothing method4: each zero numerator gets a proportionally smaller
    # smoothed count 1 / (2^incvnt * k / ln(hyp_len)).
    p_n: List[float] = []
    incvnt = 1
    for num, den in p_frac:
        if num == 0 and hyp_len > 1:
            p_n.append((1.0 / (2**incvnt * smoothing_k / math.log(hyp_len))) / den)
            incvnt += 1
        else:
            p_n.append(num / den)

    s = 0.0
    for w, p in zip(weights, p_n):
        if p > 0:
            s += w * math.log(p)
        elif w != 0:
            return 0.0  # an unsmoothable zero precision with nonzero weight
    return bp * math.exp(s)


def calc_bleu(
    pred,
    real: Sequence[Sequence[Sequence[str]]],
    index_word: Dict[int, str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    stop_idx: int = STOP_ID,
    padding_idx: int = PAD_ID,
) -> float:
    """Mean per-sentence BLEU of a decoded batch against reference word-lists.

    ``pred`` is an int (or float — rounded, reference evaluate.py:30-31) array
    [B, T] of token ids; ``real[b]`` is a list of reference captions, each a
    word list. Predictions that detokenize to <=1 word are skipped but still
    count in the denominator (reference evaluate.py:34-39).
    """
    total, rows = calc_bleu_rows(
        pred, real, index_word, weights, stop_idx, padding_idx
    )
    return total / rows


def calc_bleu_rows(
    pred,
    real: Sequence[Sequence[Sequence[str]]],
    index_word: Dict[int, str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    stop_idx: int = STOP_ID,
    padding_idx: int = PAD_ID,
) -> "tuple[float, int]":
    """Decomposable form of ``calc_bleu``: (sum of per-row BLEU, row count).

    ``calc_bleu == sum / rows`` exactly; the dev evaluation scores each
    batch with it."""
    if isinstance(pred, np.ndarray):
        if np.issubdtype(pred.dtype, np.floating):
            pred = np.rint(pred).astype(np.int32)
        pred = pred.tolist()
    total = 0.0
    for p, refs in zip(pred, real):
        words = filter_ids(p, index_word, stop_idx, padding_idx)
        if len(words) <= 1:
            continue
        total += sentence_bleu(refs, words, weights)
    return total, len(pred)


BLEU_WEIGHT_VECTORS = (
    (1, 0, 0, 0),
    (0, 1, 0, 0),
    (0, 0, 1, 0),
    (0, 0, 0, 1),
)  # BLEU-1..4 as computed by reference evaluate.py:58
