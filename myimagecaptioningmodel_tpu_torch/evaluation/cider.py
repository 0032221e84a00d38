"""CIDEr-D metric (Vedantam et al. 2015, arXiv:1411.5726); a copy of
``myimagecaptioningmodel_tpu/evaluation/cider.py``.

The reference evaluates BLEU only (evaluate.py) — CIDEr is the rebuild's
beyond-parity metric (BASELINE.json names "BLEU-4/CIDEr parity"). This is
the CIDEr-D variant as implemented by the COCO caption evaluation toolkit:

- n-gram (n=1..4) TF-IDF vectors per sentence; document frequencies over the
  *reference* corpus (one "document" = one image's reference set);
- per-n similarity = clipped cosine between candidate and each reference,
  scaled by a length-difference Gaussian penalty (sigma=6);
- score = 10 * mean over n of the mean over references.

Pure host Python, corpus-level API:
    scorer = CiderD()
    score, per_image = scorer.score(candidates, references)
where ``candidates[i]`` is a word list and ``references[i]`` a list of word
lists for image i.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _ngrams(words: Sequence[str], max_n: int = 4) -> Counter:
    c: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            c[tuple(words[i : i + n])] += 1
    return c


class CiderD:
    def __init__(self, max_n: int = 4, sigma: float = 6.0) -> None:
        self.max_n = max_n
        self.sigma = sigma

    def _doc_freq(self, refs_ngrams: List[List[Counter]]) -> Dict[tuple, int]:
        df: Dict[tuple, int] = defaultdict(int)
        for image_refs in refs_ngrams:
            seen = set()
            for ref in image_refs:
                seen.update(ref.keys())
            for ng in seen:
                df[ng] += 1
        return df

    def _tfidf(self, counts: Counter, df, log_ndocs: float):
        """-> (per-n {ngram: weight}, per-n vector norm, length)."""
        vec = [defaultdict(float) for _ in range(self.max_n)]
        norm = [0.0] * self.max_n
        length = 0
        for ng, tf in counts.items():
            n = len(ng) - 1
            idf = log_ndocs - math.log(max(1.0, df.get(ng, 0.0)))
            w = tf * idf
            vec[n][ng] = w
            norm[n] += w * w
            if n == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, cvec, cnorm, clen, rvec, rnorm, rlen) -> np.ndarray:
        delta = clen - rlen
        out = np.zeros(self.max_n)
        for n in range(self.max_n):
            s = 0.0
            for ng, w in cvec[n].items():
                # CIDEr-D clips the candidate count at the reference count
                s += min(w, rvec[n].get(ng, 0.0)) * rvec[n].get(ng, 0.0)
            if cnorm[n] and rnorm[n]:
                s /= cnorm[n] * rnorm[n]
            out[n] = s * math.exp(-(delta**2) / (2 * self.sigma**2))
        return out

    def score(
        self,
        candidates: Sequence[Sequence[str]],
        references: Sequence[Sequence[Sequence[str]]],
    ) -> Tuple[float, np.ndarray]:
        """-> (corpus CIDEr-D, per-image scores)."""
        assert len(candidates) == len(references)
        refs_ngrams = [[_ngrams(r, self.max_n) for r in refs] for refs in references]
        df = self._doc_freq(refs_ngrams)
        ndocs = len(references)
        log_ndocs = math.log(max(1, ndocs))

        scores = np.zeros(len(candidates))
        for i, (cand, image_refs) in enumerate(zip(candidates, refs_ngrams)):
            cvec, cnorm, clen = self._tfidf(_ngrams(cand, self.max_n), df, log_ndocs)
            acc = np.zeros(self.max_n)
            for ref in image_refs:
                rvec, rnorm, rlen = self._tfidf(ref, df, log_ndocs)
                acc += self._sim(cvec, cnorm, clen, rvec, rnorm, rlen)
            if image_refs:
                acc /= len(image_refs)
            scores[i] = 10.0 * acc.mean()
        return float(scores.mean()) if len(scores) else 0.0, scores
