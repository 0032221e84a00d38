"""The port's BLEU (``evaluation/metrics.py``) and CIDEr-D
(``evaluation/cider.py``) against the JAX package's, on seeded random id
rows and reference sets: equal to 1e-12 (both are the same float
arithmetic in Python, so in practice equal)."""

import numpy as np
import pytest

from myimagecaptioningmodel_tpu.evaluation import cider as jcider
from myimagecaptioningmodel_tpu.evaluation import metrics as jm
from myimagecaptioningmodel_tpu_torch.data import tokenizer as ttok
from myimagecaptioningmodel_tpu_torch.evaluation import cider as tcider
from myimagecaptioningmodel_tpu_torch.evaluation import metrics as tm

TOL = 1e-12
WORDS = 12  # a small vocabulary, so that n-grams repeat and match


def corpus(seed, rows=24, T=10):
    """-> (pred ids [rows, T] with <stop>/<pad> mixed in, references, index_word)."""
    rng = np.random.RandomState(seed)
    index_word = {i: f"w{i}" for i in range(4, 4 + WORDS)}
    index_word.update({0: "<pad>", 1: "<unk>", 2: "<start>", 3: "<stop>"})
    pred = rng.randint(4, 4 + WORDS, (rows, T))
    for r in range(rows):
        cut = rng.randint(0, T + 2)
        if cut < T:
            pred[r, cut] = 3  # <stop>
        if rng.rand() < 0.3:
            pred[r, rng.randint(T)] = 0  # a <pad> skipped mid-caption
    refs = [[[f"w{w}" for w in rng.randint(4, 4 + WORDS, rng.randint(1, 12))]
             for _ in range(rng.randint(1, 6))] for _ in range(rows)]
    return pred, refs, index_word


def test_token_ids_come_from_the_tokenizer():
    assert (tm.PAD_ID, tm.STOP_ID) == (ttok.PAD_ID, ttok.STOP_ID) == (jm.PAD_ID, jm.STOP_ID)


@pytest.mark.parametrize("seed", range(4))
def test_sentence_bleu(seed):
    pred, refs, index_word = corpus(seed)
    for p, r in zip(pred, refs):
        hyp = tm.filter_ids(p, index_word)
        for w in tm.BLEU_WEIGHT_VECTORS + ((0.25,) * 4,):
            want = jm.sentence_bleu(r, hyp, w)
            assert abs(tm.sentence_bleu(r, hyp, w) - want) <= TOL
        assert tm._closest_ref_length(r, len(hyp)) == jm._closest_ref_length(r, len(hyp))
        for n in (1, 2, 3, 4):
            assert tm._modified_precision(r, hyp, n) == jm._modified_precision(r, hyp, n)
            assert tm._ngram_counts(hyp, n) == jm._ngram_counts(hyp, n)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("as_float", [False, True])
def test_calc_bleu_and_rows(seed, as_float):
    pred, refs, index_word = corpus(seed)
    if as_float:  # float id arrays are rounded back, as the reference tolerates
        pred = pred.astype(np.float32) + 0.2
    assert tm.BLEU_WEIGHT_VECTORS == jm.BLEU_WEIGHT_VECTORS
    for w in tm.BLEU_WEIGHT_VECTORS:
        assert abs(tm.calc_bleu(pred, refs, index_word, w)
                   - jm.calc_bleu(pred, refs, index_word, w)) <= TOL
        t_sum, t_rows = tm.calc_bleu_rows(pred, refs, index_word, w)
        j_sum, j_rows = jm.calc_bleu_rows(pred, refs, index_word, w)
        assert t_rows == j_rows == len(pred) and abs(t_sum - j_sum) <= TOL
    assert tm.calc_bleu(pred, refs, index_word) > 0  # the corpus does match somewhere


@pytest.mark.parametrize("seed", range(4))
def test_cider_d(seed):
    pred, refs, index_word = corpus(seed, rows=30)
    cands = [tm.filter_ids(p, index_word) for p in pred]
    t_score, t_per = tcider.CiderD().score(cands, refs)
    j_score, j_per = jcider.CiderD().score(cands, refs)
    assert abs(t_score - j_score) <= TOL
    np.testing.assert_allclose(t_per, j_per, rtol=0, atol=TOL)
    assert t_score > 0
    # the document frequencies are the corpus's: a different corpus changes them
    assert abs(tcider.CiderD().score(cands[:10], refs[:10])[0]
               - jcider.CiderD().score(cands[:10], refs[:10])[0]) <= TOL
