"""Vocabulary build + caption tokenization, matching the reference semantics;
a copy of ``myimagecaptioningmodel_tpu/data/tokenizer.py`` (the port imports
nothing of the JAX package).

Re-implements the behavior of reference preprocess/ai_challenge_tokenizer.py:
- vocabulary from *training split only* word counts, keep at most ``max_keep``
  words with count >= ``minimum_occur`` (=2), ordered by descending count
  (ai_challenge_tokenizer.py:21-50);
- specials prepended as ``['<pad>','<unk>','<start>','<stop>']`` -> ids
  0,1,2,3 (:47);
- caption token DBs: training DB keeps <=5 captions/image
  (``sentences_per_image``, :74), wraps with <start>/<stop> (:81), zero-pads
  every caption to the global max length (:85), and shuffles with a fixed
  seed (:14,18);
- dev/eval DBs map image name -> list of reference word-lists (:91-99);
- artifacts: ``word_dict.npy`` ``[word2idx, idx2word]``, ``train_cap.npy``
  ``[db, max_len]``, ``dev_data.npy``/``eval_data.npy`` ``[names, name2caps]``,
  ``word2idx.json``/``idx2word.json`` (:106-124).

The token file format is the reference's: one line per caption,
``"{name}#{cap_idx}\t{space-joined words}\n"`` (dataset_gen.py:35); the name
is recovered by stripping the 2-char ``#i`` suffix (ai_challenge_tokenizer.py:28).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

SPECIALS = ["<pad>", "<unk>", "<start>", "<stop>"]
PAD_ID, UNK_ID, START_ID, STOP_ID = 0, 1, 2, 3

SHUFFLE_SEED = 123456789  # ai_challenge_tokenizer.py:14
MINIMUM_OCCUR = 2  # ai_challenge_tokenizer.py:15


def _parse_token_line(line: str) -> Tuple[str, List[str]]:
    """Split a token-file line into (image name, word list).

    The reference strips the trailing ``#i`` caption index with ``name[:-2]``
    (ai_challenge_tokenizer.py:28) — we keep that exact behavior, which
    assumes single-digit caption indices (AI_Challenger has 5 per image).
    """
    name, text = line.split("\t")
    return name[:-2], text.strip().split()


def build_dict(
    token_path: str,
    train_div: Sequence[str] | None = None,
    max_keep: int = 15000,
    minimum_occur: int = MINIMUM_OCCUR,
    return_stats: bool = False,
):
    """Build word->id / id->word from the token file, training split only.

    Ordering matches the reference exactly: words sorted by descending count
    (Python's stable sort preserves first-seen order among ties, like the
    reference's ``sorted(word_cnt.items(), ...)`` over insertion-ordered
    dicts), truncated at ``max_keep`` and ``minimum_occur``.

    ``return_stats`` additionally returns ``{"unk_word_types": N}`` — the
    number of distinct word types mapped to <unk> (the reference printed
    8,160 for AI_Challenger under pkuseg, ai_challenge_tokenizer.py:131).
    """
    train_set = set(train_div) if train_div is not None else None
    word_cnt: Dict[str, int] = {}
    with open(token_path, "r", encoding="utf-8") as f:
        for line in f:
            name, words = _parse_token_line(line)
            if train_set is not None and name not in train_set:
                continue
            for w in words:
                word_cnt[w] = word_cnt.get(w, 0) + 1

    ranked = sorted(word_cnt.items(), key=lambda kv: kv[1], reverse=True)
    keep = min(max_keep, len(ranked))
    kept = [w for i, (w, c) in enumerate(ranked, 1) if c >= minimum_occur and i <= keep]

    vocab = SPECIALS + kept
    idx_word = {i: w for i, w in enumerate(vocab)}
    word_idx = {w: i for i, w in enumerate(vocab)}
    if return_stats:
        return word_idx, idx_word, {"unk_word_types": len(word_cnt) - len(kept)}
    return word_idx, idx_word


def tokenize(
    token_path: str, word_idx: Dict[str, int], rng: random.Random | None = None
) -> List[Tuple[str, List[int]]]:
    """Map each caption line to ids with <unk> fallback; shuffle (seeded)."""
    unk = word_idx["<unk>"]
    tokens: List[Tuple[str, List[int]]] = []
    with open(token_path, "r", encoding="utf-8") as f:
        for line in f:
            name, words = _parse_token_line(line)
            tokens.append((name, [word_idx.get(w, unk) for w in words]))
    (rng or random.Random(SHUFFLE_SEED)).shuffle(tokens)
    return tokens


def build_training_db(
    word_idx: Dict[str, int],
    tokens: Iterable[Tuple[str, List[int]]],
    names: Sequence[str],
    sentences_per_image: int = 5,
    rng: random.Random | None = None,
) -> Tuple[List[Tuple[str, np.ndarray]], int]:
    """(name, padded int64 ids) pairs for the training split.

    Keeps at most ``sentences_per_image`` captions per image, wraps each with
    <start>/<stop>, zero-pads to the global max length, shuffles.
    """
    start, stop = word_idx["<start>"], word_idx["<stop>"]
    remaining = {name: sentences_per_image for name in names}
    result: List[Tuple[str, np.ndarray]] = []
    max_len = 0
    for name, token in tokens:
        if remaining.get(name, 0) > 0:
            remaining[name] -= 1
            wrapped = np.array([start] + token + [stop], dtype=np.int64)
            max_len = max(max_len, wrapped.size)
            result.append((name, wrapped))
    result = [
        (name, np.pad(tok, (0, max_len - tok.size), constant_values=PAD_ID))
        for name, tok in result
    ]
    (rng or random.Random(SHUFFLE_SEED)).shuffle(result)
    return result, max_len


def build_eval_db(
    token_path: str, names: Sequence[str]
) -> Dict[str, List[List[str]]]:
    """image name -> list of reference captions (each a word list)."""
    result: Dict[str, List[List[str]]] = {name: [] for name in names}
    with open(token_path, "r", encoding="utf-8") as f:
        for line in f:
            name, words = _parse_token_line(line)
            if name in result:
                result[name].append(words)
    return result


def load_division(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f]


def main(cfg=None) -> Dict[str, object]:
    """Run the full tokenize stage; writes the reference's artifact set.

    Mirrors ai_challenge_tokenizer.main() (:102-124). Returns a summary dict
    (train size / vocab size / max_len) that the reference only printed.
    """
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    out_dir = cfg.build_dataset.output_path
    temp = os.path.join(out_dir, "temp")
    token_path = os.path.join(temp, "token")
    os.makedirs(out_dir, exist_ok=True)

    train, dev, test = (
        load_division(os.path.join(temp, n))
        for n in ("train.txt", "dev.txt", "test.txt")
    )
    word_idx, idx_word, dict_stats = build_dict(
        token_path, train, max_keep=cfg.build_dataset.max_keep, return_stats=True
    )
    np.save(
        os.path.join(out_dir, "word_dict.npy"),
        np.array([word_idx, idx_word], dtype=object),
        allow_pickle=True,
    )

    # The reference seeds `random` once at import and the shuffles in
    # tokenize() and build_training_db() consume the same stream; replicate
    # with one shared Random instance.
    rng = random.Random(SHUFFLE_SEED)
    tokens = tokenize(token_path, word_idx, rng=rng)
    train_db, max_len = build_training_db(word_idx, tokens, train, rng=rng)
    np.save(
        os.path.join(out_dir, "train_cap.npy"),
        np.array([train_db, max_len], dtype=object),
        allow_pickle=True,
    )
    np.save(
        os.path.join(out_dir, "dev_data.npy"),
        np.array([dev, build_eval_db(token_path, dev)], dtype=object),
        allow_pickle=True,
    )
    np.save(
        os.path.join(out_dir, "eval_data.npy"),
        np.array([test, build_eval_db(token_path, test)], dtype=object),
        allow_pickle=True,
    )

    with open(os.path.join(out_dir, "word2idx.json"), "w", encoding="utf-8") as f:
        json.dump(word_idx, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "idx2word.json"), "w", encoding="utf-8") as f:
        json.dump(idx_word, f, ensure_ascii=False)

    summary = {
        "train_size": len(train_db),
        "vocab_size": len(word_idx),
        "unk_word_types": dict_stats["unk_word_types"],
        "max_len": max_len,
        "start": word_idx["<start>"],
        "stop": word_idx["<stop>"],
    }
    # provenance + golden-stat snapshot next to word_dict.npy (the reference
    # printed these, ai_challenge_tokenizer.py:130-131; persisted here so a
    # dataset artifact set is self-describing)
    from myimagecaptioningmodel_tpu_torch.data.dataset_gen import update_dataset_meta

    update_dataset_meta(out_dir, **summary)
    return summary
