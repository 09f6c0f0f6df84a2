"""Vocabulary construction from VQA annotations.

Mirrors reference utils/vocab.py:71-121: every category name and answer word
enters the vocab unconditionally; question words enter if their corpus count
meets the threshold (default 4); insertion order is preserved and
deduplicated, so token ids are reproducible.
"""

from __future__ import annotations

import json
import logging
from collections import Counter
from typing import List

from blt_vqg_tpu_torch.text.tokenizer import tokenize
from blt_vqg_tpu_torch.text.vocabulary import Vocabulary

log = logging.getLogger(__name__)


def build_vocab(questions_path: str, cat2ans_path: str, threshold: int = 4,
                save_path: str | None = None) -> Vocabulary:
    with open(questions_path) as f:
        questions = json.load(f)
    with open(cat2ans_path) as f:
        cat2ans = json.load(f)

    words: List[str] = []
    for category in cat2ans:
        words.extend(tokenize(category))
        for answer in cat2ans[category]:
            words.extend(tokenize(answer))

    counter: Counter = Counter()
    for i, entry in enumerate(questions["questions"]):
        counter.update(tokenize(entry["question"]))
        if i % 10000 == 0:
            log.info("Tokenized %d questions.", i)

    words.extend(w for w, cnt in counter.items() if cnt >= threshold)
    words = list(dict.fromkeys(words))  # dedup, preserve order

    vocab = Vocabulary()
    for word in words:
        vocab.add_word(word)
    if save_path:
        vocab.save(save_path)
    return vocab
