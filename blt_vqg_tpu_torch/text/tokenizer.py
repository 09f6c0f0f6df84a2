"""Tokenization compatible with the reference pipeline.

The reference applies regex cleanup then nltk's Punkt/Treebank word_tokenize
(reference utils/vocab.py:51-68).  We keep the identical regex pre-pass and
implement a self-contained Treebank-style splitter (no external model files —
TPU pods have no business downloading nltk data at import time).  For the VQA
question/answer distribution (lowercased short English sentences) the output
matches nltk word_tokenize; golden tests in tests/test_text.py pin the
behavior.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

# Contractions split the way Treebank does.
_CONTRACTIONS = [
    (re.compile(r"\b(can)(not)\b"), r"\1 \2"),
    (re.compile(r"\b(d)('ye)\b"), r"\1 \2"),
    (re.compile(r"\b(gim)(me)\b"), r"\1 \2"),
    (re.compile(r"\b(gon)(na)\b"), r"\1 \2"),
    (re.compile(r"\b(got)(ta)\b"), r"\1 \2"),
    (re.compile(r"\b(lem)(me)\b"), r"\1 \2"),
    (re.compile(r"\b(wan)(na)\b"), r"\1 \2"),
]
_APOSTROPHE = re.compile(r"([^' ])('s|'m|'d|'ll|'re|'ve|n't)\b")
_PUNCT = re.compile(r"([^\w\s'\-])")


def _treebank_split(sentence: str) -> List[str]:
    s = sentence
    s = _PUNCT.sub(r" \1 ", s)
    s = _APOSTROPHE.sub(r"\1 \2", s)
    for pattern, repl in _CONTRACTIONS:
        s = pattern.sub(repl, s)
    return s.split()


def tokenize(sentence: str) -> List[str]:
    """Tokenizes a sentence (reference utils/vocab.py:51-68 semantics).

    Regex pre-pass is byte-identical to the reference: collapse repeated
    periods, space out punctuation following a letter, squeeze whitespace;
    then lowercase and word-split.
    """
    if len(sentence) == 0:
        return []
    sentence = re.sub(r"\.+", r".", sentence)
    sentence = re.sub(r"([a-z])([.,!?()])", r"\1 \2 ", sentence)
    sentence = re.sub(r"\s+", " ", sentence)
    return _treebank_split(sentence.strip().lower())


def process_text(text: str, vocab, max_length: int = 20) -> Tuple[np.ndarray, int]:
    """<start> + tokens + <end>, truncated to max_length
    (reference utils/vocab.py:16-34)."""
    tokens = tokenize(text.lower().strip())
    output = [vocab(vocab.SYM_SOQ)]
    output.extend(vocab(t) for t in tokens)
    output.append(vocab(vocab.SYM_EOS))
    length = min(max_length, len(output))
    return np.array(output[:length], dtype=np.int32), length
