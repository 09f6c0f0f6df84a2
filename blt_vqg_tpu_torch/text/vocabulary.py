"""Vocabulary with the reference's reserved-symbol contract.

Token ids 0-5 are pinned to the same six reserved symbols in the same order
as the reference (reference utils/train_utils.py:17-37):
``<pad>=0 <start>=1 <resp>=2 <end>=3 <unk>=4 <pos>=5``.  Datasets built by
either codebase are therefore token-compatible.  Persistence is JSON
(reference train_utils.py:68-79); unknown words map to ``<unk>``
(reference train_utils.py:60-63).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Union


class Vocabulary:
    SYM_PAD = "<pad>"
    SYM_SOQ = "<start>"
    SYM_SOR = "<resp>"
    SYM_EOS = "<end>"
    SYM_UNK = "<unk>"
    SYM_POS = "<pos>"

    RESERVED = (SYM_PAD, SYM_SOQ, SYM_SOR, SYM_EOS, SYM_UNK, SYM_POS)

    def __init__(self):
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        for sym in self.RESERVED:
            self.add_word(sym)

    # -- ids for the reserved symbols (constant by construction) --
    @property
    def pad(self) -> int: return self.word2idx[self.SYM_PAD]
    @property
    def start(self) -> int: return self.word2idx[self.SYM_SOQ]
    @property
    def end(self) -> int: return self.word2idx[self.SYM_EOS]
    @property
    def unk(self) -> int: return self.word2idx[self.SYM_UNK]
    @property
    def pos(self) -> int: return self.word2idx[self.SYM_POS]

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word
        return self.word2idx[word]

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[self.SYM_UNK])

    def __len__(self) -> int:
        return len(self.word2idx)

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    # -- persistence (JSON, reference train_utils.py:68-79 schema) --
    def save(self, location: str) -> None:
        with open(location, "w") as f:
            json.dump({"word2idx": self.word2idx,
                       "idx2word": {str(k): v for k, v in self.idx2word.items()},
                       "idx": len(self.word2idx)}, f)

    def load(self, location: str) -> None:
        with open(location) as f:
            data = json.load(f)
        self.word2idx = {str(w): int(i) for w, i in data["word2idx"].items()}
        self.idx2word = {int(i): str(w) for i, w in data["idx2word"].items()}

    # -- detokenization (reference train_utils.py:81-99 semantics) --
    def tokens_to_words(self, tokens: Iterable[Union[int, "object"]]) -> str:
        """Detokenize, stopping at <end>, dropping structural symbols."""
        structural = {self.SYM_PAD, self.SYM_SOQ, self.SYM_SOR, self.SYM_EOS}
        words: List[str] = []
        for token in tokens:
            idx = int(token)
            word = self.idx2word.get(idx, self.SYM_UNK)
            if word == self.SYM_EOS:
                break
            if word not in structural:
                words.append(word)
        return " ".join(words)


def load_vocab(vocab_path: str):
    """Loads a tokenizer from JSON — a word Vocabulary (reference
    train_utils.py:68-79 schema) or, when the file carries a ``merges``
    table, a byte-level BPETokenizer (text/bpe.py; BASELINE config 4).
    Both expose the same surface (``__call__``/``__len__``/``idx2word``/
    ``tokens_to_words``), so callers are tokenizer-agnostic."""
    with open(vocab_path) as f:
        data = json.load(f)
    if "merges" in data:
        from blt_vqg_tpu_torch.text.bpe import BPETokenizer
        return BPETokenizer.load(vocab_path)
    v = Vocabulary()
    v.load(vocab_path)
    return v
