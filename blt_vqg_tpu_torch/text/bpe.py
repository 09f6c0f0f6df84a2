"""Byte-level BPE tokenizer (model-family extension; BASELINE.json config 4).

Self-contained: trainable on the VQA question corpus (no downloads, no
external tokenizer libs), JSON-serializable, reversible.  Standard BPE over
UTF-8 bytes with a word-frequency table and incremental pair-count updates
(only words containing the merged pair are rewritten per step).

The word-level Vocabulary (text/vocabulary.py) remains the default for
reference parity; BPE is the scaling path (open vocabulary, smaller output
projection than a word vocab at equal coverage).
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

# reserved ids mirror text/vocabulary.py so model code is tokenizer-agnostic
RESERVED = ("<pad>", "<start>", "<resp>", "<end>", "<unk>", "<pos>")


def _word_to_bytes(word: str) -> Tuple[str, ...]:
    return tuple(f"b{b}" for b in word.encode("utf-8"))


class BPETokenizer:
    def __init__(self):
        self.merges: List[Tuple[str, str]] = []
        self.token2id: Dict[str, int] = {}
        self.id2token: Dict[int, str] = {}
        for sym in RESERVED:
            self._add(sym)
        for b in range(256):
            self._add(f"b{b}")

    # -- construction --------------------------------------------------
    def _add(self, tok: str) -> int:
        if tok not in self.token2id:
            idx = len(self.token2id)
            self.token2id[tok] = idx
            self.id2token[idx] = tok
        return self.token2id[tok]

    def train(self, corpus: Iterable[str], vocab_size: int = 8192) -> None:
        """Learns merges until ``vocab_size`` tokens exist."""
        word_freq: Counter = Counter()
        for line in corpus:
            for word in line.lower().strip().split():
                word_freq[word] += 1
        # symbol sequences per unique word, space marker prepended (GPT-2
        # style word boundary: a leading space byte)
        seqs: Dict[str, Tuple[str, ...]] = {
            w: _word_to_bytes(" " + w) for w in word_freq}

        pair_counts: Counter = Counter()
        pair_words: defaultdict = defaultdict(set)
        for w, seq in seqs.items():
            f = word_freq[w]
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += f
                pair_words[(a, b)].add(w)

        while len(self.token2id) < vocab_size and pair_counts:
            (a, b), count = pair_counts.most_common(1)[0]
            if count < 2:
                break
            merged = f"{a}|{b}"
            self.merges.append((a, b))
            self._add(merged)
            # rewrite only affected words, updating pair counts around them
            for w in list(pair_words[(a, b)]):
                seq = seqs[w]
                f = word_freq[w]
                for x, y in zip(seq, seq[1:]):
                    pair_counts[(x, y)] -= f
                    if pair_counts[(x, y)] <= 0:
                        del pair_counts[(x, y)]
                    pair_words[(x, y)].discard(w)
                seqs[w] = self._apply_merge(seq, a, b, merged)
                seq = seqs[w]
                for x, y in zip(seq, seq[1:]):
                    pair_counts[(x, y)] += f
                    pair_words[(x, y)].add(w)

    @staticmethod
    def _apply_merge(seq: Sequence[str], a: str, b: str,
                     merged: str) -> Tuple[str, ...]:
        out: List[str] = []
        i = 0
        while i < len(seq):
            if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                out.append(merged)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return tuple(out)

    # -- encode / decode ------------------------------------------------
    def _merge_rank(self) -> Dict[Tuple[str, str], int]:
        ranks = getattr(self, "_ranks_cache", None)
        if ranks is None or len(ranks) != len(self.merges):
            ranks = {pair: i for i, pair in enumerate(self.merges)}
            self._ranks_cache = ranks
        return ranks

    def encode_word(self, word: str) -> List[int]:
        cache = getattr(self, "_word_cache", None)
        if cache is None:
            cache = self._word_cache = {}
        hit = cache.get(word)
        if hit is not None:
            return hit
        seq = list(_word_to_bytes(" " + word))
        ranks = self._merge_rank()
        while len(seq) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            a, b = seq[best], seq[best + 1]
            seq[best:best + 2] = [f"{a}|{b}"]
        ids = [self.token2id.get(t, self.token2id["<unk>"]) for t in seq]
        cache[word] = ids
        return ids

    def encode(self, text: str, max_length: int | None = None,
               add_special: bool = True) -> List[int]:
        ids: List[int] = []
        if add_special:
            ids.append(self.token2id["<start>"])
        for word in text.lower().strip().split():
            ids.extend(self.encode_word(word))
        if add_special:
            ids.append(self.token2id["<end>"])
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        byte_vals: List[int] = []
        for i in ids:
            tok = self.id2token.get(int(i))
            if tok is None or tok in RESERVED:
                if tok == "<end>":
                    break
                continue
            for atom in tok.split("|"):
                if atom.startswith("b"):
                    byte_vals.append(int(atom[1:]))
        return bytes(byte_vals).decode("utf-8", errors="replace").strip()

    def __len__(self) -> int:
        return len(self.token2id)

    # -- Vocabulary-compat surface (text/vocabulary.py API) --------------
    # These make a BPETokenizer a drop-in for IQDataset / Trainer / the
    # CLIs: categories map to their FIRST BPE token (one id per category,
    # the single-token contract the posterior surgery needs,
    # data/dataset.py:117-118), and decode reports print BPE fragments.

    def __call__(self, word: str) -> int:
        """Single-token id for ``word`` — its first BPE piece."""
        return self.encode_word(word)[0]

    def __contains__(self, word: str) -> bool:
        return True  # open vocabulary: every string byte-encodes

    @property
    def word2idx(self) -> Dict[str, int]:
        return self.token2id

    @property
    def idx2word(self) -> Dict[int, str]:
        return self.id2token

    def tokens_to_words(self, tokens: Iterable[int]) -> str:
        """Detokenize, stopping at <end> (Vocabulary.tokens_to_words API)."""
        return self.decode(int(t) for t in tokens)

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "token2id": self.token2id}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        tok = cls()
        with open(path) as f:
            data = json.load(f)
        tok.merges = [tuple(m) for m in data["merges"]]
        tok.token2id = {str(k): int(v) for k, v in data["token2id"].items()}
        tok.id2token = {v: k for k, v in tok.token2id.items()}
        return tok
