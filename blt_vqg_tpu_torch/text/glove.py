"""GloVe embedding-table initialization.

Reference behavior (reference models/iq.py:57-79): start from N(0, 0.01)
embeddings, overwrite rows whose word appears in a GloVe text file, report
coverage.  This is host-side, numpy-only — the resulting table is fed into
the model's init as the embedding param.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


def load_glove_embeddings(
    vocab,
    emb_dim: int,
    emb_file: Optional[str] = None,
    seed: int = 0,
) -> np.ndarray:
    vocab_size = len(vocab)
    rng = np.random.RandomState(seed)
    table = (rng.randn(vocab_size, emb_dim) * 0.01).astype(np.float32)
    if emb_file is None or not os.path.exists(emb_file or ""):
        if emb_file:
            log.warning("GloVe file %s not found; random init only", emb_file)
        return table

    pre_trained = 0
    with open(emb_file) as f:
        for line in f:
            sp = line.split()
            if len(sp) != emb_dim + 1:
                continue
            word = sp[0]
            if word in vocab.word2idx:
                table[vocab.word2idx[word]] = np.asarray(sp[1:], dtype=np.float32)
                pre_trained += 1
    log.info("GloVe pre-trained rows: %d (%.2f%%)",
             pre_trained, 100.0 * pre_trained / max(vocab_size, 1))
    return table


def get_glove_embedding(name: str, embed_size: int, vocab,
                        cache_dir: str = ".vector_cache") -> np.ndarray:
    """torchtext-style named-GloVe path (reference
    utils/train_utils.py:102-120: ``torchtext.vocab.GloVe(name, dim)``).

    Resolves ``{cache_dir}/glove.{name}.{embed_size}d.txt`` — the exact
    file torchtext's downloader leaves in its .vector_cache — and builds
    the embedding table from it.  TPU pods never download; the cache file
    is provisioned offline.  Falls back to random init (with a warning)
    when the cache is absent, like load_glove_embeddings.
    """
    path = os.path.join(cache_dir, f"glove.{name}.{embed_size}d.txt")
    return load_glove_embeddings(vocab, embed_size, path)
