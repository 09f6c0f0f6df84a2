"""hdf5-backed IQ dataset with the reference's per-item token surgery.

Schema (identical to reference store_dataset.py:75-88): datasets
``questions (N, 20) i``, ``answers (N, 4) i``, ``answer_types (N,) i``,
``image_indices (N,) i``, ``image_ids (N,) i``, ``images (M, S, S, 3)``.

Per-item construction (reference data_loader.py:62-116), vectorized in
numpy at batch-assembly time instead of per-item Python in worker processes:

  posterior  = question; pos0 ← <pos>; first <end> → removed, <pad>
               appended; answer-type *word id* inserted at index 1
  answer     = same <end>-removal surgery; answer-type word id at index 1
  answer_type_for_input = [<start>, type_word_id, <end>]
  answer_type (label)   = vocab word id of the sorted-cat2name category

Image augmentation happens on device (data/augment.py), so this module only
hands out raw image rows.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def _drop_first_token(rows: np.ndarray, token_id: int) -> np.ndarray:
    """Removes the first occurrence of ``token_id`` per row and appends <pad>
    (vectorized equivalent of the reference's list.remove/append,
    data_loader.py:66-76)."""
    n, t = rows.shape
    out = np.empty_like(rows)
    hit = rows == token_id
    has = hit.any(axis=1)
    first = np.where(has, hit.argmax(axis=1), t)
    for i in range(n):  # t ≤ 21; this loop is trivial next to h5 IO
        f = first[i]
        if f < t:
            out[i, :f] = rows[i, :f]
            out[i, f:t - 1] = rows[i, f + 1:]
            out[i, t - 1] = 0
        else:
            out[i] = rows[i]
    return out


def _insert_at_1(rows: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Inserts values[i] at index 1 of row i (length grows by 1)."""
    n, t = rows.shape
    out = np.empty((n, t + 1), dtype=rows.dtype)
    out[:, 0] = rows[:, 0]
    out[:, 1] = values
    out[:, 2:] = rows[:, 1:]
    return out


class IQDataset:
    """Random-access view over the hdf5 file; returns assembled batches."""

    PAD, START, END, POS = 0, 1, 3, 5  # reserved ids (text/vocabulary.py)

    def __init__(self, path: str, vocab, cat2name_path: Optional[str] = None,
                 max_examples: Optional[int] = None,
                 indices: Optional[np.ndarray] = None):
        self.path = path
        self.vocab = vocab
        self._file: Optional[h5py.File] = None
        self.max_examples = max_examples
        self.indices = indices
        if cat2name_path:
            with open(cat2name_path) as f:
                self.cat2name = sorted(json.load(f))
        else:
            self.cat2name = None
        # category index → vocab word id of the category name
        # (reference data_loader.py:78-79)
        if self.cat2name is not None:
            self.cat_word_ids = np.array(
                [vocab(name) for name in self.cat2name], dtype=np.int32)
        else:
            self.cat_word_ids = None

    @property
    def file(self) -> h5py.File:
        if self._file is None:  # lazy per-process open (h5py is not fork-safe)
            import h5py
            self._file = h5py.File(self.path, "r")
        return self._file

    def __len__(self) -> int:
        if self.max_examples is not None:
            return self.max_examples
        if self.indices is not None:
            return len(self.indices)
        return self.file["questions"].shape[0]

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Assembles the 8-key reference batch dict for the given rows."""
        if self.indices is not None:
            idx = self.indices[idx]
        # h5py fancy indexing wants unique increasing indices; weighted
        # sampling (with replacement) can repeat rows — dedupe and expand
        idx = np.asarray(idx)
        uniq_q, inv_q = np.unique(idx, return_inverse=True)
        f = self.file
        questions = f["questions"][uniq_q][inv_q].astype(np.int32)
        answers = f["answers"][uniq_q][inv_q].astype(np.int32)
        answer_types_raw = f["answer_types"][uniq_q][inv_q].astype(np.int32)
        image_indices = f["image_indices"][uniq_q][inv_q].astype(np.int64)
        image_ids = f["image_ids"][uniq_q][inv_q].astype(np.int64)

        # images keyed by image_indices (may repeat; h5py wants unique sorted)
        uniq, inverse = np.unique(image_indices, return_inverse=True)
        images = f["images"][uniq][inverse]

        if self.cat_word_ids is not None:
            type_word = self.cat_word_ids[answer_types_raw]
        else:
            # synthetic fixtures without a category map: shift past the 6
            # reserved ids so category indices never alias <pad>/<end>/...
            type_word = answer_types_raw + 6
        answer_types = type_word

        posterior = questions.copy()
        posterior[:, 0] = self.POS
        posterior = _drop_first_token(posterior, self.END)
        posterior = _insert_at_1(posterior, type_word)

        answer = _drop_first_token(answers, self.END)
        answer = _insert_at_1(answer, type_word)

        n = len(idx)
        at_input = np.stack([
            np.full(n, self.START, np.int32),
            type_word.astype(np.int32),
            np.full(n, self.END, np.int32)], axis=1)

        return {
            "images": images,
            "image_ids": image_ids,
            "questions": questions,
            "posteriors": posterior.astype(np.int32),
            "answers": answer.astype(np.int32),
            "answer_types": answer_types.astype(np.int32),
            "answer_types_for_input": at_input,
            "qindices": np.argsort(
                (questions != self.PAD).sum(1))[::-1].copy(),
        }


def example_from_row(batch: Dict[str, np.ndarray], input_mode: str
                     ) -> Dict[str, np.ndarray]:
    """Maps the 8-key reference dict to the canonical model batch
    (train/step.py contract)."""
    context = (batch["answers"] if input_mode == "ans"
               else batch["answer_types_for_input"])
    return {
        "images": batch["images"],
        "context": context,
        "posterior": batch["posteriors"],
        "target": batch["questions"],
    }
