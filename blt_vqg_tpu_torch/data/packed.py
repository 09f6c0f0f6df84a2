"""Packed dataset: memory-mapped runtime format for maximum ingest speed.

SURVEY.md §2.9's plan for the HDF5 dependency: keep hdf5 for the offline
ETL, but serve training from memory-mapped numpy shards.  ``pack_hdf5``
converts an hdf5 file (reference schema) into a directory:

    images.npy   [M, S, S, 3] uint8, opened with mmap (zero-copy page cache)
    tokens.npz   questions/answers/answer_types/image_indices/image_ids

``PackedDataset`` exposes the same ``batch()`` interface as IQDataset but
the hot path is native: threaded row gather out of the mmap
(native/vqg_io.cc) + C token surgery.  uint8 rows are shipped to the device
as-is — 4× less host→HBM traffic than the reference's float32 images
(reference store_dataset.py:81-82); normalization happens on device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from blt_vqg_tpu_torch.data import native


def pack_hdf5(hdf5_path: str, out_dir: str,
              uint8_images: bool = True) -> str:
    import h5py
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(hdf5_path, "r") as f:
        images = f["images"][:]
        if uint8_images:
            if images.dtype != np.uint8:
                # reference files store raw 0..255 floats
                images = np.clip(images, 0, 255).astype(np.uint8)
        np.save(os.path.join(out_dir, "images.npy"), images)
        np.savez(os.path.join(out_dir, "tokens.npz"),
                 questions=f["questions"][:].astype(np.int32),
                 answers=f["answers"][:].astype(np.int32),
                 answer_types=f["answer_types"][:].astype(np.int32),
                 image_indices=f["image_indices"][:].astype(np.int64),
                 image_ids=f["image_ids"][:].astype(np.int64))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"source": os.path.abspath(hdf5_path),
                   "uint8_images": bool(uint8_images)}, f)
    return out_dir


class PackedDataset:
    """Same batch() contract as IQDataset, served from mmap + native kernels."""

    PAD, START, END, POS = 0, 1, 3, 5

    def __init__(self, directory: str, vocab,
                 cat2name_path: Optional[str] = None,
                 max_examples: Optional[int] = None):
        self.directory = directory
        self.images = np.load(os.path.join(directory, "images.npy"),
                              mmap_mode="r")
        toks = np.load(os.path.join(directory, "tokens.npz"))
        self.questions = toks["questions"]
        self.answers = toks["answers"]
        self.answer_types_raw = toks["answer_types"]
        self.image_indices = toks["image_indices"]
        self.image_ids = toks["image_ids"]
        self.max_examples = max_examples
        if cat2name_path:
            cats = sorted(json.load(open(cat2name_path)))
            self.cat_word_ids = np.array([vocab(c) for c in cats], np.int32)
        else:
            self.cat_word_ids = None

    def __len__(self) -> int:
        if self.max_examples is not None:
            return self.max_examples
        return len(self.questions)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx)
        questions = self.questions[idx]
        answers = self.answers[idx]
        at_raw = self.answer_types_raw[idx]
        image_ids = self.image_ids[idx]

        if self.cat_word_ids is not None:
            type_word = self.cat_word_ids[at_raw]
        else:
            type_word = (at_raw + 6).astype(np.int32)  # skip reserved ids

        images = native.gather_rows(self.images, self.image_indices[idx])
        posterior = native.make_posterior(
            questions, self.POS, self.END, self.PAD, type_word)
        answer = native.token_surgery(answers, self.END, self.PAD, type_word)

        n = len(idx)
        at_input = np.stack([
            np.full(n, self.START, np.int32), type_word.astype(np.int32),
            np.full(n, self.END, np.int32)], axis=1)
        return {
            "images": images,
            "image_ids": image_ids,
            "questions": questions.astype(np.int32),
            "posteriors": posterior,
            "answers": answer,
            "answer_types": type_word.astype(np.int32),
            "answer_types_for_input": at_input,
            "qindices": np.argsort(
                (questions != self.PAD).sum(1))[::-1].copy(),
        }
