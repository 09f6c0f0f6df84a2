"""Synthetic tiny-VQA hdf5 fixture (SURVEY.md §4 test strategy).

Writes a file with the exact reference schema (store_dataset.py:75-88) from
a seeded RNG — used by end-to-end train-smoke tests and benchmarks without
the real VQA v2 download.
"""

from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def write_synthetic_hdf5(path: str, num_questions: int = 64,
                         num_images: int = 16, im_size: int = 64,
                         vocab_size: int = 50, max_q_length: int = 20,
                         max_a_length: int = 4, num_categories: int = 8,
                         seed: int = 0, uint8_images: bool = False,
                         learnable: bool = False) -> str:
    """``learnable=True`` makes the question a deterministic template of the
    answer category (plus a category-dependent answer), so a correct model
    drives the reconstruction loss to ~0 and BLEU toward 1 — used to
    validate end-to-end training *dynamics*, not just mechanics."""
    rng = np.random.RandomState(seed)
    START, END = 1, 3
    first_word = 6  # ids 0-5 are reserved

    def rand_seq(max_len, lo_len, hi_len):
        seqs = np.zeros((num_questions, max_len), dtype=np.int32)
        for i in range(num_questions):
            n = rng.randint(lo_len, hi_len + 1)
            n = min(n, max_len - 2)
            seqs[i, 0] = START
            seqs[i, 1:1 + n] = rng.randint(first_word, vocab_size, size=n)
            seqs[i, 1 + n] = END
        return seqs

    answer_types = rng.randint(0, num_categories,
                               size=num_questions).astype(np.int32)
    if learnable:
        # question = [<start>, 5 category-determined words, <end>]
        questions = np.zeros((num_questions, max_q_length), dtype=np.int32)
        answers = np.zeros((num_questions, max_a_length), dtype=np.int32)
        span = max(1, (vocab_size - first_word - num_categories) // max(
            num_categories, 1))
        for i, cat in enumerate(answer_types):
            base = first_word + num_categories + (int(cat) * span) % max(
                vocab_size - first_word - num_categories - 5, 1)
            words = [first_word + (base + j) % (vocab_size - first_word)
                     for j in range(5)]
            questions[i, 0] = START
            questions[i, 1:6] = words
            questions[i, 6] = END
            answers[i, 0] = START
            answers[i, 1] = first_word + int(cat)
            answers[i, 2] = END
    else:
        questions = rand_seq(max_q_length, 3, max_q_length - 2)
        answers = rand_seq(max_a_length, 1, max_a_length - 2)
    image_indices = rng.randint(0, num_images,
                                size=num_questions).astype(np.int32)
    image_ids = np.arange(num_questions, dtype=np.int32) + 1000
    if uint8_images:
        images = rng.randint(0, 256, size=(num_images, im_size, im_size, 3)
                             ).astype(np.uint8)
    else:
        images = rng.rand(num_images, im_size, im_size, 3).astype(np.float32) * 255.0

    with h5py.File(path, "w") as f:
        f.create_dataset("questions", data=questions)
        f.create_dataset("answers", data=answers)
        f.create_dataset("answer_types", data=answer_types)
        f.create_dataset("image_indices", data=image_indices)
        f.create_dataset("image_ids", data=image_ids)
        f.create_dataset("images", data=images)
    return path
