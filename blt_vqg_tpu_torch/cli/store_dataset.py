"""Offline ETL: VQA v2 JSON + COCO JPEGs -> hdf5 in the reference's schema
(counterpart of ``blt_vqg_tpu/cli/store_dataset.py``, the same flags,
schema and files).

    python -m blt_vqg_tpu_torch.cli.store_dataset --image-dir ... \
        --questions ... --annotations ... --cat2ans ... --output ... [--val]

- ``--uint8`` stores uint8 images instead of raw float32 (4x smaller; the
  loader normalizes them, data/augment.py); float32 stays the default,
  as in reference-built files;
- a missing image is skipped with a log line (both COCO filename formats
  are tried);
- ``--tokenizer bpe`` trains a byte-level BPE tokenizer (text/bpe.py);
- ``--shard I/N`` writes every N-th eligible QA from I, one hdf5 shard per
  ETL host.

Host-side only: ``h5py`` and ``PIL`` are imported inside the functions
that need them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

log = logging.getLogger("store_dataset")


def filter_answers(annotations: dict, ans2cat: dict):
    """qid→answer for answers within the category set; touched image ids
    (reference store_dataset.py:21-42 semantics)."""
    answers = {}
    image_ids = set()
    for q in annotations["annotations"]:
        ans = q["multiple_choice_answer"]
        if ans in ans2cat:
            answers[q["question_id"]] = ans
            image_ids.add(q["image_id"])
    return answers, image_ids


def _load_image(image_dir: str, split: str, image_id: int, im_size: int):
    from PIL import Image
    for pattern in (f"COCO_{split}2014_{image_id}.jpg",
                    f"COCO_{split}2014_{image_id:012d}.jpg"):
        path = os.path.join(image_dir, pattern)
        if os.path.exists(path):
            img = Image.open(path).convert("RGB").resize((im_size, im_size))
            return np.asarray(img)
    return None


def save_dataset(image_dir, questions_path, annotations_path, vocab, ans2cat,
                 output, im_size=224, max_q_length=20, max_a_length=4,
                 split="train", uint8=False, shard=None):
    """``shard=(i, n)`` writes only every n-th eligible QA starting at i —
    the multihost-ETL split (each host builds its own hdf5 shard; shards are
    disjoint and their union is the unsharded dataset).  Images are stored
    per shard, indexed by the shard-local ``image_indices``."""
    import h5py
    from blt_vqg_tpu_torch.text.tokenizer import (
        process_text as word_process_text)

    if hasattr(vocab, "merges"):  # BPE tokenizer (text/bpe.py)
        def process_text(text, _vocab, max_length):
            ids = vocab.encode(text, max_length=max_length)
            return np.asarray(ids, np.int32), len(ids)
    else:
        process_text = word_process_text

    with open(annotations_path) as f:
        annos = json.load(f)
    with open(questions_path) as f:
        questions = json.load(f)

    qid2ans, image_ids = filter_answers(annos, ans2cat)
    eligible = [e for e in questions["questions"]
                if e["image_id"] in image_ids
                and e["question_id"] in qid2ans]
    if shard is not None:
        i, n = shard
        eligible = eligible[i::n]
    nq = len(eligible)
    ni = len({e["image_id"] for e in eligible})
    log.info("writing %d QAs over %d images%s", nq, ni,
             f" (shard {shard[0]}/{shard[1]})" if shard else "")

    img_dtype = "uint8" if uint8 else "f"
    with h5py.File(output, "w") as h5:
        d_questions = h5.create_dataset("questions", (nq, max_q_length), "i")
        d_indices = h5.create_dataset("image_indices", (nq,), "i")
        d_images = h5.create_dataset("images", (ni, im_size, im_size, 3),
                                     img_dtype)
        d_answers = h5.create_dataset("answers", (nq, max_a_length), "i")
        d_answer_types = h5.create_dataset("answer_types", (nq,), "i")
        d_image_ids = h5.create_dataset("image_ids", (nq,), "i")

        i_index = 0
        q_index = 0
        img2idx = {}
        for entry in eligible:
            image_id = entry["image_id"]
            qid = entry["question_id"]
            if image_id not in img2idx:
                arr = _load_image(image_dir, split, image_id, im_size)
                if arr is None:
                    log.warning("missing image %d — skipped", image_id)
                    continue
                d_images[i_index] = arr if uint8 else arr.astype(np.float32)
                img2idx[image_id] = i_index
                i_index += 1
            q, qlen = process_text(entry["question"], vocab, max_q_length)
            d_questions[q_index, :qlen] = q
            answer = qid2ans[qid]
            a, alen = process_text(answer, vocab, max_a_length)
            d_answers[q_index, :alen] = a
            d_answer_types[q_index] = int(ans2cat[answer])
            d_indices[q_index] = img2idx[image_id]
            d_image_ids[q_index] = image_id
            q_index += 1
            if q_index % 5000 == 0:
                log.info("%d / %d QAs", q_index, nq)
    log.info("wrote %d images, %d QAs → %s", i_index, q_index, output)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image-dir", type=str, default="data/vqa/train2014")
    parser.add_argument("--questions", type=str,
                        default="data/vqa/v2_OpenEnded_mscoco_train2014_questions.json")
    parser.add_argument("--annotations", type=str,
                        default="data/vqa/v2_mscoco_train2014_annotations.json")
    parser.add_argument("--cat2ans", type=str, default="data/vqa/iq_dataset.json")
    parser.add_argument("--vocab-path", type=str,
                        default="data/processed/vocab_iq.json")
    parser.add_argument("--output", type=str,
                        default="data/processed/iq_dataset.hdf5")
    parser.add_argument("--cat2name", type=str,
                        default="data/processed/cat2name.json")
    parser.add_argument("--im_size", type=int, default=224)
    parser.add_argument("--max-q-length", type=int, default=20)
    parser.add_argument("--max-a-length", type=int, default=4)
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--uint8", action="store_true",
                        help="store uint8 images (4x smaller/faster)")
    parser.add_argument("--tokenizer", type=str, default="word",
                        choices=("word", "bpe"),
                        help="'word': reference vocab (vocab.py:71-113); "
                        "'bpe': byte-level BPE (text/bpe.py, BASELINE "
                        "config 4) — model vocab_size comes from the "
                        "trained tokenizer")
    parser.add_argument("--bpe-vocab-size", type=int, default=8192)
    parser.add_argument("--shard", type=str, default=None, metavar="I/N",
                        help="write only every N-th eligible QA starting at "
                        "I (0-based) — one hdf5 shard per ETL host; shards "
                        "are disjoint and union to the full dataset")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from blt_vqg_tpu_torch.text.build import build_vocab
    from blt_vqg_tpu_torch.text.vocabulary import load_vocab

    with open(args.cat2ans) as f:
        cat2ans = json.load(f)
    cats = sorted(cat2ans.keys())
    os.makedirs(os.path.dirname(args.cat2name) or ".", exist_ok=True)
    with open(args.cat2name, "w") as f:
        json.dump(cats, f)
    ans2cat = {ans: cats.index(cat)
               for cat in cat2ans for ans in cat2ans[cat]}

    if args.val:
        vocab = load_vocab(args.vocab_path)  # word or BPE, sniffed
        split = "val"
    elif args.tokenizer == "bpe":
        from blt_vqg_tpu_torch.text.bpe import BPETokenizer
        with open(args.questions) as f:
            corpus = [q["question"] for q in json.load(f)["questions"]]
        corpus += [ans for anss in cat2ans.values() for ans in anss] + cats
        vocab = BPETokenizer()
        vocab.train(corpus, vocab_size=args.bpe_vocab_size)
        os.makedirs(os.path.dirname(args.vocab_path) or ".", exist_ok=True)
        vocab.save(args.vocab_path)
        log.info("trained BPE tokenizer: %d tokens", len(vocab))
        split = "train"
    else:
        vocab = build_vocab(args.questions, args.cat2ans, threshold=4,
                            save_path=args.vocab_path)
        split = "train"

    shard = None
    if args.shard is not None:
        i, n = (int(x) for x in args.shard.split("/"))
        if not 0 <= i < n:
            parser.error(f"--shard {args.shard}: need 0 <= I < N")
        shard = (i, n)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_dataset(args.image_dir, args.questions, args.annotations, vocab,
                 ans2cat, args.output, im_size=args.im_size,
                 max_q_length=args.max_q_length,
                 max_a_length=args.max_a_length, split=split,
                 uint8=args.uint8, shard=shard)
    return 0


if __name__ == "__main__":
    sys.exit(main())
