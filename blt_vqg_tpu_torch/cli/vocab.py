"""Vocabulary CLI (counterpart of ``blt_vqg_tpu/cli/vocab.py``, the
same flags and files).

    python -m blt_vqg_tpu_torch.cli.vocab --questions ... --cat2ans ... \
        --vocab-path vocab.json [--threshold 4] [--bpe]
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--questions", type=str,
                        default="data/vqa/v2_OpenEnded_mscoco_train2014_questions.json")
    parser.add_argument("--cat2ans", type=str,
                        default="data/vqa/iq_dataset.json")
    parser.add_argument("--threshold", type=int, default=4)
    parser.add_argument("--vocab-path", type=str, default="vocab.json")
    parser.add_argument("--bpe", action="store_true",
                        help="train a byte-level BPE tokenizer instead of "
                             "the word vocabulary")
    parser.add_argument("--bpe-vocab-size", type=int, default=8192)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.bpe:
        import json
        from blt_vqg_tpu_torch.text.bpe import BPETokenizer
        with open(args.questions) as f:
            corpus = [e["question"] for e in json.load(f)["questions"]]
        with open(args.cat2ans) as f:
            cat2ans = json.load(f)
        corpus += [a for cat in cat2ans for a in cat2ans[cat]]
        tok = BPETokenizer()
        tok.train(corpus, vocab_size=args.bpe_vocab_size)
        tok.save(args.vocab_path)
        logging.info("BPE tokenizer: %d tokens, %d merges → %s",
                     len(tok), len(tok.merges), args.vocab_path)
        return 0

    from blt_vqg_tpu_torch.text.build import build_vocab
    vocab = build_vocab(args.questions, args.cat2ans, args.threshold,
                        save_path=args.vocab_path)
    logging.info("vocabulary size: %d → %s", len(vocab), args.vocab_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
