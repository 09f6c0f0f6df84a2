"""Standalone evaluation of a trained model directory (counterpart of
``blt_vqg_tpu/cli/evaluate_iq.py``, the same flags, outputs and files).

    python -m blt_vqg_tpu_torch.cli.evaluate_iq --model-dir runs/default \
        [--from-category] [--dataset ...] [--beam-size 4] \
        [--num-z-samples 5] [--device cpu]

Reloads ``args.json`` and a checkpoint (the latest unless ``--step``) from
the model directory, decodes the evaluation set greedily (or by beam
search, or by sampling) from the answers or the categories, scores the
questions with the NLG metrics, and with ``--num-z-samples`` k > 1 on a
latent-phase checkpoint also decodes k prior draws per image and scores
their diversity and consistency (train/infomax.py).  Writes
``results.json``, ``preds.json``, ``gts.json`` and, with the draws,
``z_samples.json`` into ``--results-dir`` (default: the model directory).

Only the parameters and batch statistics go to the device; the optimizer
state is restored on the host, as the JAX CLI keeps it there.  Runs on the
CUDA card unless ``--device cpu`` asks for the CPU.  ``main`` returns 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

INFOMAX_SEED = 9_000_000   # the draws of batch i come from seed 9e6 + i


def open_eval_dataset(path, vocab, cat2name=None):
    """A directory is a packed (mmap + native gather) dataset, a file the
    reference-schema hdf5, as in cli/train_iq.py."""
    from blt_vqg_tpu_torch.data.dataset import IQDataset
    from blt_vqg_tpu_torch.data.packed import PackedDataset
    cls = PackedDataset if os.path.isdir(path) else IQDataset
    return cls(path, vocab, cat2name)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", type=str, required=True,
                        help="directory with args.json + checkpoints/")
    parser.add_argument("--dataset", type=str, default=None,
                        help="override the eval dataset (default: "
                        "cfg.val_dataset)")
    parser.add_argument("--from-category", action="store_true",
                        help="condition on the category token instead of "
                        "the answer")
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--beam-size", type=int, default=None,
                        help=">1 decodes with beam search instead of greedy")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: latest)")
    parser.add_argument("--results-dir", type=str, default=None)
    parser.add_argument("--num-z-samples", type=int, default=None,
                        help="k>1: ALSO decode k prior z-draws per image "
                        "and report diversity/consistency metrics (the "
                        "information-maximization eval, train/infomax.py); "
                        "default cfg.num_z_samples")
    parser.add_argument("--consistency-map", type=str, default=None,
                        help="JSON {category id: [words...]}: the info-max "
                        "consistency predicate requires ALL the category's "
                        "words in the question (factored corpora emit "
                        "consistency_map.json); default: reserved-id "
                        "contract word 6+cat")
    parser.add_argument("--valid-map", type=str, default=None,
                        help="JSON {combo id: [valid questions...]} "
                        "(paraphrase corpora emit valid_questions.json): "
                        "adds infomax valid_rate/distinct_valid, each "
                        "z-draw scored as exactly-one-of the valid "
                        "paraphrases of its image's combo")
    parser.add_argument("--decode-sampling", action="store_true",
                        help="decode by temperature/top-k/top-p sampling "
                        "instead of greedy (ops/sampling.py); combines "
                        "with --num-z-samples for token-level diversity")
    parser.add_argument("--decode-temperature", type=float, default=None)
    parser.add_argument("--decode-top-k", type=int, default=None)
    parser.add_argument("--decode-top-p", type=float, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the CUDA card; there "
                        "is no fallback to the CPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    log = logging.getLogger("evaluate_iq")

    from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
    from blt_vqg_tpu_torch.core.config import Config
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.serve import check_device
    from blt_vqg_tpu_torch.text.vocabulary import load_vocab
    from blt_vqg_tpu_torch.train.infomax import multi_z_decode
    from blt_vqg_tpu_torch.train.step import make_beam_decode_step
    from blt_vqg_tpu_torch.train.trainer import Trainer, filter_special_tokens

    device = check_device(args.device)
    cfg = Config.load(os.path.join(args.model_dir, "args.json"))
    if args.decode_sampling:
        # sampling overrides before the Trainer builds its decode steps
        over = {"decode_sampling": True}
        for name in ("decode_temperature", "decode_top_k", "decode_top_p"):
            v = getattr(args, name)
            if v is not None:
                over[name] = v
        cfg = cfg.replace(**over)
    vocab = load_vocab(cfg.vocab)
    dataset = args.dataset or cfg.val_dataset
    cat2name = cfg.cat2name if os.path.exists(cfg.cat2name) else None
    ds = open_eval_dataset(dataset, vocab, cat2name)

    trainer = Trainer(cfg, vocab, device=device)
    ckpt = CheckpointManager(os.path.join(args.model_dir, "checkpoints"),
                             backend=cfg.checkpoint_backend)
    # the optimizer state is dead weight for evaluation: made and restored
    # on the host, so only the parameters and statistics reach the card
    state = trainer.init_state({}, resume=False, opt_device="cpu")
    state = ckpt.restore(state, step=args.step)
    latent = int(state.step) >= cfg.num_pretraining_steps
    log.info("evaluating checkpoint step %d (latent=%s)", int(state.step),
             latent)

    loader = make_loader(ds, cfg.batch_size, cfg.input_mode, shuffle=False,
                         epochs=1, device=device)
    k_z = (args.num_z_samples if args.num_z_samples is not None
           else cfg.num_z_samples)
    z_samples: list = []        # z_samples[j] = draw j's questions (strings)
    z_contexts: list = []       # category word id per evaluated image
    preds, gts = [], []
    beam_step = None  # built once on first use, reused across batches
    idx2word = vocab.idx2word
    try:
        for bi, batch in enumerate(loader):
            if args.max_batches and bi >= args.max_batches:
                break
            images = trainer.augment_eval(batch["images"])
            if args.from_category:
                context = batch["answer_types"][:, None].to(torch.int32)
            else:
                context = batch["context"]
            beam = args.beam_size or cfg.beam_size
            if beam > 1:
                if beam_step is None:
                    beam_step = make_beam_decode_step(
                        cfg.replace(beam_size=beam), trainer.model, latent)
                out = beam_step(images, context, trainer._key(bi))
            else:
                sample = (trainer.rngs.step_keys(
                    bi, "sample", device=device)["sample"]
                    if cfg.decode_sampling else None)
                out = trainer._decode_steps[latent](
                    images, context, trainer._key(bi), sample)
            target = batch["target"].cpu().numpy()
            for i, row in enumerate(out["tokens"].cpu().numpy()):
                preds.append(trainer._detok(row))
                gts.append(" ".join(filter_special_tokens(
                    [idx2word.get(int(w), "<unk>") for w in target[i]])))
            if k_z > 1 and latent:
                # info-max eval: k independent prior draws per image
                draws = multi_z_decode(trainer._decode_steps[True], images,
                                       context, INFOMAX_SEED + bi, k_z)
                if not z_samples:
                    z_samples = [[] for _ in range(k_z)]
                for j, toks in enumerate(draws):
                    z_samples[j].extend(trainer._detok(r) for r in toks)
                z_contexts.extend(
                    int(c) for c in batch["answer_types"].cpu().numpy())
            log.info("decoded %d questions", len(preds))
    finally:
        loader.close()

    scores = trainer.nlge.compute_metrics(ref_list=[gts], hyp_list=preds)
    for k, v in scores.items():
        log.info("%s\t%.4f", k, v * 100)

    if z_samples:
        from blt_vqg_tpu_torch.train.infomax import (
            category_word_consistency, diversity_metrics,
            mapped_word_consistency, template_validity)
        # z_contexts holds batch["answer_types"] = the VOCAB WORD ID of the
        # category word (data/packed.py type_word), not the raw category
        if args.consistency_map:
            with open(args.consistency_map) as f:
                consistent_fn = mapped_word_consistency(json.load(f),
                                                        vocab.idx2word)
        else:
            # reserved-id contract: type_word = raw category + 6
            # (text/vocabulary.py), translated back for the predicate
            base = category_word_consistency(vocab)

            def consistent_fn(q, c):
                return base(q, int(c) - 6)
        valid_kw = {}
        if args.valid_map:
            with open(args.valid_map) as f:
                valid_kw = dict(valid_fn=template_validity(json.load(f)),
                                refs=gts)  # gts aligns with z_samples rows
        div = diversity_metrics(
            z_samples, contexts=z_contexts, consistent_fn=consistent_fn,
            **valid_kw)
        for k, v in div.items():
            log.info("infomax %s\t%.4f", k, v)
        scores = {**scores, **{f"infomax_{k}": v for k, v in div.items()}}

    results_dir = args.results_dir or args.model_dir
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "results.json"), "w") as f:
        json.dump(scores, f, indent=2)
    with open(os.path.join(results_dir, "preds.json"), "w") as f:
        json.dump(preds, f)
    with open(os.path.join(results_dir, "gts.json"), "w") as f:
        json.dump(gts, f)
    if z_samples:
        with open(os.path.join(results_dir, "z_samples.json"), "w") as f:
            json.dump({"contexts": z_contexts, "samples": z_samples}, f)
    log.info("wrote results/preds/gts to %s", results_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
