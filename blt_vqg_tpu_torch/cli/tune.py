"""Hyperparameter search entry point (counterpart of
``blt_vqg_tpu/cli/tune.py``, the same flags and files).

    python -m blt_vqg_tpu_torch.cli.tune --dataset ... --num-samples 4
    python -m blt_vqg_tpu_torch.cli.tune --dataset ... --parallel 4 \
        --slot-env 0:CUDA_VISIBLE_DEVICES=0 --slot-env 1:CUDA_VISIBLE_DEVICES=1

Runs ASHA successive halving (train/tune.py) over the reference's search
space, or the tiny one with ``--tune-space tiny``.  ``--parallel N`` runs up
to N trials at once as child processes: this module re-invoked with
``--run-trial`` trains one rung segment, resuming from the trial's
checkpoint, and reports through a result file.  ``--trial-env KEY=VAL``
(repeatable) sets an environment variable in every child, and
``--slot-env SLOT:KEY=VAL`` in the children of one slot, for example a card
of their own by ``CUDA_VISIBLE_DEVICES``.  The metric is the validation
loss (min), with the pretraining steps as the grace period.

Every trial trains on the CUDA card unless ``--device cpu`` asks for the
CPU (children get the same ``--device``).  Beyond the JAX flags:
``--device`` and ``--attention_dropout``, as in cli/train_iq.py.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch


def open_dataset(path, vocab, cat2name=None, max_examples=None):
    """Directory = packed (mmap + native gather); file = reference-schema
    hdf5, the same sniffing as cli/train_iq.py."""
    from blt_vqg_tpu_torch.data.dataset import IQDataset
    from blt_vqg_tpu_torch.data.packed import PackedDataset
    cls = PackedDataset if os.path.isdir(path) else IQDataset
    return cls(path, vocab, cat2name, max_examples=max_examples)


def _say(line: str) -> None:
    """``line`` to standard output in one write: trials running side by
    side share that output, and ``print`` writes the line and its newline
    apart, so without a buffer (``PYTHONUNBUFFERED``) their lines mix."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _train_trial(cfg, stop_at_step: int, max_examples=None,
                 device="cuda") -> float:
    """Train (or resume) one trial to ``stop_at_step``; returns val loss."""
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.serve import check_device
    from blt_vqg_tpu_torch.text.vocabulary import load_vocab
    from blt_vqg_tpu_torch.train.trainer import Trainer

    device = check_device(device)
    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    _say(f"tune trial {cfg.output_dir}: device {device}{name}")
    vocab = load_vocab(cfg.vocab)
    cat2name = cfg.cat2name if os.path.exists(cfg.cat2name) else None
    train_ds = open_dataset(cfg.dataset, vocab, cat2name, max_examples)
    val_ds = open_dataset(cfg.val_dataset, vocab, cat2name, max_examples)
    trainer = Trainer(cfg, vocab, device=device)
    train_iter = make_loader(train_ds, cfg.batch_size, cfg.input_mode,
                             shuffle=True, seed=cfg.seed, device=device)
    try:
        first = next(train_iter)
        # promoted trials resume from their checkpoint
        state = trainer.init_state(
            {k: first[k] for k in ("images", "context", "posterior",
                                   "target")}, resume=True)

        # drop_remainder=False: a sampled batch size may exceed a small
        # eval split
        def val_loader():
            return make_loader(val_ds, cfg.batch_size, cfg.input_mode,
                               shuffle=False, epochs=1, drop_remainder=False,
                               device=device)

        state = trainer.fit(state, train_iter, val_loader,
                            max_steps=stop_at_step)
        latent = int(state.step) >= cfg.num_pretraining_steps
        val = trainer.validate(state, val_loader(), latent, int(state.step),
                               print_samples=0)
    finally:
        train_iter.close()
    return float(val["loss"])


def _run_trial_child(argv) -> int:
    """Child-process mode: one rung segment, result written to a file."""
    from blt_vqg_tpu_torch.core.config import Config
    from blt_vqg_tpu_torch.train.tune import result_path

    parser = argparse.ArgumentParser()
    parser.add_argument("--run-trial", action="store_true")
    parser.add_argument("--trial-config", type=str, required=True)
    parser.add_argument("--trial-dir", type=str, required=True)
    parser.add_argument("--stop-at-step", type=int, required=True)
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    t0 = time.perf_counter()
    with open(args.trial_config) as f:
        cfg = Config.from_json(f.read())
    metric = _train_trial(cfg, args.stop_at_step, args.max_examples,
                          args.device)
    with open(result_path(args.trial_dir, args.stop_at_step), "w") as f:
        json.dump({"metric": metric, "step": args.stop_at_step}, f)
    _say(f"tune trial {cfg.output_dir} to step {args.stop_at_step}: val "
         f"loss {metric:.6g} in {time.perf_counter() - t0:.1f} s")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--run-trial" in argv:
        return _run_trial_child(argv)

    parser = argparse.ArgumentParser()
    from blt_vqg_tpu_torch.core.config import (Config, add_config_args,
                                               config_from_args)
    add_config_args(parser)
    parser.add_argument("--attention_dropout", type=float,
                        default=Config().attention_dropout)
    parser.add_argument("--num-samples", type=int, default=4)
    parser.add_argument("--tune-dir", type=str, default="runs/tune")
    parser.add_argument("--tune-seed", type=int, default=0)
    parser.add_argument("--tune-space", type=str, default="reference",
                        choices=("reference", "tiny"),
                        help="'tiny' smoke-tests the HPO loop itself")
    parser.add_argument("--parallel", type=int, default=1,
                        help="max concurrent trial child processes "
                        "(1 = sequential in-process)")
    parser.add_argument("--trial-env", action="append", default=[],
                        metavar="KEY=VAL",
                        help="env override applied to every trial child")
    parser.add_argument("--slot-env", action="append", default=[],
                        metavar="SLOT:KEY=VAL",
                        help="env override for one concurrent slot (0-based),"
                        " layered over --trial-env: route each slot to its "
                        "own card, e.g. "
                        "--slot-env 0:CUDA_VISIBLE_DEVICES=0 "
                        "--slot-env 1:CUDA_VISIBLE_DEVICES=1")
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of every trial (default: the "
                        "CUDA card; there is no fallback to the CPU)")
    args = parser.parse_args(argv)
    base_cfg = config_from_args(args)
    logging.basicConfig(level=logging.INFO)

    from blt_vqg_tpu_torch.serve import check_device
    from blt_vqg_tpu_torch.train.tune import (default_search_space, run_tune,
                                              run_tune_parallel,
                                              tiny_search_space)

    check_device(args.device)
    space = (tiny_search_space() if args.tune_space == "tiny"
             else default_search_space())

    if args.parallel > 1:
        env = dict(kv.split("=", 1) for kv in args.trial_env)
        slot_envs = None
        if args.slot_env:
            per_slot = [dict(env) for _ in range(args.parallel)]
            for spec in args.slot_env:
                slot, kv = spec.split(":", 1)
                key, val = kv.split("=", 1)
                if not 0 <= int(slot) < args.parallel:
                    parser.error(f"--slot-env slot {slot} out of range "
                                 f"for --parallel {args.parallel}")
                per_slot[int(slot)][key] = val
            slot_envs = per_slot
        elif env:
            slot_envs = [env]

        def trial_argv_fn(cfg, trial_dir, stop_at_step):
            cfg_path = os.path.join(trial_dir, "trial_config.json")
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())
            child = [sys.executable, "-m", "blt_vqg_tpu_torch.cli.tune",
                     "--run-trial", "--trial-config", cfg_path,
                     "--trial-dir", trial_dir,
                     "--stop-at-step", str(stop_at_step),
                     "--device", args.device]
            if args.max_examples is not None:
                child += ["--max_examples", str(args.max_examples)]
            return child

        run_tune_parallel(base_cfg, trial_argv_fn,
                          num_samples=args.num_samples,
                          max_concurrent=args.parallel, space=space,
                          seed=args.tune_seed, output_dir=args.tune_dir,
                          slot_envs=slot_envs)
        return 0

    def train_trial_fn(cfg, trial_dir, stop_at_step):
        return _train_trial(cfg, stop_at_step, args.max_examples,
                            args.device)

    run_tune(base_cfg, train_trial_fn, num_samples=args.num_samples,
             space=space, seed=args.tune_seed, output_dir=args.tune_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
