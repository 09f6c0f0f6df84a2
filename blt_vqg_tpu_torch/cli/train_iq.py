"""Training entry point of the PyTorch port (counterpart of
``blt_vqg_tpu/cli/train_iq.py``, the same flags and order of work).

    python -m blt_vqg_tpu_torch.cli.train_iq --dataset ... --val_dataset ... \
        --hidden_dim 1024 --num_layers 6 ...

Builds or loads the vocab, opens the datasets (a directory is a packed
dataset, read without h5py; a file is the hdf5 schema), prefetches batches
onto the device, GloVe-initialises the embedding when ``--emb_file``
exists, trains with the two-phase schedule, validates every
``val_check_interval`` steps, checkpoints every ``checkpoint_every`` steps,
and runs a final validation.  Runs on the CUDA card unless ``--device cpu``
asks for the CPU.

Over several processes, one per card, launch it with
``torch.distributed.run``::

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m blt_vqg_tpu_torch.cli.train_iq ... --num_data_shards 2 \
        --num_model_shards 2 [--fsdp | --shard_opt_state]

It joins the job first (``core/distributed.py``: NCCL on the cards, gloo
with ``--device cpu``), then lays the world out over the mesh of the
``--num_*_shards`` flags; each rank loads its rows of the global
``--batch_size``.  Rank 0 writes ``args.json``, the logs, metrics and
checkpoints.  Beyond the JAX flags: ``--device``, and
``--attention_dropout``, which the JAX CLI leaves at its ``Config``
default (the flash-attention kernels run in training only without
attention dropout).  ``main`` returns the run's trainer, final state and
final validation scores.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    from blt_vqg_tpu_torch.core.config import (Config, add_config_args,
                                               config_from_args)
    add_config_args(parser)
    parser.add_argument("--attention_dropout", type=float,
                        default=Config().attention_dropout)
    parser.add_argument("--max_examples", type=int, default=None,
                        help="debug: cap the dataset size")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in output_dir")
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--questions_json", type=str,
                        default="data/vqa/v2_OpenEnded_mscoco_train2014_questions.json")
    parser.add_argument("--cat2ans_json", type=str,
                        default="data/vqa/iq_dataset.json")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the CUDA card; there "
                        "is no fallback to the CPU)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("train_iq")

    from blt_vqg_tpu_torch.core.distributed import (initialize_distributed,
                                                    is_main_process)
    initialize_distributed(device=args.device)

    from blt_vqg_tpu_torch.text.vocabulary import load_vocab
    from blt_vqg_tpu_torch.text.build import build_vocab
    from blt_vqg_tpu_torch.text.glove import load_glove_embeddings
    from blt_vqg_tpu_torch.data.dataset import IQDataset
    from blt_vqg_tpu_torch.data.packed import PackedDataset
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.parallel.mesh import build_mesh
    from blt_vqg_tpu_torch.serve import check_device
    from blt_vqg_tpu_torch.train.trainer import Trainer

    device = check_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if os.path.exists(cfg.vocab):
        vocab = load_vocab(cfg.vocab)
        log.info("loaded vocab (%d words) from %s", len(vocab), cfg.vocab)
    else:
        log.info("building vocab from %s", args.questions_json)
        vocab = build_vocab(args.questions_json, args.cat2ans_json,
                            threshold=4, save_path=cfg.vocab)

    mesh = build_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device=device)
    cat2name = cfg.cat2name if os.path.exists(cfg.cat2name) else None

    def open_dataset(path):
        # a directory is a packed (mmap + native gather) dataset; a file is
        # the hdf5 schema
        cls = PackedDataset if os.path.isdir(path) else IQDataset
        return cls(path, vocab, cat2name, max_examples=args.max_examples)

    train_ds = open_dataset(cfg.dataset)
    val_ds = open_dataset(cfg.val_dataset)
    train_iter = make_loader(train_ds, cfg.batch_size, cfg.input_mode,
                             shuffle=True, seed=cfg.seed, mesh=mesh,
                             prefetch_depth=cfg.prefetch_depth, device=device)

    def val_iter_factory():
        return make_loader(val_ds, cfg.batch_size, cfg.input_mode,
                           shuffle=False, epochs=1, mesh=mesh,
                           drop_remainder=True, device=device)

    glove = None
    if cfg.emb_file and os.path.exists(cfg.emb_file):
        glove = load_glove_embeddings(vocab, cfg.emb_dim, cfg.emb_file)

    os.makedirs(cfg.output_dir, exist_ok=True)
    if is_main_process():
        cfg.save(os.path.join(cfg.output_dir, "args.json"))

    trainer = Trainer(cfg, vocab, mesh=mesh, profile_dir=args.profile_dir,
                      device=device)
    try:
        first = next(train_iter)
        state = trainer.init_state(
            {k: first[k] for k in ("images", "context", "posterior",
                                   "target")},
            glove_table=glove, resume=args.resume)

        state = trainer.fit(state, train_iter, val_iter_factory)

        # final validation pass
        latent = state.step >= cfg.num_pretraining_steps
        final = trainer.validate(state, val_iter_factory(), latent,
                                 state.step)
    finally:
        train_iter.close()
    return {"trainer": trainer, "state": state, "val": final}


if __name__ == "__main__":
    main()
    sys.exit(0)
