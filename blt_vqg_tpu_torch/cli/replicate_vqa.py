"""Real-VQA replication entry point (counterpart of
``blt_vqg_tpu/cli/replicate_vqa.py``, the same flags, checks and plan).

The first command to run once VQA v2, COCO and GloVe data are on disk: it
checks every input path, then drives the reference replication end to end
through the port's CLIs:

    ETL (cli.store_dataset, train+val)  ->  pack (cli.pack_dataset)
    ->  35k-step reference-config training (cli.train_iq; the reference
        train_iq.py defaults, or --big for the run.sh config)
    ->  eval dumps (cli.evaluate_iq: results/preds/gts.json)

Inputs follow the reference's data layout:

    <data_root>/
      train2014/ val2014/                      COCO images
      v2_OpenEnded_mscoco_train2014_questions.json
      v2_mscoco_train2014_annotations.json     (+ val2014 pair)
      iq_dataset.json                          category->answers map
    --glove vectors/glove.6B.300d.txt          (optional; random init else)
    --resnet-ckpt resnet18.pth                 (optional; torchvision
                                               state_dict -> frozen
                                               pretrained backbone)

Nothing is downloaded: ``--check`` only reports what is missing.  The
training and evaluation commands run on the CUDA card.

Usage:
    python -m blt_vqg_tpu_torch.cli.replicate_vqa --data-root /data/vqa --check
    python -m blt_vqg_tpu_torch.cli.replicate_vqa --data-root /data/vqa \
        --work-dir /data/vqa_processed --out runs/vqa_replication --big --run
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True,
                   help="directory with COCO images + VQA v2 json")
    p.add_argument("--work-dir", default=None,
                   help="ETL outputs (default <data-root>/processed)")
    p.add_argument("--out", default="runs/vqa_replication")
    p.add_argument("--glove", default=None,
                   help="GloVe 300d text file (optional)")
    p.add_argument("--resnet-ckpt", default=None,
                   help="torchvision resnet18 state_dict .pth/.npz "
                   "(optional but needed for reference-faithful backbone)")
    p.add_argument("--big", action="store_true",
                   help="run.sh 'big' config (hidden/latent 1024, 6L/8H, "
                   "batch 64, input_mode cat) instead of the train_iq.py "
                   "default config")
    p.add_argument("--steps", type=int, default=35_000,
                   help="total training steps (reference train_iq.py:331)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override batch size (reference default 128; "
                   "run.sh big uses 64)")
    p.add_argument("--im-size", type=int, default=224)
    p.add_argument("--pack", action="store_true",
                   help="also pack the hdf5 to the mmap runtime format and "
                   "train from it (faster ingest)")
    p.add_argument("--check", action="store_true",
                   help="pre-flight only: validate every input path")
    p.add_argument("--run", action="store_true",
                   help="run ETL + training + eval (implies --check first)")
    return p


# --------------------------------------------------------------- pre-flight
def preflight(args) -> List[str]:
    """Validates every input; returns a list of problems (empty = GO)."""
    problems: List[str] = []
    root = args.data_root

    def need(path, what, check=os.path.isfile):
        if not check(path):
            problems.append(f"missing {what}: {path}")
            return False
        return True

    for split in ("train2014", "val2014"):
        d = os.path.join(root, split)
        if need(d, f"COCO {split} image dir", os.path.isdir):
            jpgs = glob.glob(os.path.join(d, "*.jpg"))
            if not jpgs:
                problems.append(f"no .jpg files in {d}")
            elif not any(os.path.basename(f).startswith("COCO_")
                         for f in jpgs[:50]):
                problems.append(f"{d} files lack COCO_* naming "
                                "(store_dataset resolves both COCO formats)")
        qj = os.path.join(root, f"v2_OpenEnded_mscoco_{split}_questions.json")
        aj = os.path.join(root, f"v2_mscoco_{split}_annotations.json")
        if need(qj, f"{split} questions json"):
            with open(qj) as f:
                if "questions" not in json.load(f):
                    problems.append(f"{qj}: no 'questions' key")
        if need(aj, f"{split} annotations json"):
            with open(aj) as f:
                if "annotations" not in json.load(f):
                    problems.append(f"{aj}: no 'annotations' key")

    cat2ans = os.path.join(root, "iq_dataset.json")
    if need(cat2ans, "cat2ans map (iq_dataset.json)"):
        with open(cat2ans) as f:
            m = json.load(f)
        if not (isinstance(m, dict) and m
                and all(isinstance(v, list) for v in m.values())):
            problems.append(f"{cat2ans}: expected dict[str, list[str]]")

    if args.glove:
        if need(args.glove, "GloVe vectors file"):
            with open(args.glove) as f:
                first = f.readline().split()
            if len(first) != 301:
                problems.append(
                    f"{args.glove}: expected 'word + 300 floats' rows, "
                    f"got {len(first)} fields")
    if args.resnet_ckpt and need(args.resnet_ckpt,
                                 "torchvision resnet18 checkpoint"):
        try:
            from blt_vqg_tpu_torch.ops.resnet import load_resnet18_checkpoint
            sd = load_resnet18_checkpoint(args.resnet_ckpt)
            modules = {k.split(".")[0] for k in sd}
            assert "stem_conv" in modules and "stage3_block1" in modules
        except Exception as e:  # noqa: BLE001 — report, don't crash
            problems.append(f"resnet ckpt failed to import: {e!r}")
    return problems


# --------------------------------------------------------------- commands
def build_commands(args) -> List[List[str]]:
    """The exact CLI invocations the replication runs, in order — separated
    from execution so tests validate the plumbing without data."""
    root = args.data_root
    work = args.work_dir or os.path.join(root, "processed")
    vocab = os.path.join(work, "vocab_iq.json")
    cat2name = os.path.join(work, "cat2name.json")
    train_h5 = os.path.join(work, "iq_dataset.hdf5")
    val_h5 = os.path.join(work, "iq_val_dataset.hdf5")
    cmds: List[List[str]] = []
    for split, out, extra in (("train2014", train_h5, []),
                              ("val2014", val_h5, ["--val"])):
        cmds.append(
            ["-m", "blt_vqg_tpu_torch.cli.store_dataset",
             "--image-dir", os.path.join(root, split),
             "--questions",
             os.path.join(root, f"v2_OpenEnded_mscoco_{split}_questions.json"),
             "--annotations",
             os.path.join(root, f"v2_mscoco_{split}_annotations.json"),
             "--cat2ans", os.path.join(root, "iq_dataset.json"),
             "--vocab-path", vocab, "--output", out,
             "--cat2name", cat2name, "--im_size", str(args.im_size),
             "--uint8"] + extra)
    train_ds, val_ds = train_h5, val_h5
    if args.pack:
        train_ds = os.path.join(work, "packed_train")
        val_ds = os.path.join(work, "packed_val")
        cmds.append(["-m", "blt_vqg_tpu_torch.cli.pack_dataset",
                     "--input", train_h5, "--output", train_ds])
        cmds.append(["-m", "blt_vqg_tpu_torch.cli.pack_dataset",
                     "--input", val_h5, "--output", val_ds])

    train_cmd = ["-m", "blt_vqg_tpu_torch.cli.train_iq",
                 "--dataset", train_ds, "--val_dataset", val_ds,
                 "--vocab", vocab, "--cat2name", cat2name,
                 "--total_training_steps", str(args.steps),
                 "--output_dir", args.out]
    if args.big:
        # run.sh flag-for-flag (reference run.sh:1-10)
        train_cmd += ["--emb_dim", "300", "--hidden_dim", "1024",
                      "--latent_dim", "1024", "--pwffn_dim", "2048",
                      "--num_layers", "6", "--num_heads", "8",
                      "--batch_size", "64",
                      "--num_pretraining_steps", "6000",
                      "--input_mode", "cat"]
    if args.batch_size:
        train_cmd += ["--batch_size", str(args.batch_size)]
    if args.glove:
        train_cmd += ["--emb_file", args.glove]
    if args.resnet_ckpt:
        train_cmd += ["--resnet_ckpt", args.resnet_ckpt]
    cmds.append(train_cmd)

    eval_cmd = ["-m", "blt_vqg_tpu_torch.cli.evaluate_iq",
                "--model-dir", args.out, "--num-z-samples", "5"]
    if args.big:
        eval_cmd.append("--from-category")
    cmds.append(eval_cmd)
    return cmds


def main(argv=None):
    args = build_parser().parse_args(argv)
    problems = preflight(args)
    if problems:
        print("PRE-FLIGHT FAILED:")
        for p in problems:
            print("  -", p)
        return 1
    print("pre-flight OK: all inputs present and well-formed")
    cmds = build_commands(args)
    print("replication plan:")
    for c in cmds:
        print("  python", " ".join(c))
    if not args.run:
        print("(--check only; pass --run to execute)")
        return 0
    import subprocess
    for c in cmds:
        print("\n=== running:", " ".join(c), flush=True)
        rc = subprocess.call([sys.executable] + c)
        if rc != 0:
            print(f"step failed (rc={rc}); fix and re-run — completed ETL "
                  "outputs are reused, training resumes with --resume")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
