"""Checkpoint test entry point (counterpart of ``blt_vqg_tpu/cli/test_iq.py``):
load a checkpoint, run the held-out split, score the questions.  The same
machinery and flags as cli/evaluate_iq.py.

    python -m blt_vqg_tpu_torch.cli.test_iq --model-dir runs/default \
        --dataset data/processed/iq_test_dataset.hdf5 [--device cpu]
"""

from __future__ import annotations

import sys

from blt_vqg_tpu_torch.cli.evaluate_iq import main as evaluate_main


def main(argv=None):
    # test == standalone eval on the held-out split; identical machinery
    return evaluate_main(argv)


if __name__ == "__main__":
    sys.exit(main())
