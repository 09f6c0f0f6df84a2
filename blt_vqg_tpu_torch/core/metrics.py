"""Structured metric logging: JSONL + TensorBoard-compatible scalars.

Capability-parity with the reference's observability (PL ``self.log`` →
TensorBoard event files, reference train_iq.py:122-128, 149-155): the same
scalar names land in a JSONL stream (always) and TensorBoard event files
(when tensorboardX/tensorboard writer is importable).  Pure host-side;
metrics arrive as jax arrays and are converted off the step path.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    # reference scalar names (train_iq.py:122-128, 149-155)
    TRAIN_NAMES = {"loss": "train loss", "rec": "train rec loss",
                   "img": "image recon loss", "ppl": "perplexity",
                   "kld": "kld loss", "aux": "aux loss", "elbo": "elbo"}
    VAL_NAMES = {"loss": "val_loss", "rec": "val_loss_rec",
                 "img": "val_img_loss", "ppl": "val_ppl",
                 "kld": "val_kld_loss", "aux": "val_aux", "elbo": "val_elbo"}

    def __init__(self, output_dir: str, run_name: str = "run"):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        except Exception:
            pass
        # the TB event writer spawns a NON-daemon thread; without this the
        # process never exits after main() returns
        import atexit
        atexit.register(self.close)

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train") -> None:
        names = self.TRAIN_NAMES if prefix == "train" else self.VAL_NAMES
        scalars = {}
        for k, v in metrics.items():
            name = names.get(k, f"{prefix}_{k}")
            scalars[name] = float(v)
        record = {"step": int(step), "time": time.time(),
                  "prefix": prefix, **scalars}
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for name, v in scalars.items():
                self._tb.add_scalar(name, v, int(step))

    def close(self):
        if not self._jsonl.closed:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
