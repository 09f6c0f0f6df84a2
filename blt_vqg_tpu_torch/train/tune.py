"""Hyperparameter search with ASHA successive halving.

Replaces the reference's Ray Tune setup (reference train_iq_ray.py:309-384:
ASHAScheduler(max_t=total_steps, grace_period=pretrain_steps), 4 samples,
metric=val_loss/min, search over dims/layers/heads/lr/batch) with a
dependency-free scheduler.  Two execution modes:

- ``run_tune``: trials run sequentially in-process on this host's
  accelerator (protocol oracle; no process isolation);
- ``run_tune_parallel``: up to ``max_concurrent`` trials run CONCURRENTLY
  as child processes (the reference's 4 parallel Ray actors,
  train_iq_ray.py:365-382), one rung segment per child invocation, with
  per-slot env overrides so each child can target its own TPU slice
  (or be pinned to CPU on a single-chip box).  Results flow back through
  ``<trial_dir>/result_<rung>.json`` files — the file-based analogue of
  Ray's TuneReportCheckpointCallback.

ASHA here: rungs at grace·eta^k steps; when a trial reaches a rung, it
continues only if its metric is within the top 1/eta of completed metrics at
that rung.  Trials checkpoint through the normal CheckpointManager, so a
promoted trial resumes rather than restarts.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import random
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


# --------------------------------------------------------------- search space
@dataclasses.dataclass
class Choice:
    name: str
    values: Sequence


@dataclasses.dataclass
class LogUniform:
    name: str
    low: float
    high: float


def default_search_space():
    """The reference's space (train_iq_ray.py:343-354)."""
    return [
        Choice("hidden_dim", [256, 512, 1024]),
        Choice("latent_dim", [256, 512, 1024]),
        Choice("pwffn_dim", [512, 1024, 2048]),
        Choice("num_layers", [4, 6]),
        Choice("num_heads", [4, 8]),
        LogUniform("lr", 1e-5, 1e-3),
        Choice("batch_size", [32, 64, 128]),
    ]


def tiny_search_space():
    """Smoke-test space: same dimensions, toy sizes."""
    return [
        Choice("hidden_dim", [16, 32]),
        Choice("latent_dim", [8, 16]),
        Choice("pwffn_dim", [16, 32]),
        Choice("num_layers", [1]),
        Choice("num_heads", [2]),
        LogUniform("lr", 1e-4, 1e-3),
        Choice("batch_size", [8]),
    ]


def sample_config(base_cfg, space, rng: random.Random):
    overrides = {}
    for dim in space:
        if isinstance(dim, Choice):
            overrides[dim.name] = rng.choice(list(dim.values))
        else:
            lo, hi = math.log(dim.low), math.log(dim.high)
            overrides[dim.name] = math.exp(rng.uniform(lo, hi))
    return base_cfg.replace(**overrides), overrides


# --------------------------------------------------------------------- ASHA
class ASHAScheduler:
    """Asynchronous successive halving over (trial, rung) reports."""

    def __init__(self, grace_period: int, max_t: int, eta: int = 3,
                 mode: str = "min"):
        self.eta = eta
        self.mode = mode
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(int(t))
            t *= eta
        self.rungs.append(int(max_t))
        self._results: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def next_rung(self, step: int) -> Optional[int]:
        for r in self.rungs:
            if step < r:
                return r
        return None

    def report(self, rung: int, value: float) -> bool:
        """Records value at rung; returns True if the trial should continue."""
        sign = 1.0 if self.mode == "min" else -1.0
        self._results[rung].append(sign * value)
        scores = sorted(self._results[rung])
        k = max(1, len(scores) // self.eta)
        return sign * value <= scores[k - 1]


# -------------------------------------------------------------------- runner
def run_tune(base_cfg, train_trial_fn: Callable, num_samples: int = 4,
             space=None, seed: int = 0, output_dir: str = "runs/tune",
             eta: int = 3) -> Dict:
    """Sequential ASHA driver.

    ``train_trial_fn(cfg, trial_dir, stop_at_step) -> val_loss`` trains (or
    resumes) one trial up to ``stop_at_step`` and returns its current metric
    — the caller wires this to Trainer.fit + validate.
    """
    space = space or default_search_space()
    rng = random.Random(seed)
    os.makedirs(output_dir, exist_ok=True)
    sched = ASHAScheduler(grace_period=base_cfg.num_pretraining_steps,
                          max_t=base_cfg.total_training_steps, eta=eta)

    trials = []
    for t in range(num_samples):
        cfg, overrides = sample_config(base_cfg, space, rng)
        trial_dir = os.path.join(output_dir, f"trial_{t}")
        cfg = cfg.replace(output_dir=trial_dir)
        trials.append({"id": t, "cfg": cfg, "overrides": overrides,
                       "step": 0, "alive": True, "metric": None})
        with open(os.path.join(output_dir, f"trial_{t}.json"), "w") as f:
            json.dump(overrides, f, indent=2, default=str)

    # round-robin trials through rungs (async halving, sequential execution)
    progressing = True
    while progressing:
        progressing = False
        for tr in trials:
            if not tr["alive"]:
                continue
            rung = sched.next_rung(tr["step"])
            if rung is None:
                tr["alive"] = False
                continue
            log.info("trial %d: training to rung %d (%s)", tr["id"], rung,
                     tr["overrides"])
            metric = train_trial_fn(tr["cfg"],
                                    os.path.join(output_dir,
                                                 f"trial_{tr['id']}"),
                                    stop_at_step=rung)
            tr["step"] = rung
            tr["metric"] = metric
            progressing = True
            if not sched.report(rung, metric):
                log.info("trial %d stopped at rung %d (metric %.4f)",
                         tr["id"], rung, metric)
                tr["alive"] = False

    return _write_analysis(trials, output_dir)


def _write_analysis(trials: List[Dict], output_dir: str) -> Dict:
    best = min((t for t in trials if t["metric"] is not None),
               key=lambda t: t["metric"])
    result = {"best_trial": best["id"], "best_metric": best["metric"],
              "best_config": best["overrides"],
              "trials": [{k: t[k] for k in ("id", "overrides", "step",
                                            "metric")} for t in trials]}
    with open(os.path.join(output_dir, "analysis.json"), "w") as f:
        json.dump(result, f, indent=2, default=str)
    log.info("best config: %s", best["overrides"])
    return result


# ------------------------------------------------- concurrent launcher
def result_path(trial_dir: str, rung: int) -> str:
    """Where a trial child must write its rung report:
    JSON ``{"metric": <float>, "step": <int>}``."""
    return os.path.join(trial_dir, f"result_{rung}.json")


def run_tune_parallel(base_cfg, trial_argv_fn: Callable,
                      num_samples: int = 4, max_concurrent: int = 4,
                      space=None, seed: int = 0,
                      output_dir: str = "runs/tune", eta: int = 3,
                      slot_envs: Optional[Sequence[Dict[str, str]]] = None,
                      poll_interval: float = 0.2) -> Dict:
    """Concurrent ASHA: up to ``max_concurrent`` trials as child processes.

    ``trial_argv_fn(cfg, trial_dir, stop_at_step) -> List[str]`` builds the
    child command line; the child trains (or resumes from its checkpoint) to
    ``stop_at_step``, writes ``result_path(trial_dir, stop_at_step)``, and
    exits 0.  A nonzero exit or a missing result file kills the trial (the
    same fate Ray gives a crashed actor).

    ``slot_envs`` optionally provides one env-override dict per concurrent
    slot (e.g. a different TPU slice or JAX_PLATFORMS=cpu per child); slot i
    of the running pool gets ``slot_envs[i % len(slot_envs)]``.

    Configs are sampled from the identical RNG stream as ``run_tune``, so a
    sequential run with the same seed is the promotion oracle.
    """
    space = space or default_search_space()
    rng = random.Random(seed)
    os.makedirs(output_dir, exist_ok=True)
    sched = ASHAScheduler(grace_period=base_cfg.num_pretraining_steps,
                          max_t=base_cfg.total_training_steps, eta=eta)

    trials = []
    for t in range(num_samples):
        cfg, overrides = sample_config(base_cfg, space, rng)
        trial_dir = os.path.join(output_dir, f"trial_{t}")
        os.makedirs(trial_dir, exist_ok=True)
        cfg = cfg.replace(output_dir=trial_dir)
        trials.append({"id": t, "cfg": cfg, "overrides": overrides,
                       "dir": trial_dir, "step": 0, "alive": True,
                       "metric": None})
        with open(os.path.join(output_dir, f"trial_{t}.json"), "w") as f:
            json.dump(overrides, f, indent=2, default=str)

    pending = list(trials)      # trials waiting for their next rung launch
    running: List[Dict] = []    # {"trial":…, "rung":…, "proc":…, "slot":…}
    free_slots = list(range(max_concurrent))

    def launch(tr, slot):
        rung = sched.next_rung(tr["step"])
        env = dict(os.environ)
        if slot_envs:
            env.update(slot_envs[slot % len(slot_envs)])
        argv = trial_argv_fn(tr["cfg"], tr["dir"], rung)
        log.info("trial %d → rung %d (slot %d): %s", tr["id"], rung, slot,
                 tr["overrides"])
        proc = subprocess.Popen(argv, env=env)
        running.append({"trial": tr, "rung": rung, "proc": proc,
                        "slot": slot})

    while pending or running:
        while pending and free_slots:
            tr = pending.pop(0)
            if sched.next_rung(tr["step"]) is None:
                tr["alive"] = False
                continue
            launch(tr, free_slots.pop(0))
        finished = [r for r in running if r["proc"].poll() is not None]
        if not finished:
            time.sleep(poll_interval)
            continue
        for r in finished:
            running.remove(r)
            free_slots.append(r["slot"])
            tr, rung = r["trial"], r["rung"]
            rpath = result_path(tr["dir"], rung)
            if r["proc"].returncode != 0 or not os.path.exists(rpath):
                log.warning("trial %d failed at rung %d (rc %s) — killed",
                            tr["id"], rung, r["proc"].returncode)
                tr["alive"] = False
                continue
            with open(rpath) as f:
                report = json.load(f)
            tr["step"] = rung
            tr["metric"] = float(report["metric"])
            if sched.report(rung, tr["metric"]):
                if sched.next_rung(tr["step"]) is not None:
                    pending.append(tr)
                else:
                    tr["alive"] = False  # reached max_t
            else:
                log.info("trial %d stopped at rung %d (metric %.4f)",
                         tr["id"], rung, tr["metric"])
                tr["alive"] = False

    return _write_analysis(trials, output_dir)
