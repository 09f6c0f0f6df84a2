"""Training harness (counterpart of ``blt_vqg_tpu/train/trainer.py``).

- the two-phase schedule, with the Adam restart at the phase boundary;
- the train step per phase, or ``cfg.steps_per_dispatch`` steps per call
  (``make_multi_step``; a call never crosses a phase, validation,
  checkpoint or log boundary);
- validation every ``val_check_interval`` steps over at most
  ``limit_val_batches`` batches, with the greedy (or beam) decode report:
  printed samples with each word's top-6 probabilities, the NLG scores,
  and with ``cfg.latent_diagnostics`` the latent's statistics and the
  decode-BLEU of three z sources;
- npz checkpoints every ``checkpoint_every`` steps (async) and at the end;
  resume from the latest; SIGTERM/SIGINT finish the step, save and stop;
- metrics in the JAX package's scalar names (``core/metrics.py``);
- ``profile_dir``: a ``torch.profiler`` Chrome trace of the fit loop.

Every random draw takes a generator from one ``RngStream`` by (step,
purpose), as the JAX package takes its keys, so a resumed run draws what
an uninterrupted one would at the same steps.  ``model_family="rnn"``
trains ``models/iq_rnn.py``'s IQRNN, whose validation report decodes
greedy (the family has no beam search).

On a mesh across processes (``data``, ``model``, ``expert`` and
``dcn_data`` axes; ``parallel/mesh.py``) every rank runs this loop on its
rows: the state is placed by the sharding rules after it is built,
grafted and restored (``parallel/sharding.py`` ``place_state``; the Adam
restart places its fresh moments again), the steps are sharded
(``train/step.py``), and every decision (validation loss, early stop,
SIGTERM) is taken on values that are equal on every rank.  Logs, metric
files and checkpoints are written by rank 0 (checkpoints gathered whole
first).  The validation report gathers its batch's rows and the whole
weights to rank 0, which decodes and scores as a single process would
(the per-layer decode kernels take whole weights).  A ``seq`` axis across
processes rings attention over the ranks' shards, and a ``pipe`` axis
(``pipeline_stages`` > 1) runs the decoder as a GPipe pipeline; the model
gets the mesh for either, as in the JAX package.
"""

from __future__ import annotations

import collections
import logging
import os
import signal
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.core.metrics import MetricWriter
from blt_vqg_tpu_torch.core.rng import RngStream
from blt_vqg_tpu_torch.data.augment import make_augment_fn
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.parallel import collectives as col
from blt_vqg_tpu_torch.parallel.mesh import BATCH_AXES, PIPE, SEQ
from blt_vqg_tpu_torch.parallel.sharding import place_state
from blt_vqg_tpu_torch.serve import check_device
from blt_vqg_tpu_torch.train.nlg_metrics import NLGEval
from blt_vqg_tpu_torch.train.state import TrainState, create_train_state
from blt_vqg_tpu_torch.train.step import (
    make_beam_decode_step, make_decode_step, make_diag_decode_step,
    make_eval_step, make_latent_diag_step, make_multi_step, make_train_step)

log = logging.getLogger(__name__)

SPECIAL_TOKENS = ("<start>", "<end>", "<pad>")
Z_REPORT_SOURCES = ("prior_sample", "prior_mean", "posterior_mean")
# RngStream steps of each purpose (the JAX package's key offsets)
_AUG_TRAIN, _EVAL, _DECODE, _DIAG = 1_000_000, 2_000_000, 4_000_000, 5_000_000


def filter_special_tokens(tokens):
    return [t for t in tokens if t not in SPECIAL_TOKENS]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EarlyStopping:
    """Val-loss early stopping gated to the post-pretraining phase: patience
    counted over validations, checked only once ``step > active_from``."""

    def __init__(self, patience: int, min_delta: float = 0.0,
                 active_from: int = 0, mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.active_from = active_from
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = float("inf")
        self.stale = 0

    def update(self, step: int, value: float) -> bool:
        """Records one validation result; returns True when training should
        stop.  Validations before the gate are ignored."""
        if self.patience <= 0 or step <= self.active_from:
            return False
        v = self.sign * float(value)
        if v < self.best - self.min_delta:
            self.best = v
            self.stale = 0
            return False
        self.stale += 1
        return self.stale >= self.patience


class _NoWriter:
    """The metric writer of a rank other than 0."""

    def write(self, *args, **kwargs) -> None:
        pass


class _Clock:
    """Marks on the device's stream (CUDA events) or the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


class Trainer:
    """``device``: the card unless the caller asks for the CPU."""

    def __init__(self, cfg: Config, vocab, mesh=None,
                 profile_dir: Optional[str] = None, device="cuda"):
        spans = [a for a, n in (mesh.shape.items() if mesh is not None
                                else ()) if n > 1 and a != SEQ]
        if spans and not mesh.across_processes:
            raise ValueError(
                f"mesh axes {spans} over 1 span processes: build the mesh "
                f"with parallel.mesh.build_mesh over an initialised world")
        if cfg.pipeline_stages > 1 and (
                mesh is None
                or mesh.shape.get(PIPE, 1) != cfg.pipeline_stages):
            raise ValueError(
                f"pipeline_stages={cfg.pipeline_stages} needs a mesh with a "
                f"{PIPE!r} axis of that size, not "
                f"{None if mesh is None else dict(mesh.shape)}")
        self.wide = mesh is not None and mesh.across_processes
        self.cfg = cfg
        self.vocab = vocab
        self.mesh = mesh
        self.device = check_device(device)
        if cfg.debug_nans:
            from blt_vqg_tpu_torch.core.debug import enable_nan_checks
            enable_nan_checks(True)
        if cfg.model_family == "rnn":
            from blt_vqg_tpu_torch.models.iq_rnn import IQRNN
            self.model = IQRNN(cfg, len(vocab)).to(self.device)
        else:
            self.model = IQ(cfg, len(vocab),
                            mesh=(mesh if (cfg.sequence_parallel
                                           or cfg.pipeline_stages > 1)
                                  else None)).to(self.device)
        self.rngs = RngStream(cfg.seed)
        self.nlge = NLGEval(no_glove=True, no_skipthoughts=True)
        self.is_main = mesh is None or mesh.rank == 0
        self.writer = (MetricWriter(cfg.output_dir) if self.is_main
                       else _NoWriter())
        self.ckpt = CheckpointManager(
            os.path.join(cfg.output_dir, "checkpoints"),
            backend=cfg.checkpoint_backend)
        self.profile_dir = profile_dir
        self.augment_train = make_augment_fn(cfg.image_size, train=True)
        self.augment_eval = make_augment_fn(cfg.image_size, train=False)

        # the train steps are built at their first use (``_train_step``), so
        # a trainer that only evaluates builds none, as the JAX package
        # compiles none: ``make_train_step`` raises for options the port's
        # train step does not take yet
        self._train_steps: Dict = {}
        self._eval_steps = {m: make_eval_step(cfg, latent_mode=m, mesh=mesh)
                            for m in (False, True)}
        # the reports decode on rank 0 with whole weights: a model of its
        # own when the mesh splits the weights
        split = self.wide and (cfg.fsdp or any(
            mesh.shape.get(a, 1) > 1 for a in ("model", "expert")))
        self.report_model = self.model
        if split and self.is_main:
            self.report_model = type(self.model)(cfg, len(vocab)).to(
                self.device)
        self._split_weights = split
        self._decode_steps = {m: make_decode_step(cfg, self.report_model,
                                                  latent_mode=m)
                              for m in (False, True)}
        # cfg.beam_size > 1 switches the validation decode report to beam
        # search (the RNN family has no beam decoder: it stays greedy)
        self._beam_steps = ({m: make_beam_decode_step(cfg, self.report_model,
                                                      latent_mode=m)
                             for m in (False, True)}
                            if cfg.beam_size > 1
                            and hasattr(type(self.model), "decode_beam")
                            else None)
        self._diag_steps = None   # built at the first latent report
        # the fit loop's readings: CUDA events on the card, else host clock
        # (validate_ms, and save_ms, the host copy of an async save)
        self.timings: Dict[str, list] = {"dispatch_ms": [], "validate_ms": [],
                                         "save_ms": [], "fit_ms": [],
                                         "fit_steps": []}
        # (step, metrics) of the latest dispatches, device tensors: nothing
        # waits for them
        self.history = collections.deque(maxlen=64)
        self.hp_string = "{}_{}_{}_{}_{}_{}_{}_{}_{}_{}. {}".format(
            cfg.input_mode, cfg.emb_dim, "True", cfg.hidden_dim,
            cfg.latent_dim, cfg.pwffn_dim, cfg.num_layers, cfg.num_heads,
            cfg.lr, cfg.batch_size, cfg.print_note)

    # ------------------------------------------------------------------
    def _train_step(self, latent: bool, multi: bool = False):
        """The train step of a phase (``multi``: its G-step form,
        train/step.py ``make_multi_step``), built at first use."""
        if (latent, multi) not in self._train_steps:
            make = make_multi_step if multi else make_train_step
            self._train_steps[latent, multi] = make(self.cfg,
                                                    latent_mode=latent,
                                                    mesh=self.mesh)
        return self._train_steps[latent, multi]

    def _key(self, step: int) -> torch.Generator:
        return self.rngs.key(step, self.device)

    def init_state(self, sample_batch: Dict, glove_table=None,
                   resume: bool = True, opt_device=None) -> TrainState:
        """Seed-made weights (``cfg.seed``; ``sample_batch`` is taken for
        the JAX signature: the port's modules know their shapes), the
        GloVe table before the optimizer's snapshot, the pretrained
        backbone of ``cfg.resnet_ckpt``, then the latest checkpoint when
        ``resume``.  ``opt_device``: where the optimizer state lives, if
        not beside the model (train/state.py ``create_train_state``)."""
        del sample_batch
        state = create_train_state(self.cfg, self.model, seed=self.cfg.seed,
                                   glove_table=glove_table,
                                   opt_device=opt_device)
        rc = self.cfg.resnet_ckpt
        if rc and self.cfg.image_encoder == "resnet18":
            # before a resume (checkpointed weights win); the backbone is
            # frozen, so the optimizer holds nothing of it
            state = self._graft_resnet(state, rc)
        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            log.info("resumed from step %d", state.step)
        if self.wide:
            state = place_state(state, self.mesh, fsdp=self.cfg.fsdp,
                                zero=self.cfg.shard_opt_state)
        return state

    def _graft_resnet(self, state: TrainState, path: str) -> TrainState:
        """Loads a torchvision resnet18 checkpoint into the frozen backbone
        and its batch-norm statistics (each tensor keeps its dtype)."""
        from blt_vqg_tpu_torch.ops.resnet import load_resnet18_checkpoint
        state.model.encoder_cnn.backbone.load_state_dict(
            load_resnet18_checkpoint(path))
        log.info("grafted pretrained resnet18 backbone from %s", path)
        return state

    def _disk_dtype(self):
        """On-disk param dtype for checkpoints (None = store as-is)."""
        dt = self.cfg.checkpoint_param_dtype
        return None if dt == "float32" else dt

    def _model_batch(self, batch: Dict, step: int, train: bool) -> Dict:
        out = {k: batch[k] for k in ("context", "posterior", "target")}
        with col.active(self.mesh):   # the global batch's crop boxes
            out["images"] = (self.augment_train(batch["images"],
                                                self._key(_AUG_TRAIN + step))
                             if train else self.augment_eval(batch["images"]))
        return out

    def _stop(self, flag: bool, step: int, every: int) -> bool:
        """Whether to stop at ``step``: ``flag`` itself in one process;
        across processes, at every ``every``-th step (where the loop waits
        for the card anyway), whether it is on in any rank, since a
        SIGTERM reaches the ranks at different steps."""
        if not self.wide:
            return flag
        if step % every:
            return False
        t = torch.tensor([float(flag)], device=self.device)
        return bool(col.all_reduce(t, self.mesh.group(*self.mesh.shape),
                                   torch.distributed.ReduceOp.MAX)[0] > 0)

    def _chunk_len(self, step: int, max_steps: int, log_every: int) -> int:
        """Steps to run in one multi-step call: capped so a call never
        crosses a phase, validation, checkpoint or log boundary."""
        cfg = self.cfg
        nxt = max_steps
        for interval in (cfg.val_check_interval, cfg.checkpoint_every,
                         log_every):
            nxt = min(nxt, (step // interval + 1) * interval)
        if step < cfg.num_pretraining_steps:
            nxt = min(nxt, cfg.num_pretraining_steps)
        return max(1, min(cfg.steps_per_dispatch, nxt - step))

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train_iter: Iterator, val_iter_factory,
            max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        max_steps = max_steps or cfg.total_training_steps
        step = int(state.step)
        first_step = step
        latent = step >= cfg.num_pretraining_steps
        t_last = time.time()
        log_every = 50
        clock = _Clock(self.device)

        # graceful shutdown: SIGTERM/SIGINT finish the current step (across
        # processes, the steps to the next multiple of log_every), save a
        # checkpoint, and return (a resume picks up from there)
        stop_requested = {"flag": False}

        def _request_stop(signum, frame):
            log.warning("signal %d: checkpointing and stopping", signum)
            stop_requested["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # non-main thread
                pass

        early_stop = EarlyStopping(cfg.early_stop_patience,
                                   cfg.early_stop_min_delta,
                                   active_from=cfg.num_pretraining_steps)
        prof = None
        if self.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        marks = []
        fit_start = clock.mark()
        try:
            while step < max_steps and not self._stop(
                    stop_requested["flag"], step, log_every):
                if not latent and step >= cfg.num_pretraining_steps:
                    latent = True
                    state = state.reset_optimizer()
                    log.info("phase switch at step %d: latent ON, Adam reset",
                             step)

                n = (self._chunk_len(step, max_steps, log_every)
                     if cfg.steps_per_dispatch > 1 else 1)
                if n > 1:
                    mbs = [self._model_batch(next(train_iter), step + i,
                                             train=True) for i in range(n)]
                    stacked = {k: torch.stack([m[k] for m in mbs])
                               for k in mbs[0]}
                    t0 = clock.mark()
                    state, metrics = self._train_step(latent, multi=True)(
                        state, stacked,
                        lambda i, s=step: self._key(s + i))
                    marks.append((t0, clock.mark()))
                    step += n - 1  # inner steps; the loop tail adds the last
                else:
                    mb = self._model_batch(next(train_iter), step, train=True)
                    t0 = clock.mark()
                    state, metrics = self._train_step(latent)(
                        state, mb, self._key(step))
                    marks.append((t0, clock.mark()))

                if (step + 1) % log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    sps = log_every * cfg.batch_size / dt
                    t_last = time.time()
                    self.writer.write(step + 1, host, prefix="train")
                    log.info(
                        "step %d loss %.4f rec %.4f kld %.4f ppl %.1f "
                        "(%.1f samples/s)", step + 1, host["loss"],
                        host["rec"], host["kld"], host["ppl"], sps)
                self.history.append((step + 1, metrics))

                step += 1
                if step % cfg.val_check_interval == 0:
                    val = self.validate(state, val_iter_factory(), latent,
                                        step)
                    if early_stop.update(step, val.get("loss", float("inf"))):
                        log.info("early stopping at step %d (val loss "
                                 "plateaued %d validations)", step,
                                 early_stop.stale)
                        break
                if step % cfg.checkpoint_every == 0:
                    # async write: host copy now, file IO off the step path
                    t0 = time.perf_counter()
                    self.ckpt.save(state, self.cfg, block=False,
                                   on_disk_param_dtype=self._disk_dtype())
                    self.timings["save_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(self.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(self.profile_dir, "trace.json"))
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
        self.timings["fit_ms"].append(clock.ms(fit_start, clock.mark()))
        self.timings["fit_steps"].append(step - first_step)
        self.timings["dispatch_ms"] += [clock.ms(a, b) for a, b in marks]
        if self.cfg.checkpoint_at_end:
            self.ckpt.save(state, self.cfg, block=True,
                           on_disk_param_dtype=self._disk_dtype())
        self.ckpt.wait()
        if self.wide:
            self.mesh.barrier()
        return state

    # ------------------------------------------------------------------
    def validate(self, state: TrainState, val_iter, latent: bool, step: int,
                 print_samples: int = 10) -> Dict[str, float]:
        cfg = self.cfg
        t0 = time.perf_counter()
        sums: Dict[str, float] = {}
        count = 0
        first_batch = None
        for i, batch in enumerate(val_iter):
            if i >= cfg.limit_val_batches:
                break
            if first_batch is None:
                first_batch = batch
            mb = self._model_batch(batch, step + i, train=False)
            metrics = self._eval_steps[latent](
                state, mb, self._key(_EVAL + step + i))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if hasattr(val_iter, "close"):   # a prefetcher left mid-stream
            val_iter.close()
        if count == 0:
            log.warning("validation saw 0 batches (batch_size %d vs split "
                        "size); returning inf loss", cfg.batch_size)
            return {"loss": float("inf")}
        means = {k: v / count for k, v in sums.items()}
        self.writer.write(step, means, prefix="val")

        if self.wide:
            # the batch's rows and the whole weights to rank 0 (every rank
            # takes part); rank 0 alone decodes and scores
            first_batch = self._gathered_batch(first_batch)
            self._load_report_model(state)
            if not self.is_main:
                self.timings["validate_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                return dict(means)
        # greedy decode report on the first val batch
        scores = self.decode_report(state, first_batch, latent, step,
                                    print_samples)
        if scores:
            # the decode-quality trail, x100 as printed
            self.writer.write(step, {k: v * 100.0 for k, v in scores.items()},
                              prefix="nlg")
        diag = {}
        if latent and cfg.latent_diagnostics:
            diag = self.latent_report(state, first_batch, step)
            self.writer.write(step, diag, prefix="zdiag")
        print("##### validation @ step", step, "#####")
        for k, v in means.items():
            print(k, "\t", np.round(v, 4))
        for k, v in scores.items():
            print(k, "\t", np.round(v * 100, 4))
        for k, v in diag.items():
            print(k, "\t", np.round(v, 4))
        print(self.hp_string)
        self.timings["validate_ms"].append((time.perf_counter() - t0) * 1e3)
        return {**means, **{f"nlg_{k}": v for k, v in scores.items()}, **diag}

    def _gathered_batch(self, batch) -> Dict:
        """The whole global batch from every rank's rows (along the batch
        axes, in batch order)."""
        group = self.mesh.group(*BATCH_AXES)
        _, count = self.mesh.batch_coord()
        out = {}
        for k in ("images", "context", "posterior", "target", "image_ids",
                  "answer_types"):
            if k in batch:
                t = torch.as_tensor(batch[k], device=self.device)
                out[k] = col.gather_dim(t, group, 0, t.shape[0] * count)
        return out

    def _load_report_model(self, state) -> None:
        """The whole weights into rank 0's report model (a collective)."""
        if not self._split_weights:
            return
        sd = state.placement.full_state_dict(state.model)
        if self.is_main:
            self.report_model.load_state_dict(sd)

    def _detok(self, tokens_row) -> str:
        """Token ids -> space-joined words, stopping at <end>, specials
        filtered."""
        idx2word = self.vocab.idx2word
        words = []
        for t in tokens_row:
            w = idx2word.get(int(t), "<unk>")
            if w == "<end>":
                break
            words.append(w)
        return " ".join(filter_special_tokens(words))

    def _decode_inputs(self, batch):
        """The eval-augmented images and the 1-token category context [B, 1]
        the decode reports condition on."""
        images = self.augment_eval(batch["images"])
        context = torch.as_tensor(_host(batch["answer_types"])[:, None]
                                  .astype(np.int32), device=self.device)
        return images, context

    def latent_report(self, state: TrainState, batch,
                      step: int) -> Dict[str, float]:
        """The latent on one val batch: distribution statistics (active
        dims, prior spread, posterior-prior mean gap) and the decode BLEU-4
        of z from a prior sample, the prior mean and the posterior mean
        (an oracle); a widening sample-vs-mean gap with a stable oracle is
        the prior-variance decay signature."""
        if self._diag_steps is None:
            self._diag_steps = {"stats": make_latent_diag_step(
                self.cfg, self.report_model)}
            for src in Z_REPORT_SOURCES:
                self._diag_steps[src] = make_diag_decode_step(
                    self.cfg, self.report_model, src)
        images, context = self._decode_inputs(batch)
        posterior = batch["posterior"]
        stats = self._diag_steps["stats"](images, context, posterior)
        report = {
            "z_active_dims": float(stats["active_dims"]),
            "z_kl_top_dim": float(stats["kl_per_dim"].max()),
            "z_prior_logvar": float(stats["prior_logvar"]),
            "z_post_logvar": float(stats["post_logvar"]),
            "z_prior_mean_var": float(stats["prior_mean_var"]),
            "z_mean_gap": float(stats["mean_gap"]),
        }
        gts = [" ".join(filter_special_tokens(
            [self.vocab.idx2word.get(int(w), "<unk>") for w in row]))
            for row in _host(batch["target"])]
        for src in Z_REPORT_SOURCES:
            out = self._diag_steps[src](images, context, posterior,
                                        self._key(_DIAG + step))
            preds = [self._detok(row) for row in _host(out["tokens"])]
            try:
                sc = self.nlge.compute_metrics(ref_list=[gts],
                                               hyp_list=preds)
                report[f"bleu4_{src}"] = sc["Bleu_4"] * 100.0
            except ZeroDivisionError:
                report[f"bleu4_{src}"] = 0.0
        report["bleu4_prior_gap"] = (report["bleu4_posterior_mean"]
                                     - report["bleu4_prior_sample"])
        return report

    def decode_report(self, state: TrainState, batch, latent: bool,
                      step: int, print_samples: int = 10) -> Dict[str, float]:
        """Greedy (or beam) decode of one batch, printed samples with each
        word's top-6 probabilities, and the NLG scores."""
        images, context = self._decode_inputs(batch)
        gen = self._key(_DECODE + step)
        if self._beam_steps is not None:
            out = self._beam_steps[latent](images, context, gen)
        else:
            sample_gen = (self.rngs.step_keys(_DECODE + step, "sample",
                                              device=self.device)["sample"]
                          if self.cfg.decode_sampling else None)
            out = self._decode_steps[latent](images, context, gen, sample_gen)
        tokens = _host(out["tokens"])
        # beam decode has no top-k probe
        has_topk = "top_tokens" in out
        top_tokens = _host(out["top_tokens"]) if has_topk else None
        top_probs = _host(out["top_probs"]) if has_topk else None
        target = _host(batch["target"])
        image_ids = _host(batch["image_ids"]) if "image_ids" in batch else None
        ctx = _host(context)

        preds, gts = [], []
        idx2word = self.vocab.idx2word
        for i in range(tokens.shape[0]):
            pred_words = []
            for t in tokens[i]:
                w = idx2word.get(int(t), "<unk>")
                if w == "<end>":
                    break
                pred_words.append(w)
            pred = " ".join(filter_special_tokens(pred_words))
            gt = " ".join(filter_special_tokens(
                [idx2word.get(int(w), "<unk>") for w in target[i]]))
            preds.append(pred)
            gts.append(gt)
            if i < print_samples:
                print("Image ID:\t", int(image_ids[i])
                      if image_ids is not None else "-")
                print("Context:\t", idx2word.get(int(ctx[i, 0]), "?"))
                print("Generated:\t", pred)
                print("Reference:\t", gt)
                if has_topk:
                    for j, w in enumerate(pred_words[:12]):
                        near = [(idx2word.get(int(tt), "?"),
                                 round(float(pv), 4))
                                for tt, pv in zip(top_tokens[i, j],
                                                  top_probs[i, j])]
                        print(w, "\t\t", near)
                print()

        try:
            return self.nlge.compute_metrics(ref_list=[gts], hyp_list=preds)
        except ZeroDivisionError:
            return {}
