"""Run configuration for the PyTorch port.

A mirror of ``blt_vqg_tpu/core/config.py``: the same field names and
defaults, so an ``args.json`` written by the JAX trainer loads unchanged.
It is mirrored rather than imported because importing the JAX package's
``core`` pulls in ``jax`` (``core/__init__.py`` imports ``core/rng.py``),
and the machines that run the port have no jax.  Field meanings are
documented at the JAX definition; a test holds the two field lists equal.
:func:`add_config_args` and :func:`config_from_args` are the JAX package's
argparse surface, copied; a test holds the parsed configurations equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # model dims
    emb_dim: int = 300
    hidden_dim: int = 300
    latent_dim: int = 300
    pwffn_dim: int = 600
    num_layers: int = 4
    num_heads: int = 4

    # optimization
    lr: float = 3e-5
    num_pretraining_steps: int = 12_000
    total_training_steps: int = 35_000
    full_kl_step: int = 15_000
    kl_ceiling: float = 0.5
    kl_floor: float = 0.0
    aux_ceiling: float = 1.0
    image_recon_lambda: float = 0.1
    batch_size: int = 128
    warmup_steps: int = 4000
    grad_clip: float = 5.0

    # data
    emb_file: Optional[str] = None
    resnet_ckpt: Optional[str] = None
    dataset: str = "data/processed/iq_dataset.hdf5"
    val_dataset: str = "data/processed/iq_val_dataset.hdf5"
    vocab: str = "vocab.json"
    cat2name: str = "data/processed/cat2name.json"
    input_mode: str = "ans"           # "ans" | "cat"
    print_note: str = ""

    # sequence geometry
    max_q_length: int = 20
    max_a_length: int = 4
    max_decode_length: int = 50

    # dropout
    attention_dropout: float = 0.1
    relu_dropout: float = 0.1
    layer_dropout: float = 0.0
    input_dropout: float = 0.0
    target_word_dropout: float = 0.0

    # harness cadence
    val_check_interval: int = 500
    limit_val_batches: int = 100
    checkpoint_every: int = 400
    checkpoint_at_end: bool = True
    output_dir: str = "runs/default"

    # numerics, kernels and parallelism
    dtype: str = "bfloat16"           # compute dtype
    param_dtype: str = "float32"      # parameter storage dtype
    mesh_shape: Tuple[int, ...] = (1, 1)
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    use_pallas_attention: bool = False
    use_pallas_decode: bool = False
    use_stream_decode: bool = False   # whole-stack decode kernel
    stream_weight_dtype: str = "bfloat16"   # "bfloat16" | "int8"
    stream_fused_head: str = "auto"   # "auto" | "on" | "off"
    stream_head_dtype: str = "auto"   # "auto" | "bfloat16" | "int8"
    remat: bool = False
    seed: int = 0
    image_size: int = 224
    prefetch_depth: int = 2
    guard_nonfinite: bool = False
    log_grad_norm: bool = True
    debug_nans: bool = False
    image_encoder: str = "resnet18"
    beam_size: int = 1
    decode_early_stop: bool = False
    decode_z_source: str = "prior_sample"   # | "prior_mean"
    decode_sampling: bool = False
    decode_temperature: float = 1.0
    decode_top_k: int = 0
    decode_top_p: float = 1.0
    latent_diagnostics: bool = False
    num_z_samples: int = 1
    model_family: str = "transformer"
    rnn_cell: str = "lstm"
    compat_pad_seed: bool = True      # greedy decode seeds with <pad>
    compat_decode_pad_mask: bool = False
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    steps_per_dispatch: int = 1
    compat_trailing_relu: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: int = 2
    fsdp: bool = False
    shard_opt_state: bool = False
    sequence_parallel: bool = False
    ring_attention_impl: str = "xla"
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    moe_aux_weight: float = 0.01
    moe_router_z_weight: float = 1e-3
    moe_router_noise: float = 0.0
    checkpoint_backend: str = "npz"
    checkpoint_param_dtype: str = "float32"
    tie_output_z: bool = False
    fused_adam: bool = True
    adam_mu_dtype: str = "float32"
    adam_factored_nu: bool = False
    grad_dtype: str = "float32"

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        raw = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in raw.items() if k in fields}
        for key in ("mesh_shape", "mesh_axis_names"):
            if key in kept and isinstance(kept[key], list):
                kept[key] = tuple(kept[key])
        return cls(**kept)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    # derived ----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def max_target_len(self) -> int:
        return self.max_q_length

    @property
    def max_posterior_len(self) -> int:
        return self.max_q_length + 1

    @property
    def max_context_len(self) -> int:
        # "ans": answer plus the answer-type token; "cat": [<start>, cat, <end>]
        return self.max_a_length + 1 if self.input_mode == "ans" else 3


# ----------------------------------------------------------------------
# argparse shim (a copy of the JAX package's, reference train_iq.py:312-353)


def add_config_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    defaults = Config()
    parser.add_argument("--emb_dim", type=int, default=defaults.emb_dim)
    parser.add_argument("--hidden_dim", type=int, default=defaults.hidden_dim)
    parser.add_argument("--latent_dim", type=int, default=defaults.latent_dim)
    parser.add_argument("--pwffn_dim", type=int, default=defaults.pwffn_dim)
    parser.add_argument("--num_layers", type=int, default=defaults.num_layers)
    parser.add_argument("--num_heads", type=int, default=defaults.num_heads)
    parser.add_argument("--lr", type=float, default=defaults.lr)
    parser.add_argument("--num_pretraining_steps", type=int,
                        default=defaults.num_pretraining_steps)
    parser.add_argument("--total_training_steps", type=int,
                        default=defaults.total_training_steps)
    parser.add_argument("--full_kl_step", type=int, default=defaults.full_kl_step)
    parser.add_argument("--kl_ceiling", type=float, default=defaults.kl_ceiling)
    parser.add_argument("--kl_floor", type=float, default=defaults.kl_floor)
    parser.add_argument("--target_word_dropout", type=float,
                        default=defaults.target_word_dropout)
    parser.add_argument("--aux_ceiling", type=float, default=defaults.aux_ceiling)
    parser.add_argument("--image_recon_lambda", type=float,
                        default=defaults.image_recon_lambda)
    parser.add_argument("--batch_size", type=int, default=defaults.batch_size)
    parser.add_argument("--emb_file", type=str, default=defaults.emb_file)
    parser.add_argument("--resnet_ckpt", type=str,
                        default=defaults.resnet_ckpt)
    parser.add_argument("--dataset", type=str, default=defaults.dataset)
    parser.add_argument("--val_dataset", type=str, default=defaults.val_dataset)
    parser.add_argument("--vocab", type=str, default=defaults.vocab)
    parser.add_argument("--cat2name", type=str, default=defaults.cat2name)
    parser.add_argument("--input_mode", type=str, default=defaults.input_mode,
                        choices=("ans", "cat"))
    parser.add_argument("--print_note", type=str, default=defaults.print_note)
    parser.add_argument("--output_dir", type=str, default=defaults.output_dir)
    parser.add_argument("--val_check_interval", type=int,
                        default=defaults.val_check_interval)
    parser.add_argument("--limit_val_batches", type=int,
                        default=defaults.limit_val_batches)
    parser.add_argument("--checkpoint_every", type=int,
                        default=defaults.checkpoint_every)
    parser.add_argument("--image_size", type=int, default=defaults.image_size)
    parser.add_argument("--max_q_length", type=int,
                        default=defaults.max_q_length)
    parser.add_argument("--max_a_length", type=int,
                        default=defaults.max_a_length)
    parser.add_argument("--max_decode_length", type=int,
                        default=defaults.max_decode_length)
    parser.add_argument("--warmup_steps", type=int,
                        default=defaults.warmup_steps)
    parser.add_argument("--grad_clip", type=float, default=defaults.grad_clip)
    parser.add_argument("--compat_pad_seed",
                        action=argparse.BooleanOptionalAction,
                        default=defaults.compat_pad_seed,
                        help="seed greedy decode with <pad> like the "
                        "reference (iq.py:129); --no-compat-pad-seed uses "
                        "<start>")
    parser.add_argument("--compat_decode_pad_mask", action="store_true",
                        help="mask pad-token keys in decode self-attention "
                        "like the reference (exact decode parity)")
    # TPU-native flags
    parser.add_argument("--dtype", type=str, default=defaults.dtype)
    parser.add_argument("--param_dtype", type=str,
                        default=defaults.param_dtype,
                        choices=("float32", "bfloat16"),
                        help="'bfloat16': mixed-precision storage — params "
                        "live in bf16 with f32 Adam masters (train/"
                        "fused_adam.py); forward math is value-identical "
                        "(compute was already bf16), grads/update gain one "
                        "bf16 rounding.  HBM diet for the bandwidth-bound "
                        "step")
    parser.add_argument("--num_data_shards", type=int, default=1,
                        help="size of the 'data' mesh axis")
    parser.add_argument("--num_model_shards", type=int, default=1,
                        help="size of the 'model' mesh axis")
    parser.add_argument("--use_pallas_attention", action="store_true")
    parser.add_argument("--pipeline_stages", type=int,
                        default=defaults.pipeline_stages)
    parser.add_argument("--pipeline_microbatches", type=int,
                        default=defaults.pipeline_microbatches)
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--shard_opt_state", action="store_true")
    parser.add_argument("--sequence_parallel", action="store_true")
    parser.add_argument("--ring_attention_impl", type=str, default="xla",
                        choices=("xla", "pallas"))
    parser.add_argument("--moe_num_experts", type=int,
                        default=defaults.moe_num_experts,
                        help=">1: mixture-of-experts FFNs (ops/moe.py); "
                        "expert kernels shard over an 'expert' mesh axis")
    parser.add_argument("--moe_top_k", type=int, default=defaults.moe_top_k)
    parser.add_argument("--moe_capacity_factor", type=float,
                        default=defaults.moe_capacity_factor)
    parser.add_argument("--moe_every", type=int, default=defaults.moe_every)
    parser.add_argument("--moe_aux_weight", type=float,
                        default=defaults.moe_aux_weight)
    parser.add_argument("--moe_router_z_weight", type=float,
                        default=defaults.moe_router_z_weight)
    parser.add_argument("--moe_router_noise", type=float,
                        default=defaults.moe_router_noise)
    parser.add_argument("--num_expert_shards", type=int, default=1,
                        help="size of the 'expert' mesh axis (with "
                        "--moe_num_experts)")
    parser.add_argument("--checkpoint_backend", type=str, default="npz",
                        choices=("npz", "orbax"))
    parser.add_argument("--use_pallas_decode", action="store_true")
    parser.add_argument("--use_stream_decode", action="store_true")
    parser.add_argument("--stream_weight_dtype", type=str,
                        default=defaults.stream_weight_dtype,
                        choices=("bfloat16", "int8"))
    parser.add_argument("--stream_fused_head", type=str,
                        default=defaults.stream_fused_head,
                        choices=("auto", "on", "off"),
                        help="fuse final-LN + vocab projection + argmax into "
                        "one streamed Pallas kernel on the serving decode "
                        "(ops/pallas/decode_head.py); auto = on iff the "
                        "head streams int8 (the measured-win regime)")
    parser.add_argument("--stream_head_dtype", type=str,
                        default=defaults.stream_head_dtype,
                        choices=("auto", "bfloat16", "int8"),
                        help="fused-head weight stream dtype; auto follows "
                        "--stream_weight_dtype")
    parser.add_argument("--tie_output_z", action="store_true")
    parser.add_argument("--num_seq_shards", type=int, default=1,
                        help="size of the 'seq' mesh axis (with "
                        "--sequence_parallel)")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--guard_nonfinite", action="store_true")
    parser.add_argument("--debug_nans", action="store_true")
    parser.add_argument("--decode_early_stop", action="store_true")
    parser.add_argument("--steps_per_dispatch", type=int,
                        default=defaults.steps_per_dispatch)
    parser.add_argument("--fused_adam", action=argparse.BooleanOptionalAction,
                        default=defaults.fused_adam,
                        help="fused clip+Adam update pass (train/"
                        "fused_adam.py); --no-fused_adam restores the "
                        "optax chain")
    parser.add_argument("--adam_mu_dtype", type=str,
                        default=defaults.adam_mu_dtype,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--adam_factored_nu", action="store_true",
                        default=defaults.adam_factored_nu,
                        help="Adafactor-style factored second moment for "
                        ">=2-D trainable leaves (optimizer diet; changes "
                        "optimizer numerics — see train/fused_adam.py)")
    parser.add_argument("--grad_dtype", type=str,
                        default=defaults.grad_dtype,
                        choices=("float32", "bfloat16"),
                        help="gradient storage dtype; bfloat16 halves grad "
                        "HBM round-trips (diet knob, optimizer math stays "
                        "f32)")
    parser.add_argument("--checkpoint_param_dtype", type=str,
                        default=defaults.checkpoint_param_dtype,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--early_stop_patience", type=int,
                        default=defaults.early_stop_patience)
    parser.add_argument("--early_stop_min_delta", type=float,
                        default=defaults.early_stop_min_delta)
    parser.add_argument("--no_checkpoint_at_end", dest="checkpoint_at_end",
                        action="store_false")
    parser.set_defaults(checkpoint_at_end=True)
    parser.add_argument("--image_encoder", type=str,
                        default=defaults.image_encoder,
                        choices=("resnet18", "vit_b16"))
    parser.add_argument("--beam_size", type=int, default=defaults.beam_size)
    parser.add_argument("--decode_z_source", type=str,
                        default=defaults.decode_z_source,
                        choices=("prior_sample", "prior_mean"))
    parser.add_argument("--decode_sampling", action="store_true",
                        help="sampled decode (temperature/top-k/top-p) "
                        "instead of greedy argmax")
    parser.add_argument("--decode_temperature", type=float,
                        default=defaults.decode_temperature)
    parser.add_argument("--decode_top_k", type=int,
                        default=defaults.decode_top_k)
    parser.add_argument("--decode_top_p", type=float,
                        default=defaults.decode_top_p)
    parser.add_argument("--latent_diagnostics", action="store_true")
    parser.add_argument("--num_z_samples", type=int,
                        default=defaults.num_z_samples)
    parser.add_argument("--model_family", type=str,
                        default=defaults.model_family,
                        choices=("transformer", "rnn"))
    parser.add_argument("--rnn_cell", type=str, default=defaults.rnn_cell,
                        choices=("lstm", "gru"))
    parser.add_argument("--seed", type=int, default=defaults.seed)
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    d = getattr(args, "num_data_shards", 1)
    m = getattr(args, "num_model_shards", 1)
    s = getattr(args, "num_seq_shards", 1)
    e = getattr(args, "num_expert_shards", 1)
    if getattr(args, "sequence_parallel", False) and s > 1:
        kw["mesh_shape"] = (d, m, s)
        kw["mesh_axis_names"] = ("data", "model", "seq")
    elif getattr(args, "moe_num_experts", 0) > 1 and e > 1:
        kw["mesh_shape"] = (d, m, e)
        kw["mesh_axis_names"] = ("data", "model", "expert")
    else:
        kw["mesh_shape"] = (d, m)
    return Config(**kw)
