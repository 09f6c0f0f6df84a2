"""Run configuration for the PyTorch port.

A mirror of ``blt_vqg_tpu/core/config.py``: the same field names and
defaults, so an ``args.json`` written by the JAX trainer loads unchanged.
It is mirrored rather than imported because importing the JAX package's
``core`` pulls in ``jax`` (``core/__init__.py`` imports ``core/rng.py``),
and the machines that run the port have no jax.  Field meanings are
documented at the JAX definition; a test holds the two field lists equal.
"""

from __future__ import annotations

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
