"""Carries weights between the JAX package's flax trees and the port.

- :func:`from_flax` maps ``{params, batch_stats}`` nested dicts (numpy
  arrays or torch tensors) onto the port's ``state_dict`` names: the flax
  module path joined with dots, Dense kernels [in, out] transposed to
  Linear [out, in], conv kernels HWIO to OIHW, LayerNorm/BatchNorm
  ``scale`` to ``weight``, ``embedding`` to ``weight``, batch-stat
  ``mean``/``var`` to ``running_mean``/``running_var``; the parameters a
  module declares itself (the MoE FFN's ``router``, ``expert_in[_bias]``
  and ``expert_out[_bias]``, the ViT's ``cls_token`` and ``pos_embed``)
  keep their names and layouts.
- :func:`to_flax` is the inverse.
- :func:`load_train_state` carries a JAX ``TrainState`` (step, kliter,
  params, batch stats and the ``FusedAdamState`` count and mu/nu/master
  trees, whose frozen leaves hold ``optax.MaskedNode``; or the
  ``fused_adam=False`` optax chain's ``scale_by_adam`` count and moments)
  into the port's
  :class:`~blt_vqg_tpu_torch.train.state.TrainState`;
  :func:`train_state_to_flax` is the inverse.  A factored second moment's
  (r, c) pair swaps at a Dense kernel, whose port layout is transposed.
- :func:`load_npz` reads a JAX npz checkpoint (``<dir>/step_N/state.npz``,
  keys ``params/...`` and ``batch_stats/...``) without jax.  bf16 leaves
  are stored there as raw void bytes beside a ``__dtype__/<key>`` entry;
  they come back as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
_EMBED_MODULES = {"embed"}   # modules whose 2-D weight is a lookup table
# parameters declared by name (not Dense/Conv/norm leaves): the same name
# and layout in both packages
_RAW_LEAVES = {"router", "expert_in", "expert_in_bias", "expert_out",
               "expert_out_bias", "cls_token", "pos_embed"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":   # ml_dtypes arrays from jax
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _port_name(mods, leaf: str) -> str:
    if leaf in _RAW_LEAVES:
        return ".".join(mods + [leaf])
    if leaf in ("kernel", "scale", "embedding"):
        return ".".join(mods + ["weight"])
    if leaf == "bias":
        return ".".join(mods + ["bias"])
    raise KeyError(f"unknown flax parameter {'/'.join(mods + [leaf])}")


def _port_layout(leaf: str, t: torch.Tensor) -> torch.Tensor:
    if leaf == "kernel":
        t = t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)  # HWIO->OIHW
    return t.contiguous()


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for (*mods, leaf), v in _leaves(params):
        sd[_port_name(mods, leaf)] = _port_layout(leaf, _tensor(v))
    for (*mods, leaf), v in _leaves(batch_stats or {}):
        sd[".".join(mods + [_STATS[leaf]])] = _tensor(v).contiguous()
    return sd


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: bf16 tensors widen to f32, which is exact
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(tree, mods, leaf, value):
    for m in mods:
        tree = tree.setdefault(m, {})
    tree[leaf] = value


def _flax_leaf(key: str, t: torch.Tensor):
    """(module path, flax leaf name, the tensor in flax layout) of a port
    parameter."""
    *mods, name = key.split(".")
    if name == "bias" or name in _RAW_LEAVES:
        return mods, name, t
    if name == "weight" and t.ndim == 4:
        return mods, "kernel", t.permute(2, 3, 1, 0)
    if name == "weight" and t.ndim == 2:
        if mods[-1] in _EMBED_MODULES:
            return mods, "embedding", t
        return mods, "kernel", t.T
    if name == "weight" and t.ndim == 1:
        return mods, "scale", t
    raise KeyError(f"unknown state_dict entry {key}")


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's ``state_dict`` -> (flax ``params``, ``batch_stats``)."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        if name in _STATS_BACK:
            _put(stats, mods, _STATS_BACK[name], _numpy(t))
        else:
            mods, leaf, t = _flax_leaf(key, t)
            _put(params, mods, leaf, _numpy(t))
    return params, stats


# ---------------------------------------------------------------------------
# train state

def _is_masked(v) -> bool:
    """``optax.MaskedNode``: an empty named tuple (no jax import here)."""
    return isinstance(v, tuple) and len(v) == 0


def _moments_from_flax(tree, order) -> dict:
    """A JAX moment tree -> {port name: tensor or FactoredNu}, in the order
    of the port parameter names ``order``; masked leaves are dropped."""
    from blt_vqg_tpu_torch.train.fused_adam import FactoredNu

    out = {}
    for (*mods, leaf), v in _leaves(tree):
        if _is_masked(v):
            continue
        if hasattr(v, "r") and hasattr(v, "c"):
            r, c = _tensor(v.r).contiguous(), _tensor(v.c).contiguous()
            if leaf == "kernel" and r.dim() == 1:   # transposed Dense kernel
                r, c = c, r
            out[_port_name(mods, leaf)] = FactoredNu(r, c)
        else:
            out[_port_name(mods, leaf)] = _port_layout(leaf, _tensor(v))
    return {n: out[n] for n in order if n in out}


def load_train_state(state, jax_state):
    """Loads a JAX ``TrainState`` (anything with ``step``, ``kliter``,
    ``params``, ``batch_stats`` and a ``FusedAdamState`` ``opt_state``, or
    the optax chain's ``multi_transform`` state; arrays or numpy) into the
    port's ``state``, in place; returns it."""
    from blt_vqg_tpu_torch.train.fused_adam import FactoredNu, FusedAdamState

    model = state.model
    model.load_state_dict(from_flax(jax_state.params, jax_state.batch_stats))
    device = next(model.parameters()).device
    order = [n for n, _ in model.named_parameters()]

    def moved(tree):
        return {n: (FactoredNu(v.r.to(device), v.c.to(device))
                    if isinstance(v, FactoredNu) else v.to(device))
                for n, v in _moments_from_flax(tree, order).items()}

    opt = jax_state.opt_state
    state.step, state.kliter = int(jax_state.step), int(jax_state.kliter)
    if hasattr(opt, "inner_states"):   # the chain: scale_by_adam's state
        opt = opt.inner_states["train"].inner_state[1]
        master = {}
    else:
        master = moved(opt.master)
    state.opt_state = FusedAdamState(int(opt.count), moved(opt.mu),
                                     moved(opt.nu), master)
    return state


def train_state_to_flax(state, masked=None, factored=None) -> dict:
    """The port's ``TrainState`` -> a dict of the JAX ``TrainState`` fields
    (``step``, ``kliter``, ``params``, ``batch_stats``) and its
    ``FusedAdamState`` (``count``, ``mu``, ``nu``, ``master``) as numpy
    trees.  Leaves without a moment hold ``masked`` (pass
    ``optax.MaskedNode()``); a factored moment becomes ``factored(r, c)``
    (default: the port's ``FactoredNu``).  bf16 values widen to f32."""
    from blt_vqg_tpu_torch.train.fused_adam import FactoredNu

    params, stats = to_flax(state.model.state_dict())
    make_factored = factored or FactoredNu

    def tree(values):
        out: dict = {}
        for name, p in state.model.named_parameters():
            mods, leaf, _ = _flax_leaf(name, p)
            v = values.get(name)
            if v is None:
                value = masked
            elif isinstance(v, FactoredNu):
                r, c = _numpy(v.r), _numpy(v.c)
                if leaf == "kernel" and p.dim() == 2:
                    r, c = c, r
                value = make_factored(r, c)
            else:
                value = _numpy(_flax_leaf(name, v)[2])
            _put(out, mods, leaf, value)
        return out

    opt = state.opt_state
    return {"step": state.step, "kliter": state.kliter, "params": params,
            "batch_stats": stats, "count": opt.count, "mu": tree(opt.mu),
            "nu": tree(opt.nu), "master": tree(opt.master)}


_STEP_RE = re.compile(r"^step_(\d+)$")


def _latest_npz(directory: str) -> str:
    if os.path.exists(os.path.join(directory, "state.npz")):
        return os.path.join(directory, "state.npz")
    steps = [int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(directory))
             if m and os.path.exists(os.path.join(directory, m.group(0),
                                                  "state.npz"))]
    if not steps:
        raise FileNotFoundError(f"no step_N/state.npz under {directory}")
    return os.path.join(directory, f"step_{max(steps)}", "state.npz")


def load_npz(path: str) -> Tuple[dict, dict, Optional[int]]:
    """Reads ``params`` and ``batch_stats`` from a JAX npz checkpoint.

    ``path`` is a ``state.npz`` file, a ``step_N`` directory, or a
    checkpoint directory (its latest step is read).  Returns
    (params, batch_stats, step) with torch tensor leaves."""
    if os.path.isdir(path):
        path = _latest_npz(path)
    params: dict = {}
    stats: dict = {}
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        for key in z.files:
            for prefix, tree in (("params/", params), ("batch_stats/", stats)):
                if not key.startswith(prefix):
                    continue
                arr = z[key]
                if arr.dtype.kind == "V":
                    dt = str(z["__dtype__/" + key]) if (
                        "__dtype__/" + key) in names else "?"
                    if dt != "bfloat16" or arr.dtype.itemsize != 2:
                        raise ValueError(f"{key}: stored as {arr.dtype} "
                                         f"with dtype record {dt!r}")
                    t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                *mods, leaf = key[len(prefix):].split("/")
                node = tree
                for m in mods:
                    node = node.setdefault(m, {})
                node[leaf] = t
        step = int(z["__step__"]) if "__step__" in names else None
    return params, stats, step
