"""Carries weights between the JAX package's flax trees and the port.

- :func:`from_flax` maps ``{params, batch_stats}`` nested dicts (numpy
  arrays or torch tensors) onto the port's ``state_dict`` names: the flax
  module path joined with dots, Dense kernels [in, out] transposed to
  Linear [out, in], conv kernels HWIO to OIHW, LayerNorm/BatchNorm
  ``scale`` to ``weight``, ``embedding`` to ``weight``, batch-stat
  ``mean``/``var`` to ``running_mean``/``running_var``.
- :func:`to_flax` is the inverse.
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


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for (*mods, leaf), v in _leaves(params):
        t = _tensor(v)
        if leaf == "kernel":
            t = t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)  # HWIO->OIHW
            name = "weight"
        elif leaf in ("scale", "embedding"):
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown flax parameter {'/'.join(mods + [leaf])}")
        sd[".".join(mods + [name])] = t.contiguous()
    for (*mods, leaf), v in _leaves(batch_stats or {}):
        sd[".".join(mods + [_STATS[leaf]])] = _tensor(v).contiguous()
    return sd


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: bf16 tensors widen to f32, which is exact
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's ``state_dict`` -> (flax ``params``, ``batch_stats``)."""
    params: dict = {}
    stats: dict = {}

    def put(tree, mods, leaf, arr):
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr

    for key, t in state_dict.items():
        *mods, name = key.split(".")
        if name in _STATS_BACK:
            put(stats, mods, _STATS_BACK[name], _numpy(t))
        elif name == "bias":
            put(params, mods, "bias", _numpy(t))
        elif name == "weight" and t.ndim == 4:
            put(params, mods, "kernel", _numpy(t.permute(2, 3, 1, 0)))
        elif name == "weight" and t.ndim == 2:
            if mods[-1] in _EMBED_MODULES:
                put(params, mods, "embedding", _numpy(t))
            else:
                put(params, mods, "kernel", _numpy(t.T))
        elif name == "weight" and t.ndim == 1:
            put(params, mods, "scale", _numpy(t))
        else:
            raise KeyError(f"unknown state_dict entry {key}")
    return params, stats


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
