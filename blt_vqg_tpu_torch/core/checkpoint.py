"""Step checkpoints of the train state (counterpart of
``blt_vqg_tpu/core/checkpoint.py``, both its backends).

The format is the JAX package's, so a checkpoint written by either package
restores in the other:

- ``<dir>/step_N/state.npz``, one flat archive: ``params/<flax path>``,
  ``batch_stats/<flax path>``, the ``FusedAdamState`` as
  ``opt_state/.count``, ``opt_state/.mu/<path>``, ``opt_state/.nu/<path>``
  (a factored second moment as ``<path>/.r`` and ``<path>/.c``) and
  ``opt_state/.master/<path>``, then ``__step__`` and ``__kliter__``.  A
  ``fused_adam=False`` state (the optax chain) holds its count and moments
  where the chain's ``multi_transform`` tree puts them:
  ``opt_state/.inner_states/train/.inner_state/1/.count``, ``.../.mu/<path>``
  and ``.../.nu/<path>`` (``scale_by_adam``'s state; the clip, the scale and
  the frozen branch hold no arrays);
  Leaves are in flax layout (Dense kernels [in, out]; ``convert.py``
  maps the names and layouts).  bf16 leaves are stored as raw 2-byte void
  values beside a ``__dtype__/<key>`` record, as numpy has no bfloat16;
- ``args.json`` (the ``Config``) and ``extra.json`` beside it;
- each step is written into ``step_N.tmp`` and renamed, so a step
  directory is always whole; the ``keep`` newest steps are kept.

``save(block=False)`` copies the state to the host at once (the train step
updates it in place) and writes the files on a background thread;
``wait`` joins it.  ``on_disk_param_dtype="bfloat16"`` stores float
parameters (not moments or statistics) in bf16; restore casts every leaf
back to the train state's dtype.  A checkpoint whose optimizer layout
(``adam_factored_nu``, ``fused_adam``) differs from the train state's fails
with a message that names both.

Across processes (a state with a ``placement``, ``parallel/sharding.py``)
:meth:`CheckpointManager.save` gathers the tensor-parallel, ZeRO and FSDP
shards and rank 0 writes the same ``state.npz`` as a single-process run;
:meth:`~CheckpointManager.restore` reads it on every rank and keeps each
rank's blocks.  :meth:`~CheckpointManager.save_sharded` is the JAX
package's per-host format: each rank writes ``step_N/shard_h{rank}.npz``
with its own blocks in the flax layout, keys ``<key>@0`` beside
``__idx__/<key>@0``, the block's [start, stop) per flax dimension (and
``__dtype__/<key>@0`` for bf16), so either package restores the other's
files (``restore_sharded`` merges every rank's file and checks that the
blocks cover each leaf).  Every rank calls ``save``, ``save_sharded`` and
the restores (they are collectives); ``_barrier`` is ``dist.barrier``.

``backend="orbax"`` writes and reads ``step_N/orbax`` in the layout of the
JAX package's Orbax ``StandardCheckpointHandler``, without Orbax (which
imports jax): through ``tensorstore`` (imported when the backend is
chosen), one zarr v2 array per leaf in an OCDBT database
(``manifest.ocdbt``, ``d/``), named by its tree path joined with dots
(``params.embed.embedding``, ``opt_state.mu.<path>``,
``opt_state.nu.<path>.r``, ``opt_state.count``, ``step``, ``kliter``),
beside ``_METADATA`` (the tree: each leaf's key path and value type) and
``_CHECKPOINT_METADATA``.  The entries are the npz backend's, so
the sidecars, step discovery, retention, resume and
``on_disk_param_dtype`` behave alike.  Orbax writes each process's
arrays into ``ocdbt.process_<i>`` and merges them into the root database;
one writer here writes the root database directly, which Orbax reads the
same way.  Across processes the orbax backend gathers the state and rank
0 writes it (``save_sharded`` too).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import torch.distributed as dist

import numpy as np
import torch

from blt_vqg_tpu_torch.convert import _STATS_BACK, _flax_leaf, _port_layout
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.train.fused_adam import FactoredNu, FusedAdamState

_STEP_RE = re.compile(r"^step_(\d+)$")
_SHARD_RE = re.compile(r"^shard_h(\d+)\.npz$")
_CHUNK_RE = re.compile(r"^(.*)@(\d+)$")
_OPT_FIELDS = (("mu", ".mu"), ("nu", ".nu"), ("master", ".master"))
FUSED_PREFIX = "opt_state/"
CHAIN_PREFIX = "opt_state/.inner_states/train/.inner_state/1/"


ORBAX_DIR = "orbax"
# the named-tuple fields of the optimizer states (the npz keys prefix them
# with "."; the Orbax tree paths do not)
_FIELDS = {"count", "mu", "nu", "master", "inner_states", "inner_state",
           "r", "c"}
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _tensorstore():
    try:
        import tensorstore
    except ImportError as err:
        raise ImportError(
            "the orbax checkpoint backend reads and writes through "
            "tensorstore, which is not installed here (use "
            "backend='npz')") from err
    return tensorstore


def _orbax_path(key: str) -> tuple:
    """The Orbax tree path of an npz key."""
    special = {"__step__": ("step",), "__kliter__": ("kliter",)}
    if key in special:
        return special[key]
    return tuple(p[1:] if p.startswith(".") else p for p in key.split("/"))


def _npz_key(path) -> str:
    """The npz key of an Orbax tree path (inverse of :func:`_orbax_path`
    on the train state's trees)."""
    special = {("step",): "__step__", ("kliter",): "__kliter__"}
    if tuple(path) in special:
        return special[tuple(path)]
    if path[0] != "opt_state":
        return "/".join(path)
    return "/".join([path[0]] + ["." + p if p in _FIELDS else p
                                 for p in path[1:]])


def _ocdbt(directory: str) -> dict:
    return {"driver": "ocdbt", "base": {"driver": "file",
                                        "path": os.path.abspath(directory)}}


def write_orbax(directory: str, flat: dict) -> None:
    """Writes npz entries as an Orbax ``StandardCheckpointHandler``
    checkpoint into ``directory`` (which must not exist)."""
    import time

    ts = _tensorstore()
    t0 = time.time_ns()
    os.makedirs(directory)
    kv = _ocdbt(directory)
    kv["config"] = {"max_inline_value_bytes": 1024,
                    "max_decoded_node_bytes": 100000000,
                    "manifest_kind": "single"}
    ctx, txn = ts.Context(), ts.Transaction()
    tree = {}
    writes = []
    for key, arr in flat.items():
        if key.startswith("__dtype__/"):
            continue
        arr = np.asarray(arr)
        if arr.dtype.kind == "V":
            arr = arr.view(ts.bfloat16.numpy_dtype)
        elif key in ("__step__", "__kliter__"):
            arr = arr.astype(np.int32)
        path = _orbax_path(key)
        name = ".".join(path)
        writes.append((ts.open(
            {"driver": "zarr", "kvstore": dict(kv, path=name + "/"),
             "dtype": ts.dtype(arr.dtype).name,
             "metadata": {"shape": list(arr.shape),
                          "chunks": list(arr.shape),
                          "compressor": {"id": "zstd", "level": 1}}},
            create=True, context=ctx, transaction=txn), arr))
        value = ({"value_type": "np.ndarray", "skip_deserialize": False}
                 if key in ("__step__", "__kliter__") else
                 {"value_type": "jax.Array", "skip_deserialize": False,
                  "write_shape": list(arr.shape)})
        tree[str(path)] = {"key_metadata": [
            {"key": p, "key_type": 1 if p.isdigit() else 2} for p in path],
            "value_metadata": value}
    for w in [op.result().write(arr) for op, arr in writes]:
        w.result()
    txn.commit_async().result()
    for path in _masked_paths(flat):
        tree[str(path)] = {
            "key_metadata": [{"key": p, "key_type": 1 if p.isdigit() else 2}
                             for p in path],
            "value_metadata": {"value_type": "None",
                               "skip_deserialize": True}}
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def _masked_paths(flat: dict) -> list:
    """The tree paths of the optimizer state's ``optax.MaskedNode`` leaves:
    a moment (or master) field's entry for a parameter it holds nothing
    of.  Orbax records them, and refuses a restore whose tree lacks them."""
    base = CHAIN_PREFIX if CHAIN_PREFIX + ".count" in flat else FUSED_PREFIX
    fields = (".mu", ".nu") + ((".master",) if base == FUSED_PREFIX else ())
    params = [k[len("params/"):] for k in flat if k.startswith("params/")]
    out = []
    for field in fields:
        for p in params:
            key = f"{base}{field}/{p}"
            if key not in flat and key + "/.r" not in flat:
                out.append(_orbax_path(key))
    return out


def read_orbax(directory: str) -> dict:
    """The npz entries of an Orbax ``StandardCheckpointHandler``
    checkpoint (bf16 leaves as 2-byte void values with a dtype record)."""
    ts = _tensorstore()
    with open(os.path.join(directory, "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    ctx = ts.Context()
    kv = _ocdbt(directory)
    opens = {}
    for entry in tree.values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue                     # an optax MaskedNode: no array
        path = [k["key"] for k in entry["key_metadata"]]
        opens[_npz_key(path)] = ts.open(
            {"driver": "zarr", "kvstore": dict(kv, path=".".join(path) + "/")},
            open=True, context=ctx)
    reads = {key: op.result().read() for key, op in opens.items()}
    flat = {}
    for key, r in reads.items():
        arr = np.asarray(r.result())
        if arr.dtype == ts.bfloat16.numpy_dtype:
            flat["__dtype__/" + key] = np.str_("bfloat16")
            arr = arr.view(np.dtype("V2"))
        flat[key] = arr
    return flat


def _layout_name(factored: bool) -> str:
    return ("adam_factored_nu=True (factored second moments, .r/.c)"
            if factored else "adam_factored_nu=False (full second moments)")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as 2-byte void values)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _put(flat: dict, key: str, t: torch.Tensor) -> None:
    flat[key] = _host(t)
    if t.dtype == torch.bfloat16:
        flat["__dtype__/" + key] = np.str_("bfloat16")


def _get(flat: dict, key: str) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if arr.dtype.kind == "V":
        hint = str(flat.get("__dtype__/" + key, "?"))
        if hint != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"{key}: stored as {arr.dtype} with dtype "
                             f"record {hint!r}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _keys(model: torch.nn.Module):
    """(port name, npz key, flax leaf name) of every ``state_dict`` entry."""
    out = []
    for name, t in model.state_dict().items():
        *mods, last = name.split(".")
        if last in _STATS_BACK:
            out.append((name, "batch_stats/" + "/".join(
                mods + [_STATS_BACK[last]]), None))
        else:
            mods, leaf, _ = _flax_leaf(name, t)
            out.append((name, "params/" + "/".join(mods + [leaf]), leaf))
    return out


def _opt_key(base: str, field: str, name: str, p: torch.Tensor):
    mods, leaf, _ = _flax_leaf(name, p)
    return f"{base}{field}/" + "/".join(mods + [leaf]), leaf


def _opt_base(chain: bool) -> str:
    return CHAIN_PREFIX if chain else FUSED_PREFIX


def _optimizer_name(chain: bool) -> str:
    return ("fused_adam=False (the optax chain's state)" if chain
            else "fused_adam=True (the fused Adam state)")


def _swapped(leaf: str, p: torch.Tensor) -> bool:
    """A factored moment's (r, c) pair swaps at a Dense kernel, whose port
    layout is the flax kernel transposed."""
    return leaf == "kernel" and p.dim() == 2


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def flatten_state(state, cast_params=None) -> dict:
    """The npz entries of a port ``TrainState`` (host copies).  A placed
    state is gathered whole first (a collective)."""
    flat: dict = {}
    pl = state.placement
    sd = (state.model.state_dict() if pl is None
          else pl.full_state_dict(state.model))
    for name, key, leaf in _keys(state.model):
        t = sd[name]
        if leaf is not None:
            t = _flax_leaf(name, t)[2]
            if cast_params is not None and t.is_floating_point():
                t = t.to(cast_params)
        _put(flat, key, t)
    params = dict(state.model.named_parameters())
    opt = state.opt_state if pl is None else pl.full_opt(state.opt_state)
    base = _opt_base(state.tx.chain)
    flat[base + ".count"] = np.asarray(opt.count, np.int32)
    for attr, field in _OPT_FIELDS:
        for name, v in getattr(opt, attr).items():
            key, leaf = _opt_key(base, field, name, params[name])
            if isinstance(v, FactoredNu):
                r, c = ((v.c, v.r) if _swapped(leaf, params[name])
                        else (v.r, v.c))
                _put(flat, key + "/.r", r)
                _put(flat, key + "/.c", c)
            else:
                _put(flat, key, _flax_leaf(name, v)[2])
    flat["__step__"] = np.asarray(int(state.step))
    flat["__kliter__"] = np.asarray(int(state.kliter))
    return flat


def _is_factored(nu: dict) -> bool:
    return any(isinstance(v, FactoredNu) for v in nu.values())


def restore_flat(state, flat: dict, source: str = "checkpoint"):
    """Fills the port ``TrainState`` ``state`` from npz entries, in place:
    every leaf cast to the state's dtype and device (a placed state keeps
    each rank's blocks of the whole leaves).  Returns ``state``."""
    pl = state.placement
    specs = None if pl is None else pl.opt_specs(state.opt_state)

    def cut(t, spec):
        return t if spec is None else pl.local(t, spec).contiguous()

    chain = state.tx.chain
    base = _opt_base(chain)
    if base + ".count" not in flat:
        other = _opt_base(not chain)
        held = (_optimizer_name(not chain) if other + ".count" in flat
                else "no Adam state the port knows")
        raise ValueError(
            f"{source} holds {held}, but the train state was made with "
            f"{_optimizer_name(chain)}: make the train state with the "
            f"checkpoint's fused_adam to restore it")
    want = _is_factored(state.opt_state.nu)
    got = any(k.startswith(base + ".nu/") and k.endswith("/.r")
              for k in flat)
    if got != want:
        raise ValueError(
            f"{source} holds optimizer state with {_layout_name(got)}, but "
            f"the train state was made with {_layout_name(want)}: make the "
            f"train state with adam_factored_nu={got} to restore it")
    model = state.model
    sd = model.state_dict()
    new_sd = {}
    for name, key, leaf in _keys(model):
        t = _get(flat, key)
        if leaf is not None:
            t = _port_layout(leaf, t)
        if pl is not None and name in pl.store:
            t = cut(t.reshape(pl.full_shapes[name]), pl.store[name])
        new_sd[name] = t.to(sd[name].dtype).reshape(sd[name].shape)
    model.load_state_dict(new_sd)

    params = dict(model.named_parameters())
    opt = state.opt_state
    fields = {}
    for attr, field in _OPT_FIELDS:
        tree = {}
        for name, like in getattr(opt, attr).items():
            key, leaf = _opt_key(base, field, name, params[name])
            spec = None if specs is None else specs[attr][name]
            if isinstance(like, FactoredNu):
                r, c = _get(flat, key + "/.r"), _get(flat, key + "/.c")
                if _swapped(leaf, params[name]):
                    r, c = c, r
                if spec is not None:
                    r, c = cut(r, spec.r), cut(c, spec.c)
                tree[name] = FactoredNu(
                    r.to(like.r.device, like.r.dtype).reshape(like.r.shape),
                    c.to(like.c.device, like.c.dtype).reshape(like.c.shape))
            else:
                t = _port_layout(leaf, _get(flat, key))
                if spec is not None:
                    t = cut(t.reshape(pl.full_shapes[name]), spec)
                tree[name] = t.to(like.device, like.dtype).reshape(
                    like.shape)
        fields[attr] = tree
    state.opt_state = FusedAdamState(int(flat[base + ".count"]), **fields)
    state.step = int(flat["__step__"])
    state.kliter = int(flat["__kliter__"])
    return state


class CheckpointManager:
    """``backend="npz"``: the flat-archive format above; ``"orbax"``: the
    JAX package's Orbax layout (``step_N/orbax``), through tensorstore."""

    def __init__(self, directory: str, keep: int = 5,
                 backend: str = "npz"):
        if backend == "orbax":
            _tensorstore()
        elif backend != "npz":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.directory = directory
        self.keep = keep
        self.backend = backend
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            d = os.path.join(self.directory, name)
            if m and (os.path.exists(os.path.join(d, "state.npz"))
                      or os.path.isdir(os.path.join(d, ORBAX_DIR))
                      or any(_SHARD_RE.match(f) for f in os.listdir(d))):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -------------------------------------------------
    def save(self, state, cfg: Optional[Config] = None,
             extra: Optional[dict] = None, block: bool = True,
             on_disk_param_dtype: Optional[str] = None) -> str:
        """Saves ``state`` under ``step_<state.step>``.  The host copy is
        taken now; with ``block=False`` the files are written on a
        background thread (one write in flight at a time).  Across
        processes every rank calls it (the state is gathered) and rank 0
        writes."""
        self.wait()
        step = int(state.step)
        path = self._step_dir(step)
        cast = ({"bfloat16": torch.bfloat16, "float32": torch.float32}
                [on_disk_param_dtype] if on_disk_param_dtype else None)
        flat = flatten_state(state, cast)
        if _rank() != 0:
            return path
        cfg_json = cfg.to_json() if cfg is not None else None
        extra_json = json.dumps(extra) if extra else None

        def write():
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            if self.backend == "orbax":
                write_orbax(os.path.join(tmp, ORBAX_DIR), flat)
            else:
                np.savez(os.path.join(tmp, "state.npz"), **flat)
            if cfg_json is not None:
                with open(os.path.join(tmp, "args.json"), "w") as f:
                    f.write(cfg_json)
            if extra_json is not None:
                with open(os.path.join(tmp, "extra.json"), "w") as f:
                    f.write(extra_json)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if block:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._writer = threading.Thread(target=guarded, daemon=False)
            self._writer.start()
        return path

    def wait(self) -> None:
        """Joins an in-flight async write; raises what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, state, step: Optional[int] = None):
        """Fills ``state`` from disk in place (the latest step unless
        ``step``) and returns it; every rank reads the file and keeps its
        blocks."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if self.backend == "orbax":
            path = os.path.join(self._step_dir(step), ORBAX_DIR)
            return restore_flat(state, read_orbax(path), source=path)
        path = os.path.join(self._step_dir(step), "state.npz")
        if not os.path.exists(path):
            return self.restore_sharded(state, step)
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        return restore_flat(state, flat, source=path)

    def _gc(self):
        steps = self.all_steps()
        for step in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # -- sharded (per-rank) save / restore ------------------------------
    @staticmethod
    def _barrier() -> None:
        """Every rank waits for the others (no-op single-process)."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def save_sharded(self, state, cfg: Optional[Config] = None) -> str:
        """Each rank writes ``shard_h{rank}.npz``: its own blocks of every
        leaf in the flax layout with their slices; nothing is gathered.
        Rank 0 writes ``args.json`` and drops old steps.  The orbax
        backend writes one Orbax checkpoint of the gathered state."""
        if self.backend == "orbax":
            path = self.save(state, cfg, block=True)
            self._barrier()
            return path
        self.wait()
        step = int(state.step)
        path = self._step_dir(step)
        os.makedirs(path, exist_ok=True)
        flat = {"__step__": np.asarray(int(state.step)),
                "__kliter__": np.asarray(int(state.kliter))}
        for key, (t, idx) in _shard_entries(state).items():
            _put(flat, key, t)
            flat["__idx__/" + key] = np.asarray(idx, np.int64).reshape(-1, 2)
        rank = _rank()
        fname = os.path.join(path, f"shard_h{rank}.npz")
        np.savez(fname + ".tmp.npz", **flat)
        os.replace(fname + ".tmp.npz", fname)
        if rank == 0:
            if cfg is not None:
                with open(os.path.join(path, "args.json"), "w") as f:
                    f.write(cfg.to_json())
            self._gc()
        self._barrier()
        return path

    def restore_sharded(self, state, step: Optional[int] = None):
        """Fills ``state`` from the union of every rank's shard files of
        ``step`` (the latest unless given; written by either package,
        by any number of ranks), in place, and returns it."""
        self.wait()
        self._barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        files = sorted(f for f in os.listdir(path) if _SHARD_RE.match(f))
        if not files:
            raise FileNotFoundError(f"no shard files in {path}")
        chunks: dict = {}
        flat: dict = {}
        for f in files:
            with np.load(os.path.join(path, f), allow_pickle=False) as z:
                names = set(z.files)
                for k in sorted(names):
                    if k.startswith(("__idx__/", "__dtype__/")):
                        continue
                    m = _CHUNK_RE.match(k)
                    if not m:
                        flat.setdefault(k, z[k])    # __step__, __kliter__
                        continue
                    idx = z["__idx__/" + k].reshape(-1, 2)
                    chunks.setdefault(m.group(1), []).append(
                        (z[k], idx, str(z["__dtype__/" + k])
                         if "__dtype__/" + k in names else None))
        for key, parts in chunks.items():
            flat.update(_assemble(key, parts, path))
        restore_flat(state, flat, source=path)
        return state


def _shard_entries(state) -> dict:
    """{key@0: (this rank's block in the flax layout, its [start, stop)
    per flax dim)} of every leaf of ``state``."""
    from blt_vqg_tpu_torch.parallel.sharding import flax_leaf
    pl = state.placement
    out = {}

    def add(key, t, spec, full_shape, perm):
        idx = ([(0, n) for n in full_shape] if pl is None or spec is None
               else pl.index(spec, full_shape))
        flax_idx = [None] * len(idx)
        for i, p in enumerate(perm):
            flax_idx[p] = idx[i]
        out[key + "@0"] = (t, flax_idx)

    params = dict(state.model.named_parameters())
    sd = state.model.state_dict()
    for name, key, leaf in _keys(state.model):
        t = sd[name]
        if leaf is None:            # batch statistics: whole on every rank
            add(key, t, None, tuple(t.shape), tuple(range(t.dim())))
            continue
        full = pl.full_shapes[name] if pl is not None else tuple(t.shape)
        _, _, perm = flax_leaf(name, full)
        add(key, _flax_leaf(name, t)[2], None if pl is None
            else pl.store[name], full, perm)
    opt = state.opt_state
    base = _opt_base(state.tx.chain)
    out[base + ".count@0"] = (torch.tensor(opt.count, dtype=torch.int32), [])
    specs = None if pl is None else pl.opt_specs(opt)
    for attr, field in _OPT_FIELDS:
        for name, v in getattr(opt, attr).items():
            key, leaf = _opt_key(base, field, name, params[name])
            spec = None if specs is None else specs[attr][name]
            if isinstance(v, FactoredNu):
                sr, sc = (None, None) if spec is None else spec
                rs = v.r.shape if pl is None else \
                    pl.factored_shapes(name)[0]
                cs = v.c.shape if pl is None else \
                    pl.factored_shapes(name)[1]
                pairs = [(".r", v.r, sr, rs), (".c", v.c, sc, cs)]
                if _swapped(leaf, params[name]):
                    pairs = [(".r", v.c, sc, cs), (".c", v.r, sr, rs)]
                for suffix, t, s_, fs in pairs:
                    add(key + "/" + suffix, t, s_, tuple(fs),
                        tuple(range(len(fs))))
            else:
                full = (pl.full_shapes[name] if pl is not None
                        else tuple(v.shape))
                _, _, perm = flax_leaf(name, full)
                add(key, _flax_leaf(name, v)[2], spec, full, perm)
    return out


def _assemble(key: str, parts: list, source: str) -> dict:
    """The whole leaf ``key`` (and its dtype record) from its blocks
    [(data, idx, dtype name)]; blocks may repeat (replicated leaves) but
    must agree, and must cover every element."""
    ndim = parts[0][1].shape[0]
    shape = tuple(int(max(idx[d, 1] for _, idx, _ in parts))
                  for d in range(ndim))
    dt = parts[0][2]
    first = parts[0][0]
    flat = {} if dt is None else {"__dtype__/" + key: np.str_(dt)}
    if len(parts) == 1 and first.shape == shape:   # one whole block
        flat[key] = first
        return flat
    out = np.zeros(shape, dtype=first.dtype)
    seen = np.zeros(shape, dtype=bool)
    for data, idx, _ in parts:
        sl = tuple(slice(int(a), int(b)) for a, b in idx)
        block = np.asarray(data).reshape(np.shape(out[sl]))
        prev = np.asarray(seen[sl])
        if prev.any() and (np.asarray(out[sl])[prev].tobytes()
                           != block[prev].tobytes()):
            raise ValueError(f"{source}: leaf {key}: overlapping blocks "
                             f"disagree at {sl}")
        out[sl] = block
        seen[sl] = True
    if not seen.all():
        raise ValueError(f"{source}: leaf {key}: the blocks cover "
                         f"{int(seen.sum())} of {seen.size} elements (a "
                         f"rank's shard file missing?)")
    flat[key] = out
    return flat
