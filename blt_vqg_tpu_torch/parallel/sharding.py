"""Sharding rules and the placement of a train state across processes
(counterpart of ``blt_vqg_tpu/parallel/sharding.py``).

The rules are the JAX package's, over the same parameter paths: the port's
``state_dict`` names map onto the flax paths through ``convert.py``, and
every spec here is a tuple per flax dimension (a ``PartitionSpec``'s
entries: an axis name, a tuple of them, or None), so the port's specs equal
the JAX functions' leaf for leaf.

- The batch shards its leading dim over ``("dcn_data", "data")``.
- With ``model`` > 1 the transformer is tensor parallel in the Megatron
  pattern: q/k/v and FFN-in split their output features (whole heads per
  rank), out and FFN-out their input features, and each block sums its
  partial outputs once; the vocab heads split the vocab.
- MoE expert stacks split over ``expert`` (and their FFN width over
  ``model``).
- ``fsdp`` adds ``data`` to a free dim of every parameter, and ZeRO-1
  (``_zero1_spec``) does so for the optimizer's leaves.

A torch ``Linear`` weight is the flax kernel transposed, so a flax
``(None, "model")`` kernel splits the torch weight's dim 0;
:class:`Placement` turns the specs into the torch layout and holds a
rank's blocks (ceil-sized, as JAX lays out an uneven split).  It slices a
model built whole from its seed (:meth:`Placement.place_model`, which
also switches the modules to their split forms), slices the optimizer
state, gathers FSDP parameters for a step, updates ZeRO slices
(``train/fused_adam.py``), and gathers everything back for a checkpoint.
Unlike the JAX package, which replicates the optimizer state unless asked
to shard it, the moments of a tensor-parallel weight follow its split.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Optional, Tuple

import torch

from blt_vqg_tpu_torch.parallel import collectives as col
from blt_vqg_tpu_torch.parallel.mesh import BATCH_AXES, TP_AXES

# (regex over '/'-joined param path, spec) — first match wins.
# Kernel shapes are (in_features, out_features) per flax convention.
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # attention projections: q/k/v split heads over 'model'; out merges them
    (r"(q_proj|k_proj|v_proj)/kernel$", (None, "model")),
    (r"out_proj/kernel$",               ("model", None)),
    # positionwise FFN: column-parallel in, row-parallel out
    (r"ffn_in/kernel$",                 (None, "model")),
    (r"ffn_out/kernel$",                ("model", None)),
    # MoE expert-stacked kernels (ops/moe.py): experts over 'expert',
    # per-expert FFN width over 'model' (EP × TP compose); the router and
    # the [E, ...] biases stay with the experts / replicated
    (r"ffn/expert_in$",                 ("expert", None, "model")),
    (r"ffn/expert_out$",                ("expert", "model", None)),
    (r"ffn/expert_(in|out)_bias$",      ("expert", None)),
    # output vocab projection: split vocab over 'model'
    (r"(output_proj|z_classifier)/kernel$", (None, "model")),
    # everything else replicated
    (r".*", ()),
)
_VOCAB_RE = re.compile(r"(output_proj|z_classifier)/kernel$")


def _mesh_filtered(spec: tuple, mesh) -> tuple:
    """Drops axis names the mesh doesn't carry (e.g. 'expert' specs on a
    plain DP×TP mesh) — the dimension falls back to replicated."""
    axes = set(mesh.shape)
    return tuple((a if a in axes else None) for a in spec)


def spec_for_param(path_str: str, ndim: int) -> tuple:
    for pattern, spec in _RULES:
        if re.search(pattern, path_str):
            if len(spec) > ndim:  # e.g. biases under an ffn_in scope
                return ()
            return spec
    return ()


def _zero1_spec(base: tuple, shape, data_size: int) -> tuple:
    """Adds ``data`` to the first unsharded dim divisible by the data-axis
    size (on top of the leaf's tensor-parallel spec); replicates if no dim
    qualifies.  Divisibility keeps every shard an even block."""
    specs = list(base) + [None] * (len(shape) - len(base))
    for i, (s, dim) in enumerate(zip(specs, shape)):
        if s is None and dim >= data_size and dim % data_size == 0:
            specs[i] = "data"
            return tuple(specs)
    return tuple(specs)


def flax_leaf(name: str, shape) -> Tuple[str, tuple, tuple]:
    """(flax path, flax shape, perm) of the port parameter ``name`` of
    ``shape``: torch dim i is flax dim ``perm[i]``."""
    from blt_vqg_tpu_torch.convert import _flax_leaf
    mods, leaf, t = _flax_leaf(name, torch.empty(shape, device="meta"))
    n = len(shape)
    perm = tuple(range(n))
    if leaf == "kernel" and n == 2:
        perm = (1, 0)
    elif leaf == "kernel" and n == 4:
        perm = (3, 2, 0, 1)         # OIHW from HWIO
    return "/".join(mods + [leaf]), tuple(t.shape), perm


def _shapes(params) -> Dict[str, tuple]:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def param_sharding_rules(params, mesh, fsdp: bool = False) -> Dict[str, tuple]:
    """{port name: spec over the flax layout} for ``params`` (a module, or
    names to tensors or shapes); ``mesh`` needs only its ``shape``.
    ``fsdp=True`` adds ``data`` to the first free evenly divisible dim
    (the JAX package's ZeRO-3 spec)."""
    data_size = dict(mesh.shape).get("data", 1)
    out = {}
    for name, shape in _shapes(params).items():
        path, fshape, _ = flax_leaf(name, shape)
        spec = _mesh_filtered(spec_for_param(path, len(fshape)), mesh)
        if fsdp and len(fshape) >= 1 and data_size > 1:
            spec = _zero1_spec(spec, fshape, data_size)
        out[name] = spec
    return out


def opt_state_sharding_rules(opt_state, mesh) -> Dict[str, Any]:
    """ZeRO-1 specs of a ``FusedAdamState``, as the JAX function gives them
    for its tree: ``{"count": (), "mu": {name: spec}, "nu": {name: spec or
    FactoredNu(spec_r, spec_c)}, "master": {...}}``, over the flax layout
    of each leaf (a factored moment's pair in the port's order: the port's
    ``r`` of a Dense kernel is the JAX ``c``; both are vectors)."""
    from blt_vqg_tpu_torch.train.fused_adam import FactoredNu
    data_size = dict(mesh.shape).get("data", 1)

    def leaf(name, t):
        if t.dim() == 0 or data_size == 1:
            return ()
        path, fshape, _ = flax_leaf(name, tuple(t.shape))
        base = _mesh_filtered(spec_for_param(path, len(fshape)), mesh)
        return _zero1_spec(base, fshape, data_size)

    def vec(t):
        return () if data_size == 1 else _zero1_spec((), tuple(t.shape),
                                                     data_size)

    out: Dict[str, Any] = {"count": ()}
    for field in ("mu", "nu", "master"):
        tree = {}
        for name, v in getattr(opt_state, field).items():
            tree[name] = (FactoredNu(vec(v.r), vec(v.c))
                          if isinstance(v, FactoredNu) else leaf(name, v))
        out[field] = tree
    return out


def batch_sharding(mesh, ndim: int = 2) -> tuple:
    """Leading-axis data sharding for a batch tensor of rank ``ndim``,
    over both data axes on a hybrid mesh (``dcn_data`` outer)."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    return (axes,) + (None,) * (ndim - 1)


def replicate(tree: Any, mesh) -> Any:
    """Every rank holds the whole of ``tree`` already (each process builds
    it from the same seed): nothing moves."""
    del mesh
    return tree


def to_torch(spec: tuple, perm: tuple) -> tuple:
    """A spec over the flax layout -> over the torch layout."""
    spec = tuple(spec) + (None,) * (len(perm) - len(spec))
    return tuple(spec[perm[i]] for i in range(len(perm)))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _zdim(spec: tuple) -> Optional[int]:
    for i, e in enumerate(spec):
        if "data" in _axes(e):
            return i
    return None


def _drop_data(spec: tuple) -> tuple:
    return tuple(None if e is not None and "data" in _axes(e) else e
                 for e in spec)


class Placement:
    """A rank's share of a train state on ``mesh`` (a mesh across
    processes): the tensor-parallel split of every weight, the FSDP
    split of its storage (``fsdp``) and the ZeRO-1 split of the optimizer
    state (``zero``, implied by ``fsdp``).  Specs here are over the torch
    layout; ``tp`` holds the compute layout, ``store`` the layout between
    steps."""

    def __init__(self, mesh, model: torch.nn.Module, fsdp: bool = False,
                 zero: bool = False):
        self.mesh, self.fsdp = mesh, bool(fsdp)
        self.zero = bool(zero) or self.fsdp
        self.full_shapes = _shapes(model)
        data = mesh.shape.get("data", 1)
        self.tp: Dict[str, tuple] = {}
        self.store: Dict[str, tuple] = {}
        self.opt: Dict[str, tuple] = {}
        for name, shape in self.full_shapes.items():
            path, fshape, perm = flax_leaf(name, shape)
            base = _mesh_filtered(spec_for_param(path, len(fshape)), mesh)
            self.tp[name] = to_torch(base, perm)
            zspec = (_zero1_spec(base, fshape, data) if data > 1
                     else base)
            self.store[name] = to_torch(zspec if self.fsdp else base, perm)
            self.opt[name] = to_torch(zspec if self.zero else base, perm)

    # ---- blocks and gathers along a spec ------------------------------
    def local(self, t: torch.Tensor, spec: tuple,
              only: Optional[tuple] = None) -> torch.Tensor:
        """This rank's block of the whole ``t`` (over the axes ``only``,
        or all of the spec's)."""
        for d, e in enumerate(spec):
            axes = tuple(a for a in _axes(e) if only is None or a in only)
            index, count = self.mesh.coord(*axes)
            if count > 1:
                start, stop = col.block(t.shape[d], count, index)
                t = t.narrow(d, start, stop - start)
        return t

    def index(self, spec: tuple, shape) -> list:
        """[(start, stop)] of this rank's block of a tensor of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            index, count = self.mesh.coord(*_axes(spec[d]) if d < len(spec)
                                           else ())
            out.append(col.block(n, count, index) if count > 1 else (0, n))
        return out

    def gather(self, t: torch.Tensor, spec: tuple, full_shape,
               only: Optional[tuple] = None) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block (a
        collective over the spec's axes, or ``only`` them)."""
        for d, e in enumerate(spec):
            axes = tuple(a for a in _axes(e) if only is None or a in only)
            group = self.mesh.group(*axes)
            if group is not None:
                t = col.gather_dim(t, group, d, full_shape[d])
        return t

    def _tp_shape(self, name: str) -> tuple:
        return tuple(self.local(torch.empty(self.full_shapes[name],
                                            device="meta"),
                                self.tp[name]).shape)

    # ---- the model ----------------------------------------------------
    @torch.no_grad()
    def place_model(self, model: torch.nn.Module) -> None:
        """Cuts every weight of the whole ``model`` to this rank's block
        and switches the modules to their split forms."""
        from blt_vqg_tpu_torch.ops.attention import MultiHeadAttention
        from blt_vqg_tpu_torch.ops.layers import Dense, TensorSplit
        from blt_vqg_tpu_torch.ops.moe import MoEFeedForward
        mesh = self.mesh
        mgroup = mesh.group("model")
        m = mesh.shape.get("model", 1)
        for mod_name, mod in model.named_modules():
            pre = mod_name + "." if mod_name else ""
            if isinstance(mod, Dense) and pre + "weight" in self.tp:
                spec = self.tp[pre + "weight"]
                out_f = self.full_shapes[pre + "weight"][0]
                if spec[0] == "model":
                    vocab = _VOCAB_RE.search(flax_leaf(
                        pre + "weight", self.full_shapes[pre + "weight"])[0])
                    if not vocab and out_f % m:
                        raise ValueError(f"{pre}weight: {out_f} output "
                                         f"features over model={m}")
                    mod.tp = TensorSplit("vocab" if vocab else "col", mgroup,
                                         out_f)
                elif len(spec) > 1 and spec[1] == "model":
                    mod.tp = TensorSplit("row", mgroup, out_f)
            elif isinstance(mod, MultiHeadAttention) and m > 1:
                if mod.num_heads % m:
                    raise ValueError(f"{mod_name}: {mod.num_heads} heads over "
                                     f"model={m}")
                mod.num_heads //= m
            elif isinstance(mod, MoEFeedForward):
                x = mesh.shape.get("expert", 1)
                if x > 1:
                    if mod.num_experts % x:
                        raise ValueError(f"{mod_name}: {mod.num_experts} "
                                         f"experts over expert={x}")
                    index, _ = mesh.coord("expert")
                    mod.expert_split = (mesh.group("expert"),
                                        index * (mod.num_experts // x))
                if m > 1:
                    if mod.expert_in.shape[-1] % m:
                        raise ValueError(f"{mod_name}: FFN width over "
                                         f"model={m}")
                    mod.model_group = mgroup
        for name, p in model.named_parameters():
            p.data = self.local(p.data, self.store[name]).clone()

    def _fsdp_params(self, model):
        return [(n, p) for n, p in model.named_parameters()
                if _zdim(self.store[n]) is not None]

    @contextlib.contextmanager
    def unsharded(self, model: torch.nn.Module):
        """Under FSDP: the parameters gathered over ``data`` to their
        compute layout for the enclosed step, cut back after it (the
        optimizer writes its slices into the gathered tensors).  The whole
        model is gathered at once, not layer by layer."""
        if not self.fsdp:
            yield
            return
        group = self.mesh.group("data")
        params = self._fsdp_params(model)
        for n, p in params:
            d = _zdim(self.store[n])
            p.data = col.gather_dim(p.data, group, d, self._tp_shape(n)[d])
        try:
            yield
        finally:
            for n, p in params:
                p.data = col.local_block(p.data, group,
                                         _zdim(self.store[n])).clone()

    def full_state_dict(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The whole ``state_dict`` (a collective: every rank calls it)."""
        sd = model.state_dict()
        out = {}
        for name, t in sd.items():
            out[name] = (self.gather(t, self.store[name],
                                     self.full_shapes[name])
                         if name in self.store else t)
        return out

    # ---- the optimizer state ------------------------------------------
    def vec_spec(self, t_shape) -> tuple:
        data = self.mesh.shape.get("data", 1)
        if not self.zero or data == 1:
            return (None,) * len(t_shape)
        return _zero1_spec((), tuple(t_shape), data)

    def factored_shapes(self, name):
        shape = self.full_shapes[name]
        return shape[:-1], shape[:-2] + shape[-1:]

    def opt_specs(self, opt_state) -> Dict[str, Any]:
        """{field: {name: torch spec, or (spec_r, spec_c)}} of the leaves
        as this placement holds them."""
        from blt_vqg_tpu_torch.train.fused_adam import FactoredNu
        out = {}
        for field in ("mu", "nu", "master"):
            tree = {}
            for name, v in getattr(opt_state, field).items():
                if isinstance(v, FactoredNu):
                    rs, cs = self.factored_shapes(name)
                    tree[name] = FactoredNu(self.vec_spec(rs),
                                            self.vec_spec(cs))
                else:
                    tree[name] = self.opt[name]
            out[field] = tree
        return out

    def place_opt(self, opt_state, whole: bool = True):
        """Cuts an optimizer state to this rank's blocks: from the whole
        state (``whole``), or from one whose leaves follow the
        tensor-parallel split (made from the placed model)."""
        from blt_vqg_tpu_torch.train.fused_adam import (FactoredNu,
                                                        FusedAdamState)
        specs = self.opt_specs(opt_state)
        fields = {}
        for field in ("mu", "nu", "master"):
            tree = {}
            for name, v in getattr(opt_state, field).items():
                spec = specs[field][name]
                if isinstance(v, FactoredNu):
                    tree[name] = FactoredNu(self.local(v.r, spec.r).clone(),
                                            self.local(v.c, spec.c).clone())
                else:
                    only = None if whole else ("data",)
                    tree[name] = self.local(v, spec, only).clone()
            fields[field] = tree
        return FusedAdamState(opt_state.count, **fields)

    def fresh_opt(self, tx, model: torch.nn.Module, master: dict):
        """Zero moments for the placed model (the Adam restart), keeping
        ``master``."""
        from blt_vqg_tpu_torch.train.fused_adam import FactoredNu
        with self.unsharded(model):
            new = tx.init(dict(model.named_parameters()))
        # a factored moment's vectors are whole over the tensor axes
        nu = {n: (FactoredNu(
            torch.zeros(self.factored_shapes(n)[0], dtype=v.r.dtype,
                        device=v.r.device),
            torch.zeros(self.factored_shapes(n)[1], dtype=v.c.dtype,
                        device=v.c.device))
            if isinstance(v, FactoredNu) else v) for n, v in new.nu.items()}
        new = self.place_opt(new._replace(nu=nu), whole=False)
        return new._replace(master=master)

    def full_opt(self, opt_state):
        """The whole optimizer state (a collective)."""
        from blt_vqg_tpu_torch.train.fused_adam import (FactoredNu,
                                                        FusedAdamState)
        specs = self.opt_specs(opt_state)
        fields = {}
        for field in ("mu", "nu", "master"):
            tree = {}
            for name, v in getattr(opt_state, field).items():
                spec = specs[field][name]
                if isinstance(v, FactoredNu):
                    rs, cs = self.factored_shapes(name)
                    tree[name] = FactoredNu(self.gather(v.r, spec.r, rs),
                                            self.gather(v.c, spec.c, cs))
                else:
                    tree[name] = self.gather(v, spec, self.full_shapes[name])
            fields[field] = tree
        return FusedAdamState(opt_state.count, **fields)

    # ---- what the optimizer asks (train/fused_adam.py) -----------------
    def zero_local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The ZeRO slice of a tensor in the compute layout of ``name``."""
        return self.local(t, self.opt[name], only=("data",))

    def zero_write(self, name: str, p: torch.Tensor,
                   new: torch.Tensor) -> None:
        """Stores the updated slice ``new`` of parameter ``p``: into its
        block under FSDP (the step cuts the rest away), else gathered over
        ``data`` into the whole parameter."""
        d = _zdim(self.opt[name])
        if d is None:
            p.copy_(new)
        elif self.fsdp:
            self.zero_local(name, p).copy_(new)
        else:
            p.copy_(col.gather_dim(new, self.mesh.group("data"), d,
                                   p.shape[d]))

    def factored_sums(self, name: str, g2: torch.Tensor):
        """(row sums, column sums) of the whole squared gradient, from this
        rank's block ``g2``: summed over the tensor axes where the summed
        dim is split, gathered where a kept one is."""
        spec = _drop_data(self.tp[name])
        full = self.full_shapes[name]

        def whole(s, sum_dim):
            kept = spec[:sum_dim] + spec[sum_dim + 1:]
            kept_shape = full[:sum_dim] + full[sum_dim + 1:]
            s = col.all_reduce(s, self.mesh.group(*_axes(spec[sum_dim])))
            return self.gather(s, kept, kept_shape)

        nd = g2.dim()
        return whole(g2.sum(dim=-1), nd - 1), whole(g2.sum(dim=-2), nd - 2)

    def tp_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The tensor-parallel block of a whole-shaped ``t`` of ``name``."""
        return self.local(t, _drop_data(self.tp[name]))

    def owned(self, name: str) -> bool:
        """True on the one rank of each tensor-parallel group that counts
        this parameter's gradient in the global norm: coordinate 0 along
        every tensor axis the parameter is whole over."""
        split = {a for e in self.tp[name] for a in _axes(e)}
        return all(self.mesh.coords.get(a, 0) == 0
                   for a in TP_AXES if a not in split)

    def global_norm(self, grads, names) -> torch.Tensor:
        """The global L2 norm of the gradients, each counted once across
        the tensor-parallel ranks (every rank gets the same value)."""
        from blt_vqg_tpu_torch.train.fused_adam import global_norm
        group = self.mesh.group(*TP_AXES)
        if group is None:
            return global_norm(grads, names)
        total = None
        for n in names:
            g = grads.get(n)
            if g is not None and self.owned(n):
                s = torch.sum(torch.square(g.float()))
                total = s if total is None else total + s
        if total is None:
            device = next(iter(grads.values())).device
            total = torch.zeros((), dtype=torch.float32, device=device)
        return torch.sqrt(col.all_reduce(total, group))


def place_state(state, mesh, fsdp: bool = False, zero: bool = False):
    """Places a whole train state (built, grafted or restored whole on
    every rank) on ``mesh``: the model cut by the rules, the optimizer
    state with it.  A mesh of one process leaves the state as it is."""
    if mesh is None or not mesh.across_processes:
        return state
    placement = Placement(mesh, state.model, fsdp=fsdp, zero=zero)
    placement.place_model(state.model)
    state.opt_state = placement.place_opt(state.opt_state)
    state.placement = placement
    return state


def shard_params(params, mesh, fsdp: bool = False):
    """The rank's blocks of whole ``params`` ({name: tensor}) by the
    rules, in the torch layout."""
    if mesh is None or not mesh.across_processes:
        return params
    specs = param_sharding_rules(params, mesh, fsdp)
    out = {}
    for name, t in params.items():
        perm = flax_leaf(name, tuple(t.shape))[2]
        spec = to_torch(specs[name], perm)
        for d, e in enumerate(spec):
            index, count = mesh.coord(*_axes(e))
            if count > 1:
                start, stop = col.block(t.shape[d], count, index)
                t = t.narrow(d, start, stop - start)
        out[name] = t
    return out
