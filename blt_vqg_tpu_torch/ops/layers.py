"""The flax layers the JAX package builds on, as PyTorch modules.

Each keeps flax's numerics where they differ from torch's defaults:

- ``Dense``/``Conv``/``Embed`` store their parameters in f32 (the JAX
  package's ``param_dtype="float32"``) and compute in ``dtype``.  flax casts
  the kernel to ``dtype`` at every call; :func:`cast_to_compute_dtype_` does
  the same cast once after loading, which is the same arithmetic.
- ``LayerNorm`` uses eps 1e-6 (flax) and f32 statistics, then casts to
  ``dtype``.
- ``BatchNorm`` normalises in f32 with eps 1e-5, then casts to ``dtype``:
  with its running statistics in eval mode, with the batch's in train mode
  (variance as E[x^2] - E[x]^2 clipped at 0, flax's fast variance), where it
  also updates the running statistics flax's way, new = momentum * old +
  (1 - momentum) * batch, with the *biased* batch variance.
- :func:`dropout` is flax's ``nn.Dropout``: keep with probability 1 - rate,
  scale the kept values by 1 / (1 - rate), in the input dtype.  Its bits come
  from an explicit ``torch.Generator``; no generator means deterministic.
- ``init_std`` on each layer is the standard deviation of the normal draw
  that seed-made weights use (flax's initializer scale, not its exact draw).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ W.T + b, ``weight`` is [out, in]."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.bfloat16,
                 init_std: float | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)
        self.compute_dtype = dtype
        # flax's default kernel init is LeCun normal: variance 1/fan_in
        self.init_std = (init_std if init_std is not None
                         else 1.0 / math.sqrt(in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias on NCHW tensors, ``weight`` OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.stride, self.padding = stride, padding
        self.compute_dtype = dtype
        self.init_std = 1.0 / math.sqrt(cin * kernel * kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is cast to ``dtype`` before the gather."""

    def __init__(self, num: int, features: int, dtype=torch.bfloat16,
                 init_std: float = 0.01):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, features))
        self.compute_dtype = dtype
        self.init_std = init_std

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.weight.to(self.compute_dtype))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype, self.eps = dtype, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """Batch norm over dim 1 ([B, C] or [B, C, H, W]); ``momentum`` is
    flax's (the weight of the old running statistic)."""

    def __init__(self, num_features: int, dtype=torch.bfloat16,
                 eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.dtype, self.eps, self.momentum = dtype, eps, momentum

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            mean, var = self.running_mean.float(), self.running_var.float()
        else:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(dim=axes)
            var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.float().view(
            shape)
        return y.to(self.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``; deterministic when ``rate`` is 0 or there is no
    ``generator``."""
    if rate == 0.0 or generator is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def cast_to_compute_dtype_(model: nn.Module) -> nn.Module:
    """Casts every Dense/Conv/Embed parameter to its compute dtype, in place
    (once, at load; the forward passes then cast nothing)."""
    for m in model.modules():
        if isinstance(m, (Dense, Conv, Embed)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(m.compute_dtype)
    return model


def cached(module: nn.Module, name: str, build, params=None):
    """``build()``, kept on ``module`` under ``name`` and rebuilt only when
    one of ``params`` (default: the module's own) was replaced (``.to()``, a
    dtype cast, a new ``.data``) or changed in place (``load_state_dict``,
    ``copy_``), which bumps its version counter.  The entry holds the
    storages it was built from, so no freed address can come back under the
    same key.  Parameters made under ``torch.inference_mode()`` keep no
    version counter, so for them nothing is kept and every call builds."""
    params = list(module.parameters() if params is None else params)
    if any(p.is_inference() for p in params):
        return build()
    key = [(p.data_ptr(), p._version) for p in params]
    entry = module.__dict__.get(name)
    if entry is None or entry[0] != key:
        entry = (key, [p.untyped_storage() for p in params], build())
        module.__dict__[name] = entry
    return entry[2]


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seed-made weights at the JAX initializers' scales: normal kernels
    with each layer's ``init_std``, zero biases, unit norm scales, and
    identity batch-norm statistics.  Draws on the CPU from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Dense, Conv, Embed)):
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w * m.init_std)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, (LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
