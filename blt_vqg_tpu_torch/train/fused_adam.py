"""Global-norm clip + Adam + learning rate + parameter update (counterpart of
``blt_vqg_tpu/train/fused_adam.py``).

The JAX package writes the whole update as one expression per parameter,
which XLA fuses into one read-modify-write pass per tensor; it is not a
Pallas kernel.  Here the same expression runs as plain tensor operations,
in the same order and with the same dtype promotions, so the numbers match
operation for operation: the optax clip trigger ``g_norm < clip`` as a
select, the safely incremented step count, ``1 - b**count`` bias
correction in f32, the moment EMAs as ``(1 - b) * g + b * m``, eps outside
the square root, then ``lr * u`` subtracted from the parameter.

Parameters are named as in the model's ``state_dict`` and updated in place.
Frozen parameters carry no moments (they are absent from ``mu``/``nu``,
where the JAX state holds ``optax.MaskedNode``).  Also as in the JAX
package: bf16 first moments (``mu_dtype``), f32 master copies of
parameters stored in bf16 (``master_fn``), and the Adafactor-style factored
second moment (``factored_nu``) of every trainable parameter of two or more
dimensions.  The factored moment is taken over the port's own layout, in
which Dense weights are the transpose of the JAX kernels, so its (r, c)
pair is the JAX pair swapped there (``convert.py`` swaps them back).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

INT32_MAX = 2 ** 31 - 1


class FactoredNu(NamedTuple):
    """Row and column EMAs of g^2 for one parameter of two or more dims:
    ``r`` summed over the last dim, ``c`` over the second-to-last."""

    r: torch.Tensor
    c: torch.Tensor


class FusedAdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, object]          # tensor or FactoredNu
    master: Dict[str, torch.Tensor]


def _weak(c: float, t: torch.Tensor) -> float:
    """The Python scalar ``c`` rounded to ``t``'s dtype first, as JAX treats
    a weakly typed scalar: b1 * mu with bf16 moments multiplies by
    bf16(0.9), not by 0.9."""
    return float(torch.tensor(c, dtype=t.dtype))


def global_norm(grads: Mapping[str, Optional[torch.Tensor]],
                names) -> torch.Tensor:
    """The global L2 norm in f32 of ``grads`` over ``names`` (the trainable
    parameters); a missing gradient counts as zero."""
    total = 0
    for n in names:
        if grads.get(n) is not None:
            total = total + torch.sum(torch.square(grads[n].float()))
    return torch.sqrt(total)


class FusedClipAdam:
    def __init__(self, grad_clip: float, frozen_fn: Callable[[str], bool],
                 mu_dtype=torch.float32, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 master_fn: Optional[Callable[[str], bool]] = None,
                 factored_nu: bool = False):
        self.grad_clip = float(grad_clip)
        self.frozen_fn = frozen_fn
        self.mu_dtype = mu_dtype
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.master_fn = master_fn
        self.factored_nu = bool(factored_nu)

    def _is_master(self, name: str) -> bool:
        return (self.master_fn is not None and not self.frozen_fn(name)
                and self.master_fn(name))

    def init(self, params: Mapping[str, torch.Tensor]) -> FusedAdamState:
        """Zero moments for every trainable parameter.  Call with the
        full-precision parameters: masters are snapshotted from them."""
        mu, nu, master = {}, {}, {}
        for name, p in params.items():
            if self.frozen_fn(name):
                continue
            mastered = self._is_master(name)
            mu[name] = torch.zeros_like(p, dtype=self.mu_dtype)
            if self.factored_nu and p.dim() >= 2:
                nu[name] = FactoredNu(
                    torch.zeros(p.shape[:-1], dtype=torch.float32,
                                device=p.device),
                    torch.zeros(p.shape[:-2] + p.shape[-1:],
                                dtype=torch.float32, device=p.device))
            else:
                nu[name] = torch.zeros_like(
                    p, dtype=torch.float32 if mastered else p.dtype)
            if mastered:
                master[name] = p.detach().float().clone()
        return FusedAdamState(0, mu, nu, master)

    @torch.no_grad()
    def cast_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """bf16 storage, in place, for every mastered or frozen parameter
        (``param_dtype="bfloat16"``); nothing without ``master_fn``."""
        if self.master_fn is None:
            return
        for name, p in params.items():
            if self._is_master(name) or self.frozen_fn(name):
                p.data = p.data.to(torch.bfloat16)

    @torch.no_grad()
    def update_params(self, params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, Optional[torch.Tensor]],
                      state: FusedAdamState, lr: float
                      ) -> Tuple[FusedAdamState, torch.Tensor]:
        """One update of ``params`` in place; returns (the new state, the
        global gradient norm over the trainable parameters).  A missing
        gradient is a zero gradient (a parameter the phase did not use)."""
        b1, b2, eps, clip = self.b1, self.b2, self.eps, self.grad_clip
        names = list(state.mu)
        gs = {n: (grads.get(n) if grads.get(n) is not None
                  else torch.zeros_like(params[n])) for n in names}
        g_norm = global_norm(gs, names)
        trigger = g_norm < clip

        count = state.count + 1 if state.count < INT32_MAX else state.count
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)

        mu_new, nu_new, master_new = {}, {}, dict(state.master)
        for n in names:
            p, mu, nu = params[n], state.mu[n], state.nu[n]
            mastered = n in state.master
            g = gs[n].float() if mastered else gs[n]
            gc = torch.where(trigger, g, (g / g_norm.to(g.dtype)) * clip)
            mu32 = (1 - b1) * gc + _weak(b1, mu) * mu
            mu_hat = mu32 / bc1
            if isinstance(nu, FactoredNu):
                g2 = gc.float() ** 2
                r1 = b2 * nu.r + (1 - b2) * g2.sum(dim=-1)
                c1 = b2 * nu.c + (1 - b2) * g2.sum(dim=-2)
                denom = torch.clamp_min(r1.sum(dim=-1)[..., None, None],
                                        1e-30)
                nu_hat = r1[..., :, None] * c1[..., None, :] / denom / bc2
                nu1 = FactoredNu(r1, c1)
            else:
                nu1 = (1 - b2) * (gc ** 2) + _weak(b2, nu) * nu
                nu_hat = nu1 / bc2
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            step = (lr * u.float()).to(u.dtype)
            if mastered:
                ms1 = state.master[n] - step
                p.copy_(ms1.to(p.dtype))
                master_new[n] = ms1
            else:
                p.copy_((p - step).to(p.dtype))
            mu_new[n] = mu32.to(self.mu_dtype)
            nu_new[n] = nu1
        return FusedAdamState(count, mu_new, nu_new, master_new), g_norm
