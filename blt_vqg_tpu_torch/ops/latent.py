"""Variational latent module (counterpart of ``blt_vqg_tpu/ops/latent.py``).

A prior net hidden→2·latent and a posterior net 2·hidden→2·latent, each a
3-Linear MLP with ReLUs (dropout after each ReLU, rate 0 by default, as in
the JAX package), reparameterized sampling and the Gaussian KL.  The noise
is either injected (``eps``) or drawn from an explicit ``torch.Generator``;
the JAX package draws it from a flax RNG stream, so tests hand both
packages the same eps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.layers import Dense, dropout
from blt_vqg_tpu_torch.parallel import collectives as col


def gaussian_kld(mu_q, logvar_q, mu_p, logvar_p) -> torch.Tensor:
    """KL(q || p) for diagonal Gaussians, summed over the last dim."""
    mu_q, logvar_q = mu_q.float(), logvar_q.float()
    mu_p, logvar_p = mu_p.float(), logvar_p.float()
    return -0.5 * torch.sum(
        1.0 + (logvar_q - logvar_p)
        - torch.square(mu_p - mu_q) / torch.exp(logvar_p)
        - torch.exp(logvar_q) / torch.exp(logvar_p),
        dim=-1)


class _MeanLogvarNet(nn.Module):
    """Linear(in→2L) then 2×(ReLU→Dropout→Linear(2L→2L))."""

    def __init__(self, in_dim: int, latent_dim: int, dtype,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.in_proj = Dense(in_dim, 2 * latent_dim, dtype=dtype)
        self.hidden_0 = Dense(2 * latent_dim, 2 * latent_dim, dtype=dtype)
        self.hidden_1 = Dense(2 * latent_dim, 2 * latent_dim, dtype=dtype)
        self.dropout_rate = dropout_rate

    def forward(self, x, generator=None):
        h = self.in_proj(x)
        for layer in (self.hidden_0, self.hidden_1):
            h = layer(dropout(torch.relu(h), self.dropout_rate, generator))
        return h


class Latent(nn.Module):
    def __init__(self, hidden_dim: int, latent_dim: int,
                 dtype=torch.bfloat16, dropout_rate: float = 0.0):
        super().__init__()
        self.latent_dim, self.dtype = latent_dim, dtype
        self.prior = _MeanLogvarNet(hidden_dim, latent_dim, dtype,
                                    dropout_rate)
        self.posterior = _MeanLogvarNet(2 * hidden_dim, latent_dim, dtype,
                                        dropout_rate)

    def forward(self, x: torch.Tensor, x_p: Optional[torch.Tensor],
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                use_mean: bool = False, train: bool = False):
        """x [B, H] context summary; x_p [B, H] posterior summary or None.

        Returns (kld, z [B, latent] in ``dtype``, (mean_post, logvar_post)).
        With ``x_p`` None, z comes from the prior and kld is 0.  ``eps``
        [B, latent] f32 is drawn from ``generator`` when not given;
        ``use_mean`` zeroes it (the distribution mean).  ``train`` draws the
        dropout from ``generator`` too.
        """
        drop = generator if train else None
        ml_prior = self.prior(x, drop)
        mean_prior = ml_prior[:, :self.latent_dim]
        logvar_prior = ml_prior[:, self.latent_dim:]
        if eps is None:
            eps = col.draw(torch.randn, mean_prior.shape, generator,
                           x.device, dtype=torch.float32)
        if use_mean:
            eps = torch.zeros_like(eps)
        eps = eps.float()

        if x_p is None:
            std = torch.exp(0.5 * logvar_prior.float())
            z = eps * std + mean_prior.float()
            kld = torch.zeros((), dtype=torch.float32, device=x.device)
            return kld, z.to(self.dtype), (None, None)

        ml_post = self.posterior(torch.cat([x_p, x], dim=-1), drop)
        mean_post = ml_post[:, :self.latent_dim]
        logvar_post = ml_post[:, self.latent_dim:]
        kld = col.batch_mean(gaussian_kld(mean_post, logvar_post,
                                          mean_prior, logvar_prior))
        std = torch.exp(0.5 * logvar_post.float())
        z = eps * std + mean_post.float()
        return kld, z.to(self.dtype), (mean_post, logvar_post)

    def stats(self, x: torch.Tensor, x_p: torch.Tensor) -> dict:
        """Distribution diagnostics of the latent (eval mode, no noise):
        ``kl_per_dim`` [L], the batch mean of the per-dim KL(q || p);
        ``prior_logvar`` and ``post_logvar``, the mean log-variances;
        ``prior_mean_var``, the variance of the prior mean across the batch
        (about 0: the prior ignores its input); ``mean_gap``,
        E[(mu_q - mu_p)^2].  All f32."""
        ml_prior = self.prior(x)
        mu_p = ml_prior[:, :self.latent_dim].float()
        lv_p = ml_prior[:, self.latent_dim:].float()
        ml_post = self.posterior(torch.cat([x_p, x], dim=-1))
        mu_q = ml_post[:, :self.latent_dim].float()
        lv_q = ml_post[:, self.latent_dim:].float()
        kl_dim = -0.5 * (1.0 + (lv_q - lv_p)
                         - torch.square(mu_p - mu_q) / torch.exp(lv_p)
                         - torch.exp(lv_q) / torch.exp(lv_p))     # [B, L]
        return {
            "kl_per_dim": torch.mean(kl_dim, dim=0),
            "prior_logvar": torch.mean(lv_p),
            "post_logvar": torch.mean(lv_q),
            "prior_mean_var": torch.mean(torch.var(mu_p, dim=0, correction=0)),
            "mean_gap": torch.mean(torch.square(mu_q - mu_p)),
        }
