"""Loss assembly (counterpart of ``blt_vqg_tpu/train/losses.py``).

Phase 1 (pretrain):   loss = rec + image_recon_lambda * img
Phase 2 (latent):     loss = rec + kl_ceiling * kl_weight(kliter) * kld
                             + aux_ceiling * aux + image_recon_lambda * img
rec is token cross-entropy ignoring <pad>, img the MSE between the image
features and their reconstruction, aux the z-classifier's CE against every
non-pad target token, kl_weight the tanh anneal
``min(tanh(6 * kliter / full_kl_step - 3) + 1, 1)``; ppl = exp(min(rec, 100)).
Every value is a tensor on the logits' device: nothing syncs with the host.
In a sharded step (``parallel/collectives.py`` ``active``) every mean is
over the global batch: a masked mean sums its numerator and its count of
non-pad tokens over the batch shards before it divides, as the JAX package
divides by the global count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from blt_vqg_tpu_torch.parallel import collectives as col

PAD_ID = 0


class LossOutputs(NamedTuple):
    loss: torch.Tensor
    rec: torch.Tensor
    img: torch.Tensor
    ppl: torch.Tensor
    kld: torch.Tensor
    aux: torch.Tensor
    elbo: torch.Tensor

    def as_dict(self):
        return self._asdict()


def _masked_mean(ce: torch.Tensor, targets: torch.Tensor,
                 pad_id: int) -> torch.Tensor:
    mask = (targets != pad_id).float()
    return (col.batch_sum((ce * mask).sum())
            / col.batch_sum(mask.sum()).clamp_min(1.0))


def masked_token_ce(logits: torch.Tensor, targets: torch.Tensor,
                    pad_id: int = PAD_ID) -> torch.Tensor:
    """Mean cross-entropy over non-pad target tokens."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(ce, targets, pad_id)


def broadcast_token_ce(z_logit: torch.Tensor, targets: torch.Tensor,
                       pad_id: int = PAD_ID) -> torch.Tensor:
    """Mean CE of one logit row per example against every non-pad target
    token of that example, without the [B, T, V] broadcast: the logsumexp
    is taken once per example (stabilised by a max that carries no
    gradient) and the label logits are gathered."""
    z = z_logit.float()
    zmax = z.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(z - zmax).sum(dim=-1)) + zmax[:, 0]     # [B]
    picked = z.gather(1, targets.long())                               # [B, T]
    return _masked_mean(lse[:, None] - picked, targets, pad_id)


def gaussian_kl_to_unit(mus: torch.Tensor, logvars: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """KL to the unit normal, summed and divided by the batch size (plus
    ``eps``), in f32."""
    mus, logvars = mus.float(), logvars.float()
    kld = -0.5 * torch.sum(1.0 + logvars - torch.square(mus)
                           - torch.exp(logvars))
    return kld / (mus.shape[0] + eps)


def vae_loss(logits: torch.Tensor, targets: torch.Tensor, mus: torch.Tensor,
             logvars: torch.Tensor, pad_id: int = PAD_ID) -> torch.Tensor:
    """Token cross-entropy plus the KL to the unit normal."""
    return masked_token_ce(logits, targets, pad_id) + gaussian_kl_to_unit(
        mus, logvars)


def sequence_lengths(tokens: torch.Tensor,
                     pad_id: int = PAD_ID) -> torch.Tensor:
    """The non-pad tokens of each row."""
    return torch.sum(tokens != pad_id, dim=1)


def two_gaussian_kl(mu1: torch.Tensor, logvar1: torch.Tensor,
                    mu2: torch.Tensor, logvar2: torch.Tensor) -> torch.Tensor:
    """KL between two diagonal Gaussians with the JAX function's epsilons
    and its sum-then-divide reduction:
    ``0.5 * sum(logvar2 - logvar1 + (exp(logvar1) + (mu1 - mu2)^2)
    / (exp(logvar2) + 1e-8) - 1) / (B + 1e-8)``."""
    num = torch.exp(logvar1) + torch.square(mu1 - mu2)
    frac = num / (torch.exp(logvar2) + 1e-8)
    kl = 0.5 * torch.sum(logvar2 - logvar1 + frac - 1.0)
    return kl / (mu1.shape[0] + 1e-8)


def kl_weight_schedule(kliter: int, full_kl_step: int) -> torch.Tensor:
    """tanh KL anneal, computed in f32."""
    k = torch.tensor(float(kliter), dtype=torch.float32)
    return torch.clamp_max(torch.tanh(6.0 * k / full_kl_step - 3.0) + 1.0,
                           1.0)


def compute_losses(logits: torch.Tensor, targets: torch.Tensor,
                   image_recon: tuple, kld: torch.Tensor,
                   z_logit: Optional[torch.Tensor], kliter: int,
                   latent_mode: bool, kl_ceiling: float, aux_ceiling: float,
                   image_recon_lambda: float, full_kl_step: int,
                   kl_floor: float = 0.0) -> LossOutputs:
    rec = masked_token_ce(logits, targets)
    feat, recon = image_recon
    img = col.batch_mean(torch.square(feat.float() - recon.float()))
    ppl = torch.exp(torch.clamp_max(rec, 100.0))

    if not latent_mode:
        zero = torch.zeros((), dtype=torch.float32, device=rec.device)
        return LossOutputs(loss=rec + image_recon_lambda * img, rec=rec,
                           img=img, ppl=ppl, kld=zero, aux=zero, elbo=rec)

    aux = broadcast_token_ce(z_logit, targets)
    kl_w = kl_weight_schedule(kliter, full_kl_step)   # a CPU scalar
    elbo = rec + kld
    # free-bits floor on the total KL; kl_floor = 0 is the plain objective
    kl_term = torch.clamp_min(kld, kl_floor) if kl_floor > 0.0 else kld
    loss = (rec + kl_ceiling * kl_w * kl_term + aux_ceiling * aux
            + image_recon_lambda * img)
    return LossOutputs(loss=loss, rec=rec, img=img, ppl=ppl, kld=kld,
                       aux=aux, elbo=elbo)
