"""Loss assembly (counterpart of ``blt_vqg_tpu/train/losses.py``).

Phase 1 (pretrain):   loss = rec + image_recon_lambda * img
Phase 2 (latent):     loss = rec + kl_ceiling * kl_weight(kliter) * kld
                             + aux_ceiling * aux + image_recon_lambda * img
rec is token cross-entropy ignoring <pad>, img the MSE between the image
features and their reconstruction, aux the z-classifier's CE against every
non-pad target token, kl_weight the tanh anneal
``min(tanh(6 * kliter / full_kl_step - 3) + 1, 1)``; ppl = exp(min(rec, 100)).
Every value is a tensor on the logits' device: nothing syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

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
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


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
    img = torch.mean(torch.square(feat.float() - recon.float()))
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
