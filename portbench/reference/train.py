"""The latent-phase training step in plain PyTorch, float32: the losses
of the two-phase IQ objective, the gradient of every trainable parameter
(all but the frozen image backbone), the global-norm clip and Adam on the
Noam learning-rate curve.

loss = rec + kl_ceiling * w(kliter) * kld + aux_ceiling * aux
       + image_recon_lambda * img
with rec the cross-entropy of the non-pad target tokens, aux the z head's
cross-entropy against every non-pad target token of its row, img the mean
squared error of the image-feature reconstruction and
w(k) = min(tanh(6 k / full_kl_step - 3) + 1, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.nn import functional as F

from portbench.reference.iq import PAD, RefIQ

FROZEN = "encoder_cnn.backbone."


def trainable(name: str) -> bool:
    return not name.startswith(FROZEN)


def noam_lr(step: int, hidden: int, warmup: int) -> float:
    return hidden ** -0.5 * min((step + 1) ** -0.5, step * warmup ** -1.5)


def kl_weight(kliter: int, full_kl_step: int) -> float:
    return min(math.tanh(6.0 * kliter / full_kl_step - 3.0) + 1.0, 1.0)


def losses(ref: RefIQ, batch: dict, eps, kliter: int, opt: dict) -> Dict:
    logits, z_logit, kld, feat, recon = ref.train_forward(batch, eps)
    target = batch["target"].long()
    keep = (target != PAD).float()
    ce = -F.log_softmax(logits, -1).gather(-1, target[..., None])[..., 0]
    rec = (ce * keep).sum() / keep.sum().clamp_min(1.0)
    lse = torch.logsumexp(z_logit, -1)
    aux_ce = lse[:, None] - z_logit.gather(1, target)
    aux = (aux_ce * keep).sum() / keep.sum().clamp_min(1.0)
    img = torch.mean((feat - recon) ** 2)
    loss = (rec + opt["kl_ceiling"] * kl_weight(kliter, opt["full_kl_step"])
            * kld + opt["aux_ceiling"] * aux + opt["image_recon_lambda"] * img)
    return {"loss": loss, "rec": rec, "kld": kld, "aux": aux, "img": img}


class RefTrainer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction) after a clip of the global gradient norm, over the
    trainable entries of ``params`` (updated in place).  ``step`` is the
    global step of the first update (the learning rate's clock), the KL
    anneal starts at ``kliter``."""

    def __init__(self, ref: RefIQ, opt: dict, step: int, kliter: int = 0):
        self.ref, self.opt = ref, opt
        self.step, self.kliter, self.count = step, kliter, 0
        self.names = [n for n in ref.p if trainable(n)
                      and not n.endswith(("running_mean", "running_var"))]
        for n in self.names:
            ref.p[n] = ref.p[n].detach().clone().requires_grad_(True)
        self.mu = {n: torch.zeros_like(ref.p[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(ref.p[n]) for n in self.names}

    def step_once(self, batch: dict, eps) -> Dict:
        """One training step; returns the float loss and the clipped
        gradients the update used, by name."""
        o = self.opt
        out = losses(self.ref, batch, eps, self.kliter, o)
        params = [self.ref.p[n] for n in self.names]
        grads = torch.autograd.grad(out["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if float(norm) >= o["grad_clip"]:
            grads = [g / norm * o["grad_clip"] for g in grads]
        self.count += 1
        lr = noam_lr(self.step, o["hidden_dim"], o["warmup_steps"])
        bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        with torch.no_grad():
            for n, p, g in zip(self.names, params, grads):
                self.mu[n] = 0.1 * g + 0.9 * self.mu[n]
                self.nu[n] = 0.001 * g * g + 0.999 * self.nu[n]
                u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + 1e-8)
                p -= lr * u
        self.step += 1
        self.kliter += 1
        return {"loss": float(out["loss"].detach()),
                "grads": dict(zip(self.names, (g.detach() for g in grads)))}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names: List[str]) -> tuple:
    """(the largest |got - want| over ``names``, each against the larger
    of its reference norm and the median leaf's, and that leaf)."""
    vals = sorted(want[n] for n in names)
    median = vals[len(vals) // 2]
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], median, 1e-30)
        if gap >= worst:
            worst, leaf = gap, n
    return worst, leaf
