"""IQ-RNN, the seq2seq model family (counterpart of
``blt_vqg_tpu/models/iq_rnn.py``).

The forward contract of ``models/iq.py``'s IQ (so the train, eval and
decode steps take either), with LSTM or GRU stacks (``cfg.rnn_cell``,
``ops/rnn.py``) for the context and posterior encoders and the decoder.
The latent path matches the transformer's: prior and posterior nets over
the encoders' summaries (each row's output at its last non-pad token) plus
the image features, the reparameterized z, the KL; the decoder takes the
summary (+ the projected z) as its step-0 injection; the image features are
reconstructed from it, and z_logit comes from z + the image features.
Greedy decoding is the family's only decoder (no beam search).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.ops.latent import Latent
from blt_vqg_tpu_torch.ops.layers import Dense, init_weights_
from blt_vqg_tpu_torch.ops.mlp import MLP
from blt_vqg_tpu_torch.ops.resnet import EncoderCNN
from blt_vqg_tpu_torch.ops.rnn import RNNDecoder, RNNEncoder

PAD, START, END = 0, 1, 3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class IQRNN(nn.Module):
    def __init__(self, cfg: Config, vocab_size: int):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        dtype = self.dtype = _DTYPES[cfg.dtype]
        d = cfg.hidden_dim
        self.encoder_cnn = EncoderCNN(d, dtype)
        rnn_kw = dict(vocab_size=vocab_size, emb_dim=cfg.emb_dim,
                      hidden_size=d, num_layers=cfg.num_layers,
                      rnn_cell=cfg.rnn_cell, dtype=dtype)
        self.context_encoder = RNNEncoder(**rnn_kw)
        self.posterior_encoder = RNNEncoder(**rnn_kw)
        self.latent = Latent(d, cfg.latent_dim, dtype)
        self.latent_projection = Dense(cfg.latent_dim, d, dtype=dtype)
        self.decoder = RNNDecoder(**rnn_kw)
        self.z_classifier = Dense(d, vocab_size, dtype=torch.float32)
        self.image_reconstructor = MLP(d, cfg.pwffn_dim, d, num_layers=2,
                                       dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> "IQRNN":
        """Seed-made weights at the JAX initializers' scales."""
        return init_weights_(self, generator)

    def _summary(self, images, context, train: bool):
        image_features = self.encoder_cnn(images, train=train)
        _, ctx = self.context_encoder(context, PAD)
        return image_features, ctx + image_features.to(ctx.dtype)

    def forward(self, images: torch.Tensor, context: torch.Tensor,
                posterior: torch.Tensor, target: torch.Tensor,
                latent_mode: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                moe_losses: Optional[list] = None):
        """``(logits [B, T, V] f32, z_logit [B, V] f32 or None, kld f32,
        (image features, reconstruction) f32)``, as ``IQ.forward``; the
        posterior noise ``eps`` is drawn from ``generator`` unless given.
        ``moe_losses`` is taken for IQ's signature (the family has no MoE
        layer)."""
        del moe_losses
        image_features, ctx = self._summary(images, context, train)
        kld = torch.zeros((), dtype=torch.float32, device=images.device)
        z_proj = z_logit = None
        if latent_mode:
            _, post = self.posterior_encoder(posterior, PAD)
            kld, z, _ = self.latent(ctx, post, eps=eps, generator=generator,
                                    train=train)
            z_proj = self.latent_projection(z)
            z_logit = self.z_classifier((z_proj + image_features).float())

        inject = ctx if z_proj is None else ctx + z_proj
        b = target.shape[0]
        sos = torch.full((b, 1), START, dtype=target.dtype,
                         device=target.device)
        shifted = torch.cat([sos, target[:, :-1]], dim=1)
        logits = self.decoder.teacher_forced(shifted, init_context=inject)
        recon = self.image_reconstructor(inject)
        return logits, z_logit, kld, (image_features.float(), recon.float())

    def decode_greedy(self, images: torch.Tensor, context: torch.Tensor,
                      max_decode_length: int = 50, latent_mode: bool = False,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """Greedy questions: ``{"tokens": [B, max_decode_length + 1]}``; in
        the latent phase z is a prior sample (noise ``eps``, or drawn from
        ``generator``)."""
        _, ctx = self._summary(images, context, False)
        inject = ctx
        if latent_mode:
            _, z, _ = self.latent(ctx, None, eps=eps, generator=generator)
            inject = ctx + self.latent_projection(z)
        tokens = self.decoder.greedy(context.shape[0], max_decode_length + 1,
                                     START, init_context=inject,
                                     device=images.device)
        return {"tokens": tokens}
