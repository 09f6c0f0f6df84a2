"""The IQ model (counterpart of ``blt_vqg_tpu/models/iq.py``).

Every submodule of the JAX ``IQ.setup`` is built under the same name, so
every parameter of a JAX checkpoint has a home (``convert.py``).  Ported:
the training/validation forward (:meth:`IQ.forward`, both phases),
``embed_tokens``, ``encode_context``, KV-cache decoding on the plain, the
per-layer and the streaming decode paths (:meth:`IQ.decode_greedy`, greedy
or sampled, with the fused int8/bf16 head, every z source;
:meth:`IQ.decode_beam`), the full-prefix :meth:`IQ.inference_logits` and
``predict_from_answer``/``predict_from_category``.  ``latent_diagnostics``
is not ported yet (ROADMAP.md queue 1).

Random draws come from explicit ``torch.Generator``s, never from a JAX key:
the prior or posterior noise from ``generator`` (or injected as ``eps``),
sampled tokens from a separate ``sample_generator``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.ops.kernels import decode_head, decode_stream
from blt_vqg_tpu_torch.ops.latent import Latent
from blt_vqg_tpu_torch.ops.layers import Dense, Embed, cached, init_weights_
from blt_vqg_tpu_torch.ops.masks import pad_mask
from blt_vqg_tpu_torch.ops.mlp import MLP
from blt_vqg_tpu_torch.ops.resnet import EncoderCNN
from blt_vqg_tpu_torch.ops.sampling import sample_token
from blt_vqg_tpu_torch.ops.transformer import (TransformerDecoder,
                                               TransformerEncoder)

PAD, START, END, UNK = 0, 1, 3, 4  # reserved ids (text/vocabulary.py contract)
Z_SOURCES = ("prior_sample", "prior_mean", "posterior_sample",
             "posterior_mean")
BEAM_NEG = -1e9    # score of the candidates a beam may not take

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _add_at_0(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] with v [B, D] added at position 0 (a new tensor)."""
    return torch.cat([x[:, :1] + v.to(x.dtype)[:, None], x[:, 1:]], dim=1)


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1)")


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, in
    descending order, ties to the lower index (``jax.lax.top_k``'s order):
    a stable descending sort, since ``torch.topk`` leaves tie order open."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


class IQ(nn.Module):
    """``mesh`` (``parallel.build_mesh`` with a ``seq`` axis) turns on ring
    attention in the encoder and decoder self-attentions when
    ``cfg.sequence_parallel``, with ``cfg.ring_attention_impl``."""

    def __init__(self, cfg: Config, vocab_size: int, mesh=None):
        super().__init__()
        if cfg.image_encoder != "resnet18":
            raise _unported(f"image_encoder={cfg.image_encoder!r}")
        self.cfg, self.vocab_size, self.mesh = cfg, vocab_size, mesh
        dtype = self.dtype = _DTYPES[cfg.dtype]
        d = cfg.hidden_dim
        self.embed = Embed(vocab_size, cfg.emb_dim, dtype, init_std=0.01)
        self.embed_proj = Dense(cfg.emb_dim, d, dtype=dtype)
        self.encoder_cnn = EncoderCNN(d, dtype)
        enc_kw = dict(hidden_dim=d, num_layers=cfg.num_layers,
                      num_heads=cfg.num_heads, pwffn_dim=cfg.pwffn_dim,
                      dtype=dtype, use_pallas=cfg.use_pallas_attention,
                      compat_trailing_relu=cfg.compat_trailing_relu,
                      ring_mesh=mesh if cfg.sequence_parallel else None,
                      ring_impl=cfg.ring_attention_impl,
                      moe_num_experts=cfg.moe_num_experts,
                      attention_dropout=cfg.attention_dropout,
                      relu_dropout=cfg.relu_dropout,
                      layer_dropout=cfg.layer_dropout,
                      input_dropout=cfg.input_dropout)
        self.context_encoder = TransformerEncoder(**enc_kw)
        self.posterior_encoder = TransformerEncoder(**enc_kw)
        self.latent = Latent(d, cfg.latent_dim, dtype)
        self.latent_projection = Dense(cfg.latent_dim, d, dtype=dtype)
        self.decoder = TransformerDecoder(
            **enc_kw,
            max_decode_len=max(cfg.max_decode_length + 1, cfg.max_target_len),
            use_pallas_decode=cfg.use_pallas_decode,
            use_stream_decode=cfg.use_stream_decode,
            stream_weight_dtype=cfg.stream_weight_dtype,
            pipeline_stages=cfg.pipeline_stages)
        self.output_proj = Dense(d, vocab_size, dtype=torch.float32)
        # tie_output_z: one [hidden, vocab] head serves both roles, and the
        # JAX tree then has no z_classifier entry
        if not cfg.tie_output_z:
            self.z_classifier = Dense(d, vocab_size, dtype=torch.float32)
        self.image_reconstructor = MLP(d, cfg.pwffn_dim, d, num_layers=2,
                                       dtype=dtype)

    @property
    def z_head(self) -> Dense:
        return self.output_proj if self.cfg.tie_output_z else self.z_classifier

    def init_weights(self, generator: torch.Generator) -> "IQ":
        """Seed-made weights at the JAX initializers' scales."""
        return init_weights_(self, generator)

    # ------------------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Shared embedding + projection to hidden."""
        return self.embed_proj(self.embed(tokens))

    def encode_context(self, context: torch.Tensor,
                       image_features: torch.Tensor, generator=None):
        """Context encoder + image features added at position 0."""
        src_mask = pad_mask(context, PAD)
        enc = self.context_encoder(self.embed_tokens(context), src_mask,
                                   generator)
        return _add_at_0(enc, image_features), src_mask

    def forward(self, images: torch.Tensor, context: torch.Tensor,
                posterior: torch.Tensor, target: torch.Tensor,
                latent_mode: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """Training/validation forward: ``(logits [B, T, V] f32, z_logit
        [B, V] f32 or None, kld f32, (image features, reconstruction) f32)``.

        images [B, H, W, 3] NHWC; context [B, Tc]; posterior [B, Tp];
        target [B, T].  ``latent_mode`` adds the posterior encoder, the
        latent sample and the z head.  ``train`` normalises the image
        features with the batch statistics (updating the running ones in
        place) and draws every dropout from ``generator``.  The posterior
        noise ``eps`` [B, latent] is drawn from ``generator`` unless given.
        """
        gen = generator if train else None
        image_features = self.encoder_cnn(images, train=train)
        enc, src_mask = self.encode_context(context, image_features, gen)

        kld = torch.zeros((), dtype=torch.float32, device=images.device)
        z_proj = z_logit = None
        if latent_mode:
            post_enc = self.posterior_encoder(
                self.embed_tokens(posterior), pad_mask(posterior, PAD), gen)
            kld, z, _ = self.latent(enc[:, 0], post_enc[:, 0], eps=eps,
                                    generator=generator, train=train)
            z_proj = self.latent_projection(z)
            z_logit = self.z_head((z_proj + image_features).float())

        # shift right with <start>; the key-padding mask is taken on the
        # clean sequence, causality is structural in the self-attention
        b = target.shape[0]
        sos = torch.full((b, 1), START, dtype=target.dtype,
                         device=target.device)
        shifted = torch.cat([sos, target[:, :-1]], dim=1)
        trg_mask = pad_mask(shifted, PAD)
        rate = self.cfg.target_word_dropout
        if train and latent_mode and rate > 0.0:
            # latent-phase word dropout: <unk> for kept-out words, never at
            # the <start>/injection slot, never at pads
            keep = torch.rand(shifted.shape, generator=generator,
                              device=shifted.device) < 1.0 - rate
            droppable = shifted != PAD
            droppable[:, 0] = False
            shifted = torch.where(droppable & ~keep,
                                  torch.full_like(shifted, UNK), shifted)
        inject = image_features if z_proj is None else image_features + z_proj
        temb = _add_at_0(self.embed_tokens(shifted), inject)
        dec_out = self.decoder(temb, enc, src_mask, trg_mask, gen)
        logits = self.output_proj(dec_out.float())

        recon_in = enc[:, 0] if z_proj is None else enc[:, 0] + z_proj
        recon = self.image_reconstructor(recon_in, gen)
        return logits, z_logit, kld, (image_features.float(), recon.float())

    def z_projection(self, enc: torch.Tensor, latent_mode: bool,
                     z_source: str = "prior_sample", posterior=None,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decode-time z, projected to hidden [B, D] (zeros outside the
        latent mode).  ``z_source``: a sample of the prior or posterior
        (noise ``eps`` or a draw from ``generator``) or its mean; the
        posterior sources encode the ``posterior`` tokens."""
        if z_source not in Z_SOURCES:
            raise ValueError(f"z_source {z_source!r} not in {Z_SOURCES}")
        if not latent_mode:
            return torch.zeros_like(enc[:, 0])
        post = None
        if z_source.startswith("posterior"):
            if posterior is None:
                raise ValueError(f"z_source={z_source!r} needs posterior "
                                 f"tokens")
            post = self.posterior_encoder(self.embed_tokens(posterior),
                                          pad_mask(posterior, PAD))[:, 0]
        _, z, _ = self.latent(enc[:, 0], post, eps=eps, generator=generator,
                              use_mean=z_source.endswith("mean"))
        return self.latent_projection(z)

    def predict_from_answer(self, images: torch.Tensor, answers: torch.Tensor,
                            max_decode_length: int = 50,
                            latent_mode: bool = True,
                            generator: Optional[torch.Generator] = None
                            ) -> dict:
        """Questions conditioned on answer tokens (the JAX API name)."""
        return self.decode_greedy(images, answers, max_decode_length,
                                  latent_mode, generator=generator)

    def predict_from_category(self, images: torch.Tensor,
                              categories: torch.Tensor,
                              max_decode_length: int = 50,
                              latent_mode: bool = True,
                              generator: Optional[torch.Generator] = None
                              ) -> dict:
        """Questions conditioned on category ids [B] or [B, 1]."""
        if categories.ndim == 1:
            categories = categories[:, None]
        return self.decode_greedy(images, categories, max_decode_length,
                                  latent_mode, generator=generator)

    def decode_beam(self, images: torch.Tensor, context: torch.Tensor,
                    beam_size: int = 4, max_decode_length: int = 50,
                    latent_mode: bool = False, length_penalty: float = 0.6,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> dict:
        """Beam search with a KV cache: the beams folded into the batch
        (B*K rows per step), the caches reordered along the decoder's
        ``cache_batch_axis`` to follow each step's parents, finished beams
        extended by ``<pad>`` at zero cost, and the best beam picked by the
        GNMT length penalty ((5 + len) / 6) ** ``length_penalty``.  In latent
        mode z is a prior sample (noise ``eps`` or from ``generator``).
        Returns ``tokens`` [B, L] int32 of the best beam and its ``scores``
        [B].  No pad-token key mask, as in the JAX package."""
        k = beam_size
        image_features = self.encoder_cnn(images)
        enc, src_mask = self.encode_context(context, image_features)
        z_proj = self.z_projection(enc, latent_mode, generator=generator,
                                   eps=eps)
        inject = (image_features + z_proj).to(self.dtype)
        b, steps, v = context.shape[0], max_decode_length + 1, self.vocab_size
        dev = context.device
        enc_t, src_mask_t, inject_t = (t.repeat_interleave(k, dim=0)
                                       for t in (enc, src_mask, inject))
        cross_kvs = self.decoder.precompute_cross(enc_t)
        caches = self.decoder.init_cache(b * k, steps, dev)
        stream = (self.decoder.stream_prep(cross_kvs, src_mask_t, b * k)
                  if self.cfg.use_stream_decode else None)
        layers = (self.decoder.layer_weights()
                  if self.decoder.use_pallas_decode else None)
        cba = self.decoder.cache_batch_axis
        pad_only = torch.full((v,), BEAM_NEG, device=dev)
        pad_only[PAD] = 0.0
        row0 = torch.arange(b, device=dev)[:, None] * k
        tokens = torch.full((b, k), PAD if self.cfg.compat_pad_seed else START,
                            dtype=torch.int32, device=dev)
        scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        toks, parents = [], []
        for pos in range(steps):
            x_t = self.embed_tokens(tokens.reshape(b * k)[:, None])
            if pos == 0:
                x_t = x_t + inject_t[:, None, :]
            y_t, _ = self.decoder.step(x_t, caches, cross_kvs, pos,
                                       src_mask_t, stream=stream,
                                       layers=layers)
            logp = torch.log_softmax(self.output_proj(y_t[:, 0].float()),
                                     dim=-1).reshape(b, k, v)
            logp = torch.where(finished[:, :, None], pad_only, logp)
            cand = scores[:, :, None] + logp
            if pos == 0:          # all beams are equal: beam 0's slate only
                cand[:, 1:] = BEAM_NEG
            scores, idx = _top_k(cand.reshape(b, k * v), k)
            parent = idx // v
            tokens = (idx % v).to(torch.int32)
            # the caches are written in place: gather the parents' rows
            flat_parent = (row0 + parent).reshape(b * k)
            for cache in caches:
                for c in cache:
                    c.copy_(c.index_select(cba, flat_parent))
            finished = finished.gather(1, parent) | (tokens == END)
            toks.append(tokens)
            parents.append(parent)

        toks, parents = torch.stack(toks), torch.stack(parents)   # [L, B, K]
        ended = (toks == END).int().cumsum(dim=0) > 0
        beam_len = (~ended).sum(dim=0).float() + 1.0
        norm_scores = scores / ((5.0 + beam_len) / 6.0) ** length_penalty
        best = norm_scores.argmax(dim=1)          # the first maximum
        beam, out = best[:, None], []
        for pos in reversed(range(steps)):
            out.append(toks[pos].gather(1, beam))
            beam = parents[pos].gather(1, beam)
        return {"tokens": torch.cat(out[::-1], dim=1),
                "scores": norm_scores.gather(1, best[:, None])[:, 0]}

    def inference_logits(self, images: torch.Tensor, context: torch.Tensor,
                         prefix: torch.Tensor, latent_mode: bool = False,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-prefix decode logits [B, T, V] f32: the decoder over the
        whole ``prefix`` (no shift-right, no pad mask: causal only), the
        image(+z) injected at position 0; z a prior sample in latent mode."""
        image_features = self.encoder_cnn(images)
        enc, src_mask = self.encode_context(context, image_features)
        z_proj = self.z_projection(enc, latent_mode, generator=generator,
                                   eps=eps)
        temb = _add_at_0(self.embed_tokens(prefix), image_features + z_proj)
        return self.output_proj(self.decoder(temb, enc, src_mask).float())

    # ------------------------------------------------------------------
    def fused_head_engaged(self, with_probe: bool,
                           sample: bool = False) -> bool:
        """Whether greedy decode takes the fused LN+projection+argmax head:
        on the streaming path without the probe and without sampling, when
        forced "on", or on "auto" when the head streams int8."""
        cfg = self.cfg
        return (cfg.use_stream_decode and not with_probe and not sample
                and (cfg.stream_fused_head == "on"
                     or (cfg.stream_fused_head == "auto"
                         and self.head_dtype == "int8")))

    @property
    def head_dtype(self) -> str:
        hd = self.cfg.stream_head_dtype
        return self.cfg.stream_weight_dtype if hd == "auto" else hd

    def fused_head(self) -> dict:
        """The fused head's weights: [D, Vp] padded to a chunk multiple,
        int8 with per-column scales (padded with 1.0) or in the compute
        dtype, the f32 bias (padded with ``PAD_BIAS``) and the final LN.
        Built on first use and kept until one of those parameters changes."""
        params = [*self.output_proj.parameters(),
                  *self.decoder.final_ln.parameters()]
        return cached(self, "_fused_head", self._build_fused_head, params)

    @torch.no_grad()
    def _build_fused_head(self) -> dict:
        head_w = self.output_proj.weight.float().T            # [D, V]
        head_b = self.output_proj.bias.float()
        chunk = decode_head.head_chunk(head_w.shape[1])
        scales = None
        if self.head_dtype == "int8":
            head_w, scales = decode_stream.quantize_stack(head_w)
            head_w, head_b = decode_head.pad_head(head_w, head_b, chunk)
            scales = F.pad(scales, (0, head_w.shape[1] - scales.shape[1]),
                           value=1.0).contiguous()
        else:
            head_w, head_b = decode_head.pad_head(head_w.to(self.dtype),
                                                  head_b, chunk)
        ln = self.decoder.final_ln
        return {"w": head_w.contiguous(), "b": head_b.contiguous(),
                "scales": scales, "chunk": chunk,
                "ln_scale": ln.weight.float().contiguous(),
                "ln_bias": ln.bias.float().contiguous()}

    def prepare_decode(self, images: torch.Tensor, context: torch.Tensor,
                       max_decode_length: int = 50, latent_mode: bool = False,
                       with_probe: bool = True,
                       z_source: str = "prior_sample",
                       generator: Optional[torch.Generator] = None,
                       posterior=None, eps=None, sample: bool = False) -> dict:
        """Everything a decode loop holds fixed: the image(+z) injection
        (z from :meth:`z_projection`), the cross K/V, the source mask, the
        streaming bundle, the per-layer weights and the fused head (None
        where not engaged).  The weight stacks and the fused head are the
        model's own, built once (:func:`cached`); the rest is this request
        batch's."""
        image_features = self.encoder_cnn(images)
        enc, src_mask = self.encode_context(context, image_features)
        z_proj = self.z_projection(enc, latent_mode, z_source, posterior,
                                   generator, eps)
        cross_kvs = self.decoder.precompute_cross(enc)
        b = context.shape[0]
        return {
            "batch": b, "steps": max_decode_length + 1,
            "inject": (image_features + z_proj).to(self.dtype),
            "cross_kvs": cross_kvs, "src_mask": src_mask,
            "stream": (self.decoder.stream_prep(cross_kvs, src_mask, b)
                       if self.cfg.use_stream_decode else None),
            "layers": (self.decoder.layer_weights()
                       if self.decoder.use_pallas_decode else None),
            "head": (self.fused_head()
                     if self.fused_head_engaged(with_probe, sample) else None),
        }

    def decode_step(self, plan: dict, token: torch.Tensor, caches,
                    pos: int, key_pad=None, with_probe: bool = False,
                    sampler=None):
        """One step: embed ``token`` [B], inject at position 0, run the
        decoder stack (caches updated in place) and pick the next token, the
        argmax or ``sampler(logits)``.  Returns (next_token [B] int32, probe
        or None), the probe being the top-6 (tokens, probabilities) of the
        softmax."""
        x_t = self.embed_tokens(token[:, None])
        if pos == 0:
            x_t = x_t + plan["inject"][:, None, :]
        if key_pad is not None:
            key_pad[:, pos] = token == PAD
        head = plan["head"]
        y_t, _ = self.decoder.step(x_t, caches, plan["cross_kvs"], pos,
                                   plan["src_mask"], key_pad,
                                   skip_final_ln=head is not None,
                                   stream=plan["stream"],
                                   layers=plan["layers"])
        if head is not None:
            return decode_head.head_argmax(
                y_t[:, 0], head["ln_scale"], head["ln_bias"], head["w"],
                head["b"], chunk=head["chunk"], scales=head["scales"]), None
        logits = self.output_proj(y_t[:, 0].float())
        if sampler is not None:
            next_token = sampler(logits)
        else:
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        if not with_probe:
            return next_token, None
        top_p, top_t = torch.topk(torch.softmax(logits, dim=-1), 6, dim=-1)
        return next_token, (top_t.to(torch.int32), top_p)

    def decode_greedy(self, images: torch.Tensor, context: torch.Tensor,
                      max_decode_length: int = 50, latent_mode: bool = False,
                      early_stop: bool = False, with_probe: bool = True,
                      z_source: str = "prior_sample", posterior=None,
                      sample: bool = False, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      sample_generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> dict:
        """KV-cache decoding of ``max_decode_length + 1`` tokens.

        images [B, H, W, 3] NHWC; context [B, Tc].  Returns ``tokens``
        [B, L] int32 and, with ``with_probe``, ``top_tokens``/``top_probs``
        [B, L, 6].  ``early_stop`` leaves the loop once every row has
        emitted ``<end>``; finished rows emit ``<pad>``, as do the positions
        never reached.  In latent mode z comes from ``z_source``
        (:meth:`z_projection`: the prior or, with ``posterior`` tokens, the
        posterior; a sample with noise ``eps`` or from ``generator``, or the
        mean).  ``sample`` replaces the argmax with a draw from the
        temperature/top-k/top-p-filtered logits (``ops/sampling.py``) taken
        from ``sample_generator``, a stream of its own; it bypasses the fused
        head, which keeps no logits.
        """
        sampler = None
        if sample:
            if sample_generator is None:
                raise ValueError("sampled decoding needs a sample_generator")
            sampler = functools.partial(sample_token, sample_generator,
                                        temperature=temperature, top_k=top_k,
                                        top_p=top_p)
        plan = self.prepare_decode(images, context, max_decode_length,
                                   latent_mode, with_probe, z_source,
                                   generator, posterior, eps, sample)
        b, steps = plan["batch"], plan["steps"]
        dev = context.device
        caches = self.decoder.init_cache(b, steps, dev)
        token = torch.full((b,), PAD if self.cfg.compat_pad_seed else START,
                           dtype=torch.int32, device=dev)
        key_pad = (torch.zeros((b, steps), dtype=torch.bool, device=dev)
                   if self.cfg.compat_decode_pad_mask else None)
        tokens = torch.zeros((b, steps), dtype=torch.int32, device=dev)
        if with_probe:
            top_tokens = torch.zeros((b, steps, 6), dtype=torch.int32,
                                     device=dev)
            top_probs = torch.zeros((b, steps, 6), dtype=torch.float32,
                                    device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for pos in range(steps):
            if early_stop and bool(done.all()):
                break
            token, probe = self.decode_step(plan, token, caches, pos, key_pad,
                                            with_probe, sampler)
            if early_stop:
                token = torch.where(done, torch.full_like(token, PAD), token)
                done |= token == END
            tokens[:, pos] = token
            if with_probe:
                top_tokens[:, pos], top_probs[:, pos] = probe
        if not with_probe:
            return {"tokens": tokens}
        return {"tokens": tokens, "top_tokens": top_tokens,
                "top_probs": top_probs}
