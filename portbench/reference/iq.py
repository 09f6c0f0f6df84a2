"""The IQ model in plain PyTorch, float32: the benchmark's reference.

It is written from the model's description (a ResNet-18 or ViT-B/16 image
encoder with a linear head and batch norm; pre-LN transformer encoders for
the category context and the posterior question; a Gaussian latent with a
prior and a posterior net; a pre-LN transformer decoder with the image
feature and the latent projection added at position 0; a vocabulary head
and a latent head; an image-feature reconstructor), with no kernel, cache
or batching of its own, and it imports nothing of the program.

Parameters live in a flat dict ``name -> tensor`` whose names and shapes
:func:`param_spec` gives: the benchmark makes them from a seed
(``harness/weights.py``), loads them into the program and hands the same
dict to :class:`RefIQ`.  Masked attention logits take -1e18, the program's
finite fill.  ``operand``, when given, rounds both operands of every
product (matmul, convolution, attention) before it, and ``gradient`` the
gradient that reaches each product's output on the way back: the
lower-precision control.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

PAD, START = 0, 1
MASK_FILL = -1e18
LN_EPS, BN_EPS = 1e-6, 1e-5
STAGE_FILTERS = (64, 128, 256, 512)
VIT = dict(patch=16, depth=12, dim=768, heads=12, mlp=3072)

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


# ---------------------------------------------------------------------------
# parameter names, shapes and initial scales

def _dense(spec: Spec, name: str, n_in: int, n_out: int, bias=True,
           std: Optional[float] = None) -> None:
    spec.append((f"{name}.weight", (n_out, n_in), "normal",
                 std if std is not None else n_in ** -0.5))
    if bias:
        spec.append((f"{name}.bias", (n_out,), "zeros", 0.0))


def _norm(spec: Spec, name: str, dim: int, stats: bool = False) -> None:
    spec.append((f"{name}.weight", (dim,), "ones", 0.0))
    spec.append((f"{name}.bias", (dim,), "zeros", 0.0))
    if stats:
        spec.append((f"{name}.running_mean", (dim,), "zeros", 0.0))
        spec.append((f"{name}.running_var", (dim,), "ones", 0.0))


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int,
          bias: bool = False) -> None:
    spec.append((f"{name}.weight", (cout, cin, k, k), "normal",
                 (cin * k * k) ** -0.5))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zeros", 0.0))


def _attention(spec: Spec, name: str, dim: int) -> None:
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(spec, f"{name}.{proj}", dim, dim, bias=False)


def _ffn(spec: Spec, name: str, dim: int, hidden: int) -> None:
    _dense(spec, f"{name}.ffn_in", dim, hidden)
    _dense(spec, f"{name}.ffn_out", hidden, dim)


def _encoder(spec: Spec, name: str, layers: int, dim: int, ffn: int,
             attn="mha", block="layer") -> None:
    for i in range(layers):
        p = f"{name}.{block}_{i}"
        _norm(spec, f"{p}.ln_mha", dim)
        _attention(spec, f"{p}.{attn}", dim)
        _norm(spec, f"{p}.ln_ffn", dim)
        _ffn(spec, f"{p}.ffn", dim, ffn)
    _norm(spec, f"{name}.final_ln", dim)


def resnet_blocks():
    """(name, cin, filters, stride) of the eight BasicBlocks."""
    out, cin = [], 64
    for stage, filters in enumerate(STAGE_FILTERS):
        for block in range(2):
            stride = 2 if stage > 0 and block == 0 else 1
            out.append((f"stage{stage}_block{block}", cin, filters, stride))
            cin = filters
    return out


def param_spec(model: dict, vocab: int) -> Spec:
    """(name, shape, init, std) of every parameter and batch-norm
    statistic; ``init`` is "normal" (with ``std``), "zeros" or "ones".
    ``model`` holds the configuration's sizes (``configs/*.json``)."""
    d, e, lat = model["hidden_dim"], model["emb_dim"], model["latent_dim"]
    f, nl = model["pwffn_dim"], model["num_layers"]
    spec: Spec = [("embed.weight", (vocab, e), "normal", 0.01)]
    _dense(spec, "embed_proj", e, d)
    if model.get("image_encoder", "resnet18") == "vit_b16":
        n = (model["image_size"] // VIT["patch"]) ** 2
        b = "encoder_cnn.backbone"
        spec.append((f"{b}.cls_token", (1, 1, VIT["dim"]), "zeros", 0.0))
        spec.append((f"{b}.pos_embed", (1, n + 1, VIT["dim"]), "normal",
                     0.02))
        _conv(spec, f"{b}.patch_embed", 3, VIT["dim"], VIT["patch"], True)
        _encoder(spec, b, VIT["depth"], VIT["dim"], VIT["mlp"], block="block")
        feat = VIT["dim"]
    else:
        b = "encoder_cnn.backbone"
        _conv(spec, f"{b}.stem_conv", 3, 64, 7)
        _norm(spec, f"{b}.stem_bn", 64, stats=True)
        for name, cin, filters, stride in resnet_blocks():
            p = f"{b}.{name}"
            _conv(spec, f"{p}.conv1", cin, filters, 3)
            _norm(spec, f"{p}.bn1", filters, stats=True)
            _conv(spec, f"{p}.conv2", filters, filters, 3)
            _norm(spec, f"{p}.bn2", filters, stats=True)
            if stride != 1 or cin != filters:
                _conv(spec, f"{p}.down_conv", cin, filters, 1)
                _norm(spec, f"{p}.down_bn", filters, stats=True)
        feat = STAGE_FILTERS[-1]
    _dense(spec, "encoder_cnn.fc", feat, d, std=0.02)
    _norm(spec, "encoder_cnn.feat_bn", d, stats=True)
    _encoder(spec, "context_encoder", nl, d, f)
    _encoder(spec, "posterior_encoder", nl, d, f)
    for net, n_in in (("prior", d), ("posterior", 2 * d)):
        _dense(spec, f"latent.{net}.in_proj", n_in, 2 * lat)
        _dense(spec, f"latent.{net}.hidden_0", 2 * lat, 2 * lat)
        _dense(spec, f"latent.{net}.hidden_1", 2 * lat, 2 * lat)
    _dense(spec, "latent_projection", lat, d)
    for i in range(nl):
        p = f"decoder.layer_{i}"
        _norm(spec, f"{p}.ln_self", d)
        _attention(spec, f"{p}.self_attn", d)
        _norm(spec, f"{p}.ln_cross", d)
        _attention(spec, f"{p}.cross_attn", d)
        _norm(spec, f"{p}.ln_ffn", d)
        _ffn(spec, f"{p}.ffn", d, f)
    _norm(spec, "decoder.final_ln", d)
    _dense(spec, "output_proj", d, vocab)
    _dense(spec, "z_classifier", d, vocab)
    _dense(spec, "image_reconstructor.fc0", d, f, std=math.sqrt(2.0 / d))
    _dense(spec, "image_reconstructor.fc1", f, d, std=math.sqrt(2.0 / f))
    return spec


_NORM = re.compile(r"(^|\.)(ln_\w+|final_ln|\w*bn\d?)\.")


def stored_in_compute_dtype(name: str) -> bool:
    """Whether the served model keeps this parameter in the compute dtype:
    every product's weights and biases and the ViT's tokens, but not the
    norms, their statistics, or the two vocabulary heads (f32 products)."""
    return not (_NORM.search(name)
                or name.startswith(("output_proj.", "z_classifier.")))


def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` [K, N] rounded to symmetric int8 per output column (the
    largest |value| of a column maps to 127, ties to even), dequantized."""
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def timing_signal(length: int, channels: int, device) -> torch.Tensor:
    """[length, channels]: sin over the first half of the channels, cos
    over the second, timescales from 1 to 1e4 in geometric steps."""
    half = channels // 2
    inc = math.log(1.0e4) / max(half - 1, 1)
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * -inc)
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    sig = torch.cat([torch.sin(t * inv), torch.cos(t * inv)], dim=1)
    return F.pad(sig, (0, channels % 2))


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest |value| at
    448), back in float32; the gradient passes through unchanged."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class _Fp8Gradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp_min(1e-30) / 57344.0
        return (g / scale).to(torch.float8_e5m2).float() * scale


def fp8_gradient(y: torch.Tensor) -> torch.Tensor:
    """``y`` unchanged; the gradient that reaches it is rounded to float8
    e5m2 under one scale (its largest |value| at 57344), as fp8 training
    keeps the gradients of its products."""
    return _Fp8Gradient.apply(y)


class RefIQ:
    """The model over the parameter dict ``p`` (float32, any device).
    ``served`` rounds the parameters the served program stores in its
    compute dtype to that dtype and quantizes the vocabulary head to int8
    per column, as ``model["stream_head_dtype"]`` says; the arithmetic
    stays float32 either way."""

    def __init__(self, p: Dict[str, torch.Tensor], model: dict,
                 served: bool = False,
                 operand: Optional[Callable] = None,
                 gradient: Optional[Callable] = None):
        self.m = model
        self.op = operand or (lambda x: x)
        self.gop = gradient or (lambda y: y)
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            model["dtype"]]
        if served:
            p = {k: (v.to(dt).float() if stored_in_compute_dtype(k) else v)
                 for k, v in p.items()}
            if model.get("stream_head_dtype") == "int8":
                p = dict(p)
                p["head.weight_t"] = int8_columns(
                    p["output_proj.weight"].float().T)
        self.p = p
        self.heads, self.dim = model["num_heads"], model["hidden_dim"]

    # ---- pieces -----------------------------------------------------------
    def linear(self, x, name: str, bias: bool = True):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias") if bias else None
        return self.gop(F.linear(self.op(x), self.op(w), b))

    def ln(self, x, name: str):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def bn(self, x, name: str, train: bool):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if train:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(dim=axes)
            var = ((x - mean.view(shape)) ** 2).mean(dim=axes)
        else:
            mean = self.p[f"{name}.running_mean"]
            var = self.p[f"{name}.running_var"]
        y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
        return (y * self.p[f"{name}.weight"].view(shape)
                + self.p[f"{name}.bias"].view(shape))

    def conv(self, x, name: str, stride: int, pad: int):
        return self.gop(F.conv2d(self.op(x), self.op(self.p[f"{name}.weight"]),
                                 self.p.get(f"{name}.bias"), stride, pad))

    def attention(self, name: str, xq, xkv, heads: int, key_pad=None,
                  causal: bool = False):
        """key_pad [B, Tk] bool, True where the key is padding."""
        b, tq, dim = xq.shape
        tk, dh = xkv.shape[1], dim // heads
        q = self.linear(xq, f"{name}.q_proj", False).view(b, tq, heads, dh)
        k = self.linear(xkv, f"{name}.k_proj", False).view(b, tk, heads, dh)
        v = self.linear(xkv, f"{name}.v_proj", False).view(b, tk, heads, dh)
        s = self.gop(torch.einsum("bqhd,bkhd->bhqk",
                                  self.op(q * dh ** -0.5), self.op(k)))
        mask = torch.zeros((1, 1, tq, tk), dtype=torch.bool, device=xq.device)
        if key_pad is not None:
            mask = mask | key_pad[:, None, None, :]
        if causal:
            mask = mask | torch.ones((tq, tk), dtype=torch.bool,
                                     device=xq.device).triu(1)
        w = torch.softmax(s.masked_fill(mask, MASK_FILL), dim=-1)
        ctx = self.gop(torch.einsum("bhqk,bkhd->bqhd", self.op(w),
                                    self.op(v)))
        return self.linear(ctx.reshape(b, tq, dim), f"{name}.out_proj", False)

    def ffn(self, x, name: str, act=torch.relu):
        return self.linear(act(self.linear(x, f"{name}.ffn_in")),
                           f"{name}.ffn_out")

    def encoder(self, name: str, x, key_pad, heads: int, layers: int,
                block: str = "layer", act=torch.relu, timing: bool = True):
        if timing:
            x = x + timing_signal(x.shape[1], x.shape[2], x.device)
        for i in range(layers):
            p = f"{name}.{block}_{i}"
            xn = self.ln(x, f"{p}.ln_mha")
            x = x + self.attention(f"{p}.mha", xn, xn, heads, key_pad)
            x = x + self.ffn(self.ln(x, f"{p}.ln_ffn"), f"{p}.ffn", act)
        return self.ln(x, f"{name}.final_ln")

    def embed(self, tokens):
        e = F.embedding(tokens.long(), self.p["embed.weight"])
        return self.linear(e, "embed_proj")

    # ---- image encoders --------------------------------------------------
    def resnet(self, x, train: bool):
        b = "encoder_cnn.backbone"
        x = torch.relu(self.bn(self.conv(x, f"{b}.stem_conv", 2, 3),
                               f"{b}.stem_bn", train))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, cin, filters, stride in resnet_blocks():
            p = f"{b}.{name}"
            y = torch.relu(self.bn(self.conv(x, f"{p}.conv1", stride, 1),
                                   f"{p}.bn1", train))
            y = self.bn(self.conv(y, f"{p}.conv2", 1, 1), f"{p}.bn2", train)
            if stride != 1 or cin != filters:
                x = self.bn(self.conv(x, f"{p}.down_conv", stride, 0),
                            f"{p}.down_bn", train)
            x = torch.relu(y + x)
        return x.mean(dim=(2, 3))

    def vit(self, x):
        b = "encoder_cnn.backbone"
        x = self.conv(x, f"{b}.patch_embed", VIT["patch"], 0)
        x = x.flatten(2).transpose(1, 2)
        cls = self.p[f"{b}.cls_token"].expand(x.shape[0], 1, VIT["dim"])
        x = torch.cat([cls, x], dim=1) + self.p[f"{b}.pos_embed"]
        gelu = lambda h: F.gelu(h, approximate="tanh")
        return self.encoder(b, x, None, VIT["heads"], VIT["depth"], "block",
                            gelu, timing=False)[:, 0]

    def image_features(self, images, train: bool = False):
        """images [B, S, S, 3] -> [B, hidden]; the backbone takes no
        gradient."""
        x = images.permute(0, 3, 1, 2).float()
        with torch.no_grad():
            if self.m.get("image_encoder", "resnet18") == "vit_b16":
                feat = self.vit(x)
            else:
                feat = self.resnet(x, train)
        return self.bn(self.linear(feat, "encoder_cnn.fc"),
                       "encoder_cnn.feat_bn", train)

    # ---- the model -------------------------------------------------------
    def encode_context(self, context, features):
        pad = context == PAD
        enc = self.encoder("context_encoder", self.embed(context), pad,
                           self.heads, self.m["num_layers"])
        return torch.cat([enc[:, :1] + features[:, None], enc[:, 1:]], 1), pad

    def mean_logvar(self, net: str, x):
        h = self.linear(x, f"latent.{net}.in_proj")
        for layer in ("hidden_0", "hidden_1"):
            h = self.linear(torch.relu(h), f"latent.{net}.{layer}")
        lat = self.m["latent_dim"]
        return h[:, :lat], h[:, lat:]

    def decoder(self, x, enc, src_pad, trg_pad=None):
        x = x + timing_signal(x.shape[1], x.shape[2], x.device)
        for i in range(self.m["num_layers"]):
            p = f"decoder.layer_{i}"
            xn = self.ln(x, f"{p}.ln_self")
            x = x + self.attention(f"{p}.self_attn", xn, xn, self.heads,
                                   trg_pad, causal=True)
            x = x + self.attention(f"{p}.cross_attn",
                                   self.ln(x, f"{p}.ln_cross"), enc,
                                   self.heads, src_pad)
            x = x + self.ffn(self.ln(x, f"{p}.ln_ffn"), f"{p}.ffn")
        return self.ln(x, "decoder.final_ln")

    def vocab_logits(self, y):
        if "head.weight_t" in self.p:
            return self.gop(self.op(y) @ self.op(self.p["head.weight_t"])
                            + self.p["output_proj.bias"])
        return self.linear(y, "output_proj")

    def decode_logits(self, images, context, eps, prefix):
        """Greedy decoding's logits [B, T, V], teacher-forced: the decoder
        over ``prefix`` [B, T] (the seed token, then the served tokens),
        causal with no pad mask, the image feature plus the prior sample
        ``eps * exp(logvar / 2) + mean`` projected added at position 0."""
        feat = self.image_features(images)
        enc, src_pad = self.encode_context(context, feat)
        mean, logvar = self.mean_logvar("prior", enc[:, 0])
        z = eps.float() * torch.exp(0.5 * logvar) + mean
        inject = feat + self.linear(z, "latent_projection")
        x = self.embed(prefix)
        x = torch.cat([x[:, :1] + inject[:, None], x[:, 1:]], 1)
        return self.vocab_logits(self.decoder(x, enc, src_pad))

    def train_forward(self, batch: dict, eps):
        """The latent-phase training forward: (logits [B, T, V], z logit
        [B, V], kld, image features, their reconstruction)."""
        feat = self.image_features(batch["images"], train=True)
        enc, src_pad = self.encode_context(batch["context"], feat)
        post = batch["posterior"]
        post_enc = self.encoder("posterior_encoder", self.embed(post),
                                post == PAD, self.heads, self.m["num_layers"])
        mu_p, lv_p = self.mean_logvar("prior", enc[:, 0])
        mu_q, lv_q = self.mean_logvar(
            "posterior", torch.cat([post_enc[:, 0], enc[:, 0]], -1))
        kld = (-0.5 * torch.sum(1.0 + lv_q - lv_p - (mu_p - mu_q) ** 2
                                / torch.exp(lv_p)
                                - torch.exp(lv_q) / torch.exp(lv_p),
                                dim=-1)).mean()
        z = eps.float() * torch.exp(0.5 * lv_q) + mu_q
        z_proj = self.linear(z, "latent_projection")
        z_logit = self.linear(z_proj + feat, "z_classifier")
        target = batch["target"]
        start = torch.full_like(target[:, :1], START)
        shifted = torch.cat([start, target[:, :-1]], 1)
        x = self.embed(shifted)
        x = torch.cat([x[:, :1] + (feat + z_proj)[:, None], x[:, 1:]], 1)
        logits = self.linear(self.decoder(x, enc, src_pad, shifted == PAD),
                             "output_proj")
        h = torch.relu(self.linear(enc[:, 0] + z_proj,
                                   "image_reconstructor.fc0"))
        recon = self.linear(h, "image_reconstructor.fc1")
        return logits, z_logit, kld, feat, recon
