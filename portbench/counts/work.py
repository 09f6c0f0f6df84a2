"""Operations and bytes of the work, counted from shapes.

These counts are the benchmark's own: each roofline share and each ``mfu``
reads the same work whatever implements it.  Peaks: one NVIDIA H100 SXM
(data sheet, dense, without sparsity): 989 TFLOP/s in bf16 on the tensor
cores and 3.35 TB/s of HBM.  An operation count is of multiplies and adds
(two a multiply-accumulate); a byte count reads each input once and writes
each output once.  ``least_s`` is the larger of operations at the peak
rate and bytes at the peak bandwidth.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

Work = Tuple[float, float]       # (operations, bytes)


def least_s(work: Work) -> float:
    flops, nbytes = work
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def bound_by(work: Work) -> str:
    flops, nbytes = work
    return ("operations" if flops / BF16_FLOPS_PER_S
            >= nbytes / HBM_BYTES_PER_S else "bytes")


# ---------------------------------------------------------------------------
# image encoders, one image's forward

def resnet18_flops(size: int) -> float:
    """Convolutions of the ResNet-18 backbone at ``size`` x ``size``."""
    out = lambda n, k, s, p: (n + 2 * p - k) // s + 1
    h = out(size, 7, 2, 3)
    flops = 2.0 * 64 * 3 * 49 * h * h
    h = out(h, 3, 2, 1)                       # max pool
    cin = 64
    for stage, f in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if stage > 0 and block == 0 else 1
            ho = out(h, 3, stride, 1)
            flops += 2.0 * f * cin * 9 * ho * ho + 2.0 * f * f * 9 * ho * ho
            if stride != 1 or cin != f:
                flops += 2.0 * f * cin * ho * ho
            h, cin = ho, f
    return flops


RESNET18_PARAMS = 11_166_912      # the backbone's convolution weights


def vit_b16_flops(size: int, patch=16, depth=12, dim=768, mlp=3072) -> float:
    n = (size // patch) ** 2
    t = n + 1
    flops = 2.0 * dim * 3 * patch * patch * n
    per_block = t * 2.0 * (4 * dim * dim + 2 * dim * mlp) + 4.0 * t * t * dim
    return flops + depth * per_block


def vit_b16_params(patch=16, depth=12, dim=768, mlp=3072) -> int:
    return (3 * patch * patch * dim
            + depth * (4 * dim * dim + 2 * dim * mlp + mlp + dim))


def image_encoder(m: dict) -> Tuple[float, int, int]:
    """(operations an image, backbone parameters, feature width)."""
    if m.get("image_encoder", "resnet18") == "vit_b16":
        return vit_b16_flops(m["image_size"]), vit_b16_params(), 768
    return resnet18_flops(m["image_size"]), RESNET18_PARAMS, 512


# ---------------------------------------------------------------------------
# transformer pieces

def encoder_layer_flops(d: int, f: int, tokens: float, pairs: float) -> float:
    """One pre-LN encoder layer over ``tokens`` tokens whose attention
    covers ``pairs`` (query, key) pairs."""
    return tokens * 2.0 * (4 * d * d + 2 * d * f) + 4.0 * pairs * d


def stack_weights(m: dict) -> int:
    """Weights of the decoder stack's products (self q|k|v, out; cross q,
    out; FFN in, out) over all layers."""
    d, f = m["hidden_dim"], m["pwffn_dim"]
    return m["num_layers"] * (6 * d * d + 2 * d * f)


def stack_call(m: dict, batch: int, pos: int, tc: int, lmax: int) -> Work:
    """One decode_stack_step call at position ``pos``: every weight (bf16,
    or int8 with f32 column scales), bias, LayerNorm and cross K/V once,
    the cache rows below ``pos``, x in, and x, k and v out."""
    d, f, nl, h = (m["hidden_dim"], m["pwffn_dim"], m["num_layers"],
                   m["num_heads"])
    hc = next(c for c in (4, 3, 2, 1) if h % c == 0)
    fc = next(c for c in (4, 3, 2, 1) if f % c == 0)
    w = stack_weights(m)
    int8 = m.get("stream_weight_dtype", "bfloat16") == "int8"
    nbytes = w * (1 if int8 else 2)
    if int8:          # per output column of each stacked slice
        nbytes += 4 * nl * (3 * d + h * d + d + hc * d + f + fc * d)
    nbytes += nl * 6 * d * 4 + nl * (f + d) * 4           # LayerNorms, biases
    nbytes += 2 * nl * tc * batch * d * 2 + tc * batch * 4  # cross K/V, mask
    nbytes += 2 * nl * batch * d * 2 * pos                # cache rows < pos
    nbytes += batch * d * 2 * (2 + 2 * nl)                # x in, x/k/v out
    flops = 2.0 * batch * w + 4.0 * batch * nl * d * (pos + 1 + tc)
    return flops, float(nbytes)


def head_call(m: dict, batch: int, vocab: int) -> Work:
    d = m["hidden_dim"]
    int8 = m.get("stream_head_dtype", "bfloat16") == "int8"
    nbytes = d * vocab * (1 if int8 else 2) + vocab * (8 if int8 else 4)
    nbytes += 2 * d * 4 + batch * d * 2 + batch * 4
    return 2.0 * batch * d * vocab, float(nbytes)


def decode_batch(m: dict, vocab: int, batch: int, positions: int,
                 tc: int = 3) -> List[Work]:
    """The parts of one greedy batch in latent mode: the image encoder,
    the context encoder, the prior and z projection, the cross K/V, and
    each position's embedding, stack step and fused head."""
    d, f, e, lat, nl = (m["hidden_dim"], m["pwffn_dim"], m["emb_dim"],
                        m["latent_dim"], m["num_layers"])
    img_flops, img_params, feat = image_encoder(m)
    s = m["image_size"]
    parts = [(batch * (img_flops + 2.0 * feat * d),
              batch * s * s * 3 * 4.0 + 2.0 * (img_params + feat * d)
              + batch * d * 2.0)]
    enc_w = nl * (4 * d * d + 2 * d * f) + e * d
    parts.append((nl * encoder_layer_flops(d, f, batch * tc, batch * tc * tc)
                  + 2.0 * batch * tc * e * d,
                  2.0 * enc_w + batch * tc * (4 + 2 * d)))
    prior_w = d * 2 * lat + 2 * (2 * lat) ** 2 + lat * d
    parts.append((2.0 * batch * prior_w, 2.0 * prior_w + batch * lat * 4.0))
    parts.append((nl * 2.0 * 2 * d * d * batch * tc,
                  nl * 2 * d * d * 2.0 + 2 * nl * batch * tc * d * 2.0))
    for pos in range(positions):
        parts.append((2.0 * batch * e * d, 2.0 * e * d + batch * (e + d) * 2))
        parts.append(stack_call(m, batch, pos, tc, positions))
        parts.append(head_call(m, batch, vocab))
    return parts


def train_step_flops(m: dict, vocab: int, batch: int, tc: int, tp: int,
                     tq: int) -> float:
    """Model operations of one latent-phase train step: the frozen
    backbone forward only; forward and backward (twice the forward) of
    every trainable product, the image head's backward without an input
    gradient; attention over every (query, key) pair the shapes allow,
    causal in the decoder's self-attention; nothing recomputed."""
    d, f, e, lat, nl = (m["hidden_dim"], m["pwffn_dim"], m["emb_dim"],
                        m["latent_dim"], m["num_layers"])
    img_flops, _, feat = image_encoder(m)
    backbone = batch * img_flops
    fc = 2.0 * batch * feat * d
    fwd = 2.0 * batch * (tc + tp + tq) * e * d                   # embed_proj
    fwd += nl * encoder_layer_flops(d, f, batch * tc, batch * tc * tc)
    fwd += nl * encoder_layer_flops(d, f, batch * tp, batch * tp * tp)
    dec_tokens = batch * tq
    fwd += nl * (dec_tokens * 2.0 * (6 * d * d + 2 * d * f)
                 + batch * tc * 2.0 * 2 * d * d
                 + 4.0 * d * batch * tq * (tq + 1) / 2
                 + 4.0 * d * batch * tq * tc)
    fwd += 2.0 * batch * (d * 2 * lat + 2 * (2 * lat) ** 2)        # prior
    fwd += 2.0 * batch * (2 * d * 2 * lat + 2 * (2 * lat) ** 2)    # posterior
    fwd += 2.0 * batch * lat * d + 2.0 * batch * d * vocab      # z proj, head
    fwd += 2.0 * dec_tokens * d * vocab                            # vocab head
    fwd += 2.0 * batch * 2 * d * f                                 # recon MLP
    return backbone + 2.0 * fc + 3.0 * fwd


# ---------------------------------------------------------------------------
# flash attention (the bounds of the program's chip_smoke.py, copied)

def flash_visible_pairs(kv_pad, tq: int, causal: bool) -> int:
    """(query, key) pairs the data needs, summed over the batch rows;
    ``kv_pad`` [B, Tk] bool, True at a padded key."""
    import torch
    tk = kv_pad.shape[1]
    vis = ~kv_pad[:, None, :].expand(-1, tq, tk)
    if causal:
        vis = vis & ~torch.ones((tq, tk), dtype=torch.bool,
                                device=kv_pad.device).triu(1)
    return int(vis.sum())


def flash_bounds(b: int, h: int, d: int, tq: int, kv_pad,
                 causal: bool) -> Dict[str, Work]:
    """{kernel: (operations, bytes)} of one bf16 call each."""
    tk = kv_pad.shape[1]
    pairs = flash_visible_pairs(kv_pad, tq, causal) * h
    act_q, act_k = b * tq * h * d * 2, b * tk * h * d * 2
    rows = b * h * tq * 4
    pad = kv_pad.numel()
    return {"flash_fwd": (4.0 * pairs * d,
                          2 * act_q + 2 * act_k + 2 * rows + pad),
            "flash_bwd_dkdv": (8.0 * pairs * d,
                               2 * act_q + 4 * act_k + 3 * rows + pad),
            "flash_bwd_dq": (6.0 * pairs * d,
                             3 * act_q + 2 * act_k + 3 * rows + pad)}


def train_flash_calls(batch: dict, m: dict) -> List[Tuple]:
    """(b, h, dh, tq, kv_pad, causal, calls) of a latent train step's
    attention: the context and posterior encoders' self-attention, the
    decoder's causal self-attention and its cross-attention; each runs the
    forward, dK/dV and dQ kernels once a call."""
    import torch
    h = m["num_heads"]
    dh = m["hidden_dim"] // h
    ctx, post, tgt = batch["context"], batch["posterior"], batch["target"]
    b = ctx.shape[0]
    shifted = torch.cat([torch.ones_like(tgt[:, :1]), tgt[:, :-1]], 1)
    nl = m["num_layers"]
    return [(b, h, dh, ctx.shape[1], ctx == 0, False, nl),
            (b, h, dh, post.shape[1], post == 0, False, nl),
            (b, h, dh, tgt.shape[1], shifted == 0, True, nl),
            (b, h, dh, tgt.shape[1], ctx == 0, False, nl)]
