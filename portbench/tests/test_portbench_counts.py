"""The benchmark's operation and byte counts give known totals."""

import pytest
import torch

from portbench.counts import work

TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, image_size=32, image_encoder="resnet18",
            stream_weight_dtype="bfloat16", stream_head_dtype="int8")


def test_published_image_encoder_operations():
    # multiply-accumulates at 224 x 224: ResNet-18's convolutions 1.81 G,
    # ViT-B/16 17.6 G
    assert work.resnet18_flops(224) == pytest.approx(3.627e9, rel=1e-3)
    assert work.vit_b16_flops(224) == pytest.approx(35.13e9, rel=2e-3)
    params = sum(p.numel() for p in _resnet().parameters()
                 if p.dim() == 4)
    assert params == work.RESNET18_PARAMS


def _resnet():
    from blt_vqg_tpu_torch.ops.resnet import ResNet18Backbone
    return ResNet18Backbone()


def test_stack_call_counts_the_program_layouts():
    """Against the tensors the program's streaming step is handed: every
    stacked weight once, the cross K/V, the biases and norms, the cache
    rows below the position, x in, x/k/v out."""
    from blt_vqg_tpu_torch.core.config import Config
    from blt_vqg_tpu_torch.models.iq import IQ
    cfg = Config(**{k: v for k, v in TINY.items()}, use_stream_decode=True,
                 input_mode="cat")
    model = IQ(cfg, 50)
    model.init_weights(torch.Generator().manual_seed(0))
    b, tc, lmax, pos = 3, 3, 13, 5
    enc = torch.randn(b, tc, 32)
    cross = model.decoder.precompute_cross(enc)
    prep = model.decoder.stream_prep(cross, None, b)
    weights = sum(t.numel() for t in prep["stacks"])
    assert weights == work.stack_weights(TINY)
    bf16 = 2
    nbytes = (weights * bf16 + (prep["lns"].numel() + prep["b1"].numel()
                                + prep["b2"].numel()
                                + prep["smask"].numel()) * 4
              + (prep["ckc"].numel() + prep["cvc"].numel()) * bf16)
    cache = 2 * 2 * 4 * lmax * b * 8 * bf16 * pos / lmax
    nbytes += cache + b * 32 * bf16 * (2 + 2 * 2)
    flops = 2 * b * weights + 4 * b * 2 * 32 * (pos + 1 + tc)
    assert work.stack_call(TINY, b, pos, tc, lmax) == pytest.approx(
        (flops, nbytes))
    int8 = dict(TINY, stream_weight_dtype="int8")
    model.decoder.stream_weight_dtype = "int8"
    prep8 = model.decoder._build_stream_weights()
    scales = sum(s.numel() for s in prep8["scales"]) * 4
    _, b8 = work.stack_call(int8, b, pos, tc, lmax)
    assert b8 == pytest.approx(nbytes - weights + scales)


def test_flash_bounds_small_case():
    pad = torch.tensor([[False, False, True], [False, True, True]])
    # causal, tq 3: row 0 sees keys {0}, {0}; row 1 {0,1}, {0}; row 2 {0,1},
    # {0}: 5 + 3 = 8 pairs
    assert work.flash_visible_pairs(pad, 3, True) == 8
    b, h, d = 2, 2, 4
    got = work.flash_bounds(b, h, d, 3, pad, True)
    act = b * 3 * h * d * 2
    rows = b * h * 3 * 4
    assert got["flash_fwd"] == (4.0 * 16 * d, 4 * act + 2 * rows + 6)
    assert got["flash_bwd_dq"][0] == 6.0 * 16 * d


def test_train_step_flops_tiny():
    m = dict(TINY)
    b, tc, tp, tq, v = 2, 3, 5, 4, 50
    d, f, e, lat, nl = 32, 64, 16, 24, 2
    img = work.resnet18_flops(32)
    enc = lambda t: nl * (b * t * 2 * (4 * d * d + 2 * d * f)
                          + 4 * b * t * t * d)
    dec = nl * (b * tq * 2 * (6 * d * d + 2 * d * f) + b * tc * 4 * d * d
                + 4 * d * b * tq * (tq + 1) / 2 + 4 * d * b * tq * tc)
    fwd = (2 * b * (tc + tp + tq) * e * d + enc(tc) + enc(tp) + dec
           + 2 * b * (d * 2 * lat + 8 * lat * lat)
           + 2 * b * (2 * d * 2 * lat + 8 * lat * lat)
           + 2 * b * lat * d + 2 * b * d * v + 2 * b * tq * d * v
           + 2 * b * 2 * d * f)
    want = b * img + 2 * (2 * b * 512 * d) + 3 * fwd
    assert work.train_step_flops(m, v, b, tc, tp, tq) == pytest.approx(want)


def test_least_time_and_bound():
    assert work.least_s((989e12, 0.0)) == pytest.approx(1.0)
    assert work.least_s((0.0, 3.35e12)) == pytest.approx(1.0)
    assert work.bound_by((1.0, 1e9)) == "bytes"
    parts = work.decode_batch(TINY, 50, 4, 3)
    assert len(parts) == 4 + 3 * 3
    assert all(f > 0 and n > 0 for f, n in parts)
