"""The plan of the cluster split-K product (csrc/common.cuh), on which the
bf16 ``self_attn_step`` and ``head_argmax`` run, in pure Python: the
cluster and tile geometry, that every (column, K row) of every group and
row tile is taken by exactly one block and every output column summed by
exactly one rank, the one scratch allocation of each call, and the
launches per call.  The kernels themselves run on the card
(tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from blt_vqg_tpu_torch.ops.kernels import decode_head as tdh
from blt_vqg_tpu_torch.ops.kernels import decode_layer as tdl
from blt_vqg_tpu_torch.ops.kernels import decode_stream as tds

T = tds.CLUSTER_TILE


def _walk(grid, ranks, split):
    """Walks a cluster product's grid as the kernels read blockIdx: block
    x is rank x % ranks of column tile x // ranks; ``split(rank, y)``
    gives the groups the rank takes and its K rows [lo, hi).  Returns
    {(group, row tile): {column tile: [K ranges, by rank]}} and {(y, row
    tile, column tile): [column share ranges summed, by rank]}."""
    taken, summed = {}, {}
    gx, gy, gz = grid
    assert gx % ranks == 0
    share = T // ranks
    for x in range(gx):
        rank, tile = x % ranks, x // ranks
        for y in range(gy):
            for z in range(gz):
                groups, rows = split(rank, y)
                for g in groups:
                    taken.setdefault((g, z), {}).setdefault(tile, []).append(rows)
                summed.setdefault((y, z, tile), []).append(
                    (tile * T + rank * share, tile * T + (rank + 1) * share))
    return taken, summed


def _partitions(ranges, lo, hi):
    """Whether the [a, b) ranges, clipped to [lo, hi), cover it once."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in ranges
                   if min(b, hi) > max(a, lo))
    return (bool(spans) and spans[0][0] == lo and spans[-1][1] == hi
            and all(e == s for (_, e), (s, _) in zip(spans, spans[1:])))


def _covers_once(taken, summed, groups, row_tiles, width, depth):
    """Every (column, K row) of every group and row tile is taken by one
    block, and every column summed by one rank."""
    assert sorted(taken) == [(g, z) for g in range(groups)
                             for z in range(row_tiles)]
    for tiles in taken.values():
        assert _partitions([(t * T, (t + 1) * T) for t in tiles], 0, width)
        for t, rows in tiles.items():
            assert _partitions(rows, 0, depth), (t, rows)
    for (_, _, t), shares in summed.items():
        assert _partitions(shares, t * T, min(width, (t + 1) * T))


@pytest.mark.parametrize("depth", [8, 40, 96, 256, 257, 320, 513, 1024,
                                   1100, 2048, 2049, 4096])
def test_cluster_split_covers_the_depth_once(depth):
    for tiles in (1, 48, 192, 768):
        c, ks = tds.cluster_split(depth, tiles, 132)
        assert c in (1, 2, 4, 8) and ks % 16 == 0
        rows = [k for r in range(c)
                for k in range(r * ks, min(depth, (r + 1) * ks))]
        assert rows == list(range(depth))
        if depth <= tds.MAX_CLUSTER * tds.CLUSTER_MAX_DEPTH:
            assert ks <= tds.CLUSTER_MAX_DEPTH
        # doubled past the fewest ranks only while a rank keeps its
        # least depth and the blocks fit the card at once
        fewest = c == 1 or -(-depth // (c // 2)) > tds.CLUSTER_MAX_DEPTH
        assert fewest or (-(-depth // c) >= tds.CLUSTER_MIN_DEPTH
                          and tiles * c <= tds.CLUSTER_BLOCKS_PER_SM * 132)


def test_cluster_split_at_the_flagship():
    """D 1,024 on an H100's 132 SMs: the head's 192 vocab tiles take 2
    ranks (4 would need two waves of blocks), QKV's 48 tiles at b64 take
    4 ranks and its 192 at b256 take 2; a card with more SMs takes more."""
    assert tds.cluster_split(1024, 192, 132) == (2, 512)
    assert tds.cluster_split(1024, 48, 132) == (4, 256)
    assert tds.cluster_split(1024, 192, 132) == tds.cluster_split(1024, 192)
    assert tds.cluster_split(1024, 192, 264) == (4, 256)
    assert tds.cluster_split(1024) == (4, 256)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 8, 12, 16, 20, 64])
def test_cluster_heads_takes_each_head_once(heads):
    c, hpb = tds.cluster_heads(heads)
    assert c in (1, 2, 4, 8) and c * hpb >= heads > (c // 2) * hpb
    owners = [h // hpb for h in range(heads)]
    assert owners == sorted(owners) and max(owners) < c
    assert tds.cluster_heads(8) == (8, 1)


# (batch, heads, head_dim): the card tests' cases and the flagship at b64
# and beam width
SELF_SHAPES = [(1, 8, 128), (3, 8, 64), (65, 8, 80), (256, 8, 128),
               (3, 12, 64), (5, 16, 64), (64, 3, 80), (64, 8, 128)]


@pytest.mark.parametrize("case", SELF_SHAPES,
                         ids=[f"b{b}-h{h}-dh{dh}" for b, h, dh in SELF_SHAPES])
def test_self_plan_covers_each_output_once(case):
    b, h, dh = case
    d, mt = h * dh, -(-b // T)
    plan = tdl.self_plan(b, d, h)
    # QKV: one group a head, the ranks splitting D
    c, ks = plan["qkv"]
    assert plan["qkv_grid"] == (-(-3 * dh // T) * c, h, mt)
    taken, summed = _walk(plan["qkv_grid"], c,
                          lambda r, y: ([y], (r * ks, (r + 1) * ks)))
    _covers_once(taken, summed, h, mt, 3 * dh, d)
    # out: the ranks split the heads, each taking its heads' whole Dh
    c, hpb = plan["out"]
    assert plan["out_grid"] == (-(-d // T) * c, 1, mt)
    taken, summed = _walk(plan["out_grid"], c,
                          lambda r, y: (range(r * hpb, min(h, (r + 1) * hpb)),
                                        (0, dh)))
    _covers_once(taken, summed, h, mt, d, dh)
    # attention: a warp per (b, h)
    gx, gy = plan["attn_grid"]
    assert gy == h and gx * tdl.SA_WARPS >= b > (gx - 1) * tdl.SA_WARPS
    if (b, h, dh) == (64, 8, 128):     # the flagship: as wide as before
        assert plan["qkv"] == (4, 256) and plan["out"] == (8, 1)
        assert plan["qkv_grid"] == (24, 8, 1) and plan["out_grid"] == (128, 1, 1)


# (batch, dim, vocab): the card tests' cases and the flagship's head
HEAD_SHAPES = [(1, 1024, 1024), (3, 96, 384), (65, 256, 896), (256, 40, 384),
               (5, 320, 384), (64, 1024, 12288)]


@pytest.mark.parametrize("case", HEAD_SHAPES,
                         ids=[f"b{b}-d{d}-v{v}" for b, d, v in HEAD_SHAPES])
def test_head_plan_covers_each_logit_once(case):
    b, d, v = case
    mt = -(-b // T)
    plan = tdh.head_plan(b, d, v)
    c, ks = plan["split"]
    assert plan["tiles"] == -(-v // T)
    assert plan["grid"] == (plan["tiles"] * c, 1, mt)
    assert plan["pairs"] == plan["grid"][0]     # one (max, argmax) a block
    taken, summed = _walk(plan["grid"], c,
                          lambda r, y: ([0], (r * ks, (r + 1) * ks)))
    _covers_once(taken, summed, 1, mt, v, d)
    if (b, d, v) == (64, 1024, 12288):     # 2 ranks; ~3 blocks an SM
        assert plan["split"] == (2, 512) and plan["grid"] == (384, 1, 1)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_launches_per_call(bf16):
    self_k, head_k = tdl.self_kernels(bf16), tdh.head_kernels(bf16)
    assert sum(self_k.values()) == (4 if bf16 else 6)
    assert sum(head_k.values()) == (3 if bf16 else 4)
    assert ("gemm_partial_kernel" in self_k) != bf16     # no f32 partials
    assert ("gemm_partial_kernel" in head_k) != bf16


def _spans(a, buf, sizes):
    """The pieces' [start, end) byte spans: 256-byte aligned, disjoint,
    inside buf."""
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    spans = sorted((getattr(a, n), getattr(a, n) + s) for n, s in sizes.items())
    assert all((p - lo) % 256 == 0 for p, _ in spans)
    assert spans[0][0] >= lo and spans[-1][1] <= hi
    assert all(e <= p for (_, e), (p, _) in zip(spans, spans[1:]))
    return spans


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_self_args_one_scratch_allocation(dt):
    """xn, q (bf16; qkv with f32) and ctx, and with f32 the split-K
    partials, in one allocation; the plan handed over."""
    b, h, dh, lmax, pos = 3, 12, 16, 7, 4
    d = h * dh
    z = lambda *s, t=dt: torch.zeros(s, dtype=t)
    f32 = lambda *s: z(*s, t=torch.float32)
    a, out, buf = tdl._prepare_self(
        z(b, d), f32(d), f32(d), z(h, d, 3 * dh), z(h, dh, d),
        z(h, lmax, b, dh), z(h, lmax, b, dh), pos, h, None)
    bf16 = dt == torch.bfloat16
    assert out.shape == (b, d) and out.dtype == dt
    act = 2 if bf16 else 4
    sizes = dict(xn=b * d * act, qkv=h * b * (1 if bf16 else 3) * dh * 4,
                 ctx=h * b * dh * act)
    if not bf16:
        sizes["part"] = 4 * tds.gemm_workspace(b, tdl.self_products(d, h),
                                               False)
    assert tdl.self_scratch(b, d, h, bf16) == sizes
    _spans(a, buf, sizes)
    assert a.part_floats == sizes.get("part", 0) // 4
    assert (a.part is None) == bf16
    plan = tdl.self_plan(b, d, h)
    assert (a.qkv_cluster, a.qkv_kslice) == plan["qkv"]
    assert (a.out_cluster, a.out_heads) == plan["out"] == (8, 2)
    assert a.act_bf16 == int(bf16) and a.pos == pos


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16w", "int8w"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_head_args_one_scratch_allocation(dt, quantized):
    """xn and the (max, argmax) pairs (after the partial logits with f32)
    in one allocation; the K split handed over."""
    b, d, v = 5, 320, 384
    w = torch.zeros((d, v), dtype=torch.int8 if quantized else dt)
    scales = torch.ones((1, v)) if quantized else None
    a, tokens, buf = tdh._prepare(torch.zeros((b, d), dtype=dt),
                                  torch.ones(d), torch.zeros(d), w,
                                  torch.zeros(v), scales)
    bf16 = dt == torch.bfloat16
    assert tokens.shape == (b,) and tokens.dtype == torch.int32
    floats = tdh.head_workspace(b, d, v, bf16)
    if bf16:     # a pair per block: per column share of each tile
        plan = tdh.head_plan(b, d, v)
        assert floats == 2 * b * plan["pairs"] == 2 * b * plan["tiles"]
    else:
        assert floats == (tds.gemm_workspace(b, ((1, d, v, 0),), False)
                          + 2 * b * -(-v // tdh.HEAD_TILE_F32))
    _spans(a, buf, dict(xn=b * d * (2 if bf16 else 4), part=floats * 4))
    assert a.part_floats == floats
    assert (a.cluster, a.kslice) == tdh.head_plan(b, d, v)["split"] == (1, 320)
    assert a.w_i8 == int(quantized)
