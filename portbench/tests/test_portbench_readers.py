"""The per-layer readers and the trace reduction on a canned profiler
table (device operations with their times, as ``events()`` gives them)."""

from types import SimpleNamespace

import pytest
import torch

from portbench.counts import work
from portbench.harness import cells, readers, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
M = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
         num_layers=2, num_heads=4, image_size=32, image_encoder="resnet18",
         stream_weight_dtype="bfloat16", stream_head_dtype="int8",
         max_q_length=4)


def ev(name, start, end, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def canned():
    """Spins, then one decode position: the stack's LayerNorm and three
    of its kernels, the head's LayerNorm and product, a memcpy; then spins.
    Host events cover the gaps."""
    return [ev("void spin_kernel(long)", 0, 10),
            ev("void spin_kernel(long)", 10, 20),
            ev("void bvq::layernorm_kernel<__nv_bfloat16>(x)", 30, 40),
            ev("void bvq::gemm_partial_kernel<1>(y)", 40, 140),
            ev("void bvq::self_attn_kernel(z)", 150, 170),
            ev("void bvq::residual_ln_kernel(z)", 170, 190),
            ev("void bvq::layernorm_kernel<__nv_bfloat16>(x)", 200, 210),
            ev("void bvq::head_cluster_kernel(w)", 210, 250),
            ev("Memcpy DtoH (Device -> Pageable)", 260, 270),
            ev("void spin_kernel(long)", 300, 310),
            ev("aten::copy_", 250, 280, CPU),
            ev("cudaStreamSynchronize", 270, 300, CPU),
            ev("python step", 20, 300, CPU)]


def test_reduce_window_busy_and_gaps():
    t = trace.reduce(canned())
    assert t.window == (20, 300)
    assert [o[0][:20] for o in t.ops][0].startswith("void bvq::layernorm")
    busy = 10 + 100 + 20 + 20 + 10 + 40 + 10
    assert t.busy_s() == pytest.approx(busy / 1e6)
    assert t.gaps() == [(20, 30), (140, 150), (190, 200), (250, 260),
                        (270, 300)]
    assert t.host_at(285) == "cudaStreamSynchronize"
    assert t.host_at(25) == "python step"
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["void bvq::gemm_partial_kernel<1>(y)",
                                  pytest.approx(1e-4)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == pytest.approx({"python step": 30e-6, "aten::copy_": 10e-6,
                                  "cudaStreamSynchronize": 30e-6})
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_stack_time_leaves_out_the_head():
    t = trace.reduce(canned())
    assert readers.stack_seconds(t) == pytest.approx(150e-6)
    assert readers.family_seconds(t, ["head_cluster_kernel"]) == \
        pytest.approx(40e-6)
    assert not trace.whole_name("void bvq::self_attn_warp_kernel(x)",
                                "self_attn_kernel")


def test_idle_and_roofline_readers():
    t = trace.reduce(canned())
    data = {"trace": t, "batches": 1, "model": M, "batch": 2, "positions": 1,
            "tc": 3, "profiled_batches": 1, "vocab": 50, "window_s": 0.5}
    idle = cells.reader("device_idle_share.decode")(data)
    assert idle == pytest.approx(100 * (1 - t.busy_s() / t.window_s))
    assert cells.reader("device_idle_share.train")(data) is None
    roof = cells.reader("decode_stack_roofline")(data)
    bound = work.least_s(work.stack_call(M, 2, 0, 3, 1))
    assert roof == pytest.approx(100 * bound / 150e-6)
    mfu = cells.reader("decode_mfu")(data)
    least = sum(work.least_s(p) for p in work.decode_batch(M, 50, 2, 1, 3))
    assert mfu == pytest.approx(100 * least / 0.5)
    assert cells.reader("train_step_mfu")(data) is None
    assert cells.reader("flash_attention_roofline")(data) is None


def test_train_readers():
    tgt = torch.tensor([[5, 6, 0, 0], [7, 0, 0, 0]])
    batch = {"context": torch.tensor([[1, 8, 3], [1, 9, 3]]),
             "posterior": torch.tensor([[4, 4, 4, 0, 0], [4, 0, 0, 0, 0]]),
             "target": tgt}
    ops = [ev("void spin_kernel(long)", 0, 5),
           ev("void bvq::flash_fwd_mma_kernel<128>(a)", 10, 20),
           ev("void bvq::flash_bwd_dkdv_mma_kernel<128>(a)", 20, 40),
           ev("void bvq::flash_bwd_dq_mma_kernel<128>(a)", 40, 50),
           ev("ampere_bf16_gemm", 50, 90),
           ev("void spin_kernel(long)", 95, 99)]
    t = trace.reduce(ops)
    data = {"trace": t, "steps": 3, "model": M, "batch": 2, "vocab": 50,
            "window_s": 2.0, "tc": 3, "tp": 5, "tq": 4,
            "profiled_batches": [batch], "profiled_steps": 1}
    bound = 0.0
    for b, h, d, tq, pad, causal, calls in work.train_flash_calls(batch, M):
        assert calls == 2 and h == 4 and d == 8
        bound += calls * sum(work.least_s(w) for w in
                             work.flash_bounds(b, h, d, tq, pad,
                                               causal).values())
    got = cells.reader("flash_attention_roofline")(data)
    assert got == pytest.approx(100 * bound / 40e-6)
    mfu = cells.reader("train_step_mfu")(data)
    flops = work.train_step_flops(M, 50, 2, 3, 5, 4)
    assert mfu == pytest.approx(100 * flops * 3 / 2.0 / 989e12)
    assert cells.reader("device_idle_share.train")(data) == pytest.approx(
        100 * (1 - 80 / 90))
    assert cells.reader("image_encoder_ms.decode")(
        {"spans": {"image_encoder_ms": [1.0, 3.0]}}) == 2.0
    assert cells.reader("image_encoder_ms.decode")(data) is None
