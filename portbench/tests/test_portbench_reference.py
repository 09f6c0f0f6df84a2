"""The reference agrees with the program's plain paths (CPU, tiny sizes,
float32), and each cell's whole run, check included, comes out correct
at a tiny size on the CPU."""

import pytest
import torch

from portbench.harness import cells, program
from portbench.harness.weights import make_weights
from portbench.reference.iq import PAD, RefIQ, int8_columns
from conftest import context, tiny


def _program(cell, seed=3, **over):
    cfg = program.port_config(cell.model, {**cell.traffic["overrides"],
                                           **over})
    return cfg, program.build_model(cfg, cell.config["vocab_size"],
                                    cell.model, seed, "cpu", cast=False)


def _batch(cell, b=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    s, v = cell.model["image_size"], cell.config["vocab_size"]
    tq = cell.model["max_q_length"]
    target = torch.randint(1, v, (b, tq), generator=g)
    target[0, 5:] = PAD
    post = torch.randint(1, v, (b, tq + 1), generator=g)
    post[1, 4:] = PAD
    return {"images": torch.rand((b, s, s, 3), generator=g),
            "context": torch.tensor([[1, 7, 3]] * b),
            "posterior": post, "target": target}


@pytest.mark.parametrize("encoder", ["resnet18", "vit_b16"])
def test_train_forward_matches_the_program(bench, encoder):
    # train-mode batch norm takes the batch's statistics: 8 images, and
    # 64 x 64 for the ResNet, so its last stage holds 32 values a channel
    cell = tiny(cells.find_cell("iq_big.train_b512", bench),
                image_encoder=encoder,
                image_size=64 if encoder == "resnet18" else 32)
    _, net = _program(cell)
    batch = _batch(cell, b=8)
    eps = torch.randn(8, cell.model["latent_dim"],
                      generator=torch.Generator().manual_seed(1))
    ref = RefIQ(make_weights(cell.model, 50, 3, "cpu"), cell.model)
    got = net(batch["images"], batch["context"], batch["posterior"],
              batch["target"], latent_mode=True, train=True,
              generator=torch.Generator().manual_seed(2), eps=eps)
    logits, z_logit, kld, feat, recon = ref.train_forward(batch, eps)
    for a, b in ((got[0], logits), (got[1], z_logit), (got[2], kld),
                 (got[3][0], feat), (got[3][1], recon)):
        assert torch.allclose(a, b, atol=5e-5 * (1 + b.abs().max()),
                              rtol=0), (a - b).abs().max()


def test_decode_logits_match_the_program():
    cell = tiny(cells.find_cell("iq_big.serve_stream_b256"))
    cfg, net = _program(cell, use_stream_decode=False)
    net.eval()
    batch = _batch(cell)
    eps = torch.randn(3, cell.model["latent_dim"],
                      generator=torch.Generator().manual_seed(1))
    prefix = torch.cat([torch.zeros(3, 1, dtype=torch.long),
                        batch["target"][:, :6]], 1)
    with torch.no_grad():
        want = net.inference_logits(batch["images"], batch["context"],
                                    prefix, latent_mode=True, eps=eps)
        ref = RefIQ(make_weights(cell.model, 50, 3, "cpu"),
                    dict(cell.model, stream_head_dtype="bfloat16"),
                    served=True)
        got = ref.decode_logits(batch["images"], batch["context"], eps,
                                prefix)
    assert torch.allclose(got, want, atol=1e-4, rtol=0)


def test_int8_columns_is_the_program_quantization():
    from blt_vqg_tpu_torch.ops.kernels.decode_stream import quantize_stack
    w = torch.randn(32, 50, generator=torch.Generator().manual_seed(0))
    w8, scale = quantize_stack(w)
    assert torch.equal(int8_columns(w), w8.float() * scale)


@pytest.mark.parametrize("name", ["iq_big.serve_stream_b256",
                                  "iq_big.train_b512"])
def test_whole_run_is_correct_at_a_tiny_size(bench, name):
    cell = tiny(cells.find_cell(name, bench))
    res = cells.entry(cell.traffic).run(context(cell, seed=2 ** 31 + 5))
    assert res["failed"] == 0 and res["units"] >= 2
    for key, (value, limit) in res["checks"].items():
        assert value <= min(limit, 1e-3), key


def test_noise_redrawn_for_the_reference_is_the_programs():
    """The serving check draws batch i's prior noise again from its seed:
    the same numbers the program draws from the generator it is given."""
    from portbench.entries import serve_stream
    cell = tiny(cells.find_cell("iq_big.serve_stream_b256"))
    _, net = _program(cell)
    x = torch.randn(3, cell.model["hidden_dim"])
    seed = serve_stream.z_seed(2 ** 33, 4)
    with torch.no_grad():
        drawn = net.latent(x, None,
                           generator=torch.Generator().manual_seed(seed))[1]
        eps = torch.randn((3, cell.model["latent_dim"]),
                          generator=torch.Generator().manual_seed(seed))
        given = net.latent(x, None, eps=eps)[1]
    assert torch.equal(drawn, given)
