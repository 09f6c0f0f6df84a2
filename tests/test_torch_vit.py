"""The port's ViT-B/16 image encoder (``ops/vit.py``) against the JAX
package.

- ``ViTBackbone`` at a small depth and width (2 layers of 32 over 4
  heads, 16x16 patches of 32x32 images): the CLS feature within 1e-5 of
  its scale.
- ``IQ`` with ``image_encoder="vit_b16"`` (the full ViT-B/16: 12 layers of
  768 over 12 heads) in train mode, latent phase: logits, z_logit, kld and
  the image features and their reconstruction, within 1e-5 (2e-3 for what
  is computed from the train-mode batch norm's features, see
  tests/test_torch_train.py).
- The frozen mask: the JAX optimizer's ``_is_frozen_path`` and the port's
  ``is_frozen`` freeze the same parameters (the whole backbone).

Weights are made in the port from a seed and carried to flax with
``convert.to_flax``; f32, every dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.ops.vit import ViTBackbone as JaxViTBackbone
from blt_vqg_tpu.train.state import _is_frozen_path
from blt_vqg_tpu_torch.convert import _port_name, to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops.layers import init_weights_
from blt_vqg_tpu_torch.ops.vit import ViTBackbone
from blt_vqg_tpu_torch.train.state import is_frozen
from blt_vqg_tpu_torch.train.step import make_batch
from test_torch_moe import perturbed
from test_torch_train import (FEATURE_TOL, TINY, TOL, VOCAB, assert_close,
                              jax_eps)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH, SEED = 4, 13
VIT = dict(image_encoder="vit_b16")


def test_vit_backbone_matches_jax():
    depth, dim, heads, mlp = 2, 32, 4, 64
    port = init_weights_(ViTBackbone(32, 16, depth, dim, heads, mlp,
                                     torch.float32),
                         torch.Generator().manual_seed(2))
    r = np.random.RandomState(3)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if p.ndim == 1:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(torch.from_numpy(
                    base + 0.1 * r.randn(*p.shape).astype(np.float32)))
        port.cls_token.copy_(torch.from_numpy(
            0.1 * r.randn(1, 1, dim).astype(np.float32)))
    images = r.rand(3, 32, 32, 3).astype(np.float32)
    params, _ = to_flax(port.state_dict())
    want = JaxViTBackbone(16, depth, dim, heads, mlp, jnp.float32).apply(
        {"params": params}, images)
    got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.shape == (3, dim)
    assert_close(got.detach(), want, TOL, "cls feature")


@pytest.fixture(scope="module")
def vit_setup():
    weights = perturbed(IQ(Config(**TINY, **VIT), VOCAB), SEED)
    params, stats = to_flax(weights)
    batch = make_batch(Config(**TINY), VOCAB, BATCH,
                       np.random.RandomState(SEED), device="cpu")
    return {"weights": weights, "variables": {"params": params,
                                              "batch_stats": stats},
            "batch": batch,
            "np_batch": {k: v.numpy() for k, v in batch.items()}}


def test_iq_vit_forward_matches_jax(vit_setup):
    s = vit_setup
    cfg = JaxConfig(**TINY, **VIT)
    key = jax.random.key(5)
    b = s["np_batch"]
    outs, _ = jax.jit(lambda v: JaxIQ(cfg, VOCAB).apply(
        v, b["images"], b["context"], b["posterior"], b["target"],
        latent_mode=True, train=True,
        rngs={"latent": key, "dropout": jax.random.fold_in(key, 1)},
        mutable=["batch_stats"]))(s["variables"])
    model = IQ(Config(**TINY, **VIT), VOCAB)
    model.load_state_dict(s["weights"])
    assert model.encoder_cnn.backbone.depth == 12
    eps = torch.from_numpy(jax_eps(s["variables"], cfg, key))
    tb = s["batch"]
    with torch.no_grad():
        logits, z_logit, kld, (feat, recon) = model(
            tb["images"], tb["context"], tb["posterior"], tb["target"],
            latent_mode=True, train=True, eps=eps,
            generator=torch.Generator().manual_seed(0))
    w_logits, w_z, w_kld, (w_feat, w_recon) = outs
    assert_close(logits, w_logits, TOL, "logits")
    assert_close(z_logit, w_z, FEATURE_TOL, "z_logit")
    assert_close(kld, w_kld, TOL, "kld")
    assert_close(feat, w_feat, FEATURE_TOL, "image features")
    assert_close(recon, w_recon, TOL, "recon")


def test_vit_frozen_mask_matches_jax(vit_setup):
    jmodel = JaxIQ(JaxConfig(**TINY, **VIT), VOCAB)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "latent": jax.random.key(1),
         "dropout": jax.random.key(2)},
        *(vit_setup["np_batch"][k] for k in ("images", "context",
                                             "posterior", "target")),
        latent_mode=True))
    jax_frozen = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = [p.key for p in path]
        if _is_frozen_path(path):
            jax_frozen.add(_port_name(keys[:-1], keys[-1]))
    port_names = [n for n, _ in IQ(Config(**TINY, **VIT),
                                   VOCAB).named_parameters()]
    port_frozen = {n for n in port_names if is_frozen(n)}
    assert port_frozen == jax_frozen
    assert "encoder_cnn.backbone.pos_embed" in port_frozen
    assert not any(n.startswith(("encoder_cnn.fc.", "encoder_cnn.feat_bn."))
                   for n in port_frozen)
