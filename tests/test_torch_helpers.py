"""The port's public helpers against the JAX functions on the same numpy
inputs (f32, rtol 1e-6), and the train step's device-side guard.

- ``train/losses.py``: ``gaussian_kl_to_unit``, ``vae_loss``,
  ``sequence_lengths`` and ``two_gaussian_kl`` (with its epsilons and its
  sum-then-divide reduction);
- ``ops/masks.py``: ``decoder_mask`` and ``apply_mask``;
- ``core/debug.py``: ``is_finite_tree`` and ``guarded_update`` on trees
  with finite and non-finite leaves and losses;
- ``train/step.py`` under ``guard_nonfinite``: a step whose loss is not
  finite keeps every parameter, moment, master and batch statistic and the
  Adam count bit for bit (what the host-side guard kept), while the step
  and kliter advance; a finite guarded step equals the unguarded one bit
  for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core import debug as jdebug
from blt_vqg_tpu.ops import masks as jmasks
from blt_vqg_tpu.train import losses as jlosses
from blt_vqg_tpu_torch.core import debug
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops import masks
from blt_vqg_tpu_torch.train import losses
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import make_batch, make_train_step

RTOL = 1e-6
TINY = dict(emb_dim=8, hidden_dim=16, latent_dim=12, pwffn_dim=32,
            num_layers=1, num_heads=2, batch_size=4, image_size=24,
            max_q_length=8, dtype="float32", guard_nonfinite=True)
VOCAB = 32


def _f(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0)


def test_loss_helpers_match_jax():
    r = np.random.RandomState(0)
    mu, lv, mu2, lv2 = (_f(r, 4, 6) for _ in range(4))
    logits = _f(r, 4, 5, 11)
    tokens = r.randint(0, 11, (4, 5))
    tokens[:, -2:] = 0
    t = torch.from_numpy
    _close(losses.gaussian_kl_to_unit(t(mu), t(lv)),
           jlosses.gaussian_kl_to_unit(jnp.asarray(mu), jnp.asarray(lv)))
    _close(losses.vae_loss(t(logits), t(tokens), t(mu), t(lv)),
           jlosses.vae_loss(jnp.asarray(logits), jnp.asarray(tokens),
                            jnp.asarray(mu), jnp.asarray(lv)))
    np.testing.assert_array_equal(
        losses.sequence_lengths(t(tokens)).numpy(),
        np.asarray(jlosses.sequence_lengths(jnp.asarray(tokens))))
    _close(losses.two_gaussian_kl(t(mu), t(lv), t(mu2), t(lv2)),
           jlosses.two_gaussian_kl(*map(jnp.asarray, (mu, lv, mu2, lv2))))
    # identical gaussians: 0 (the epsilons leave a rounding residue)
    assert abs(float(losses.two_gaussian_kl(t(mu), t(lv), t(mu),
                                            t(lv)))) < 1e-5


def test_mask_helpers_match_jax():
    r = np.random.RandomState(1)
    tokens = r.randint(0, 6, (3, 7))
    got = masks.decoder_mask(torch.from_numpy(tokens))
    want = np.asarray(jmasks.decoder_mask(jnp.asarray(tokens)))
    assert got.shape == want.shape and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    logits = _f(r, 3, 1, 7, 7)
    np.testing.assert_array_equal(
        masks.apply_mask(torch.from_numpy(logits), got).numpy(),
        np.asarray(jmasks.apply_mask(jnp.asarray(logits), jnp.asarray(want))))
    assert masks.apply_mask(torch.from_numpy(logits), None) is not None


@pytest.mark.parametrize("bad", [None, "nan", "inf"])
def test_debug_helpers_match_jax(bad):
    r = np.random.RandomState(2)
    old = {"w": _f(r, 3, 2), "n": {"b": _f(r, 4)}, "i": np.arange(3)}
    new = {"w": _f(r, 3, 2), "n": {"b": _f(r, 4)}, "i": np.arange(3) + 1}
    loss = np.float32(1.5)
    if bad is not None:
        new["n"]["b"][1] = float(bad)
        loss = np.float32(bad)
    tt = lambda tree: {k: tt(v) if isinstance(v, dict)
                       else torch.from_numpy(np.asarray(v))
                       for k, v in tree.items()}
    jt = lambda tree: {k: jt(v) if isinstance(v, dict) else jnp.asarray(v)
                       for k, v in tree.items()}
    assert bool(debug.is_finite_tree(tt(new))) == bool(
        jdebug.is_finite_tree(jt(new)))
    got, gm = debug.guarded_update(tt(old), tt(new),
                                   {"loss": torch.tensor(loss)})
    want, wm = jdebug.guarded_update(jt(old), jt(new),
                                     {"loss": jnp.asarray(loss)})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"]["b"].numpy(),
                                  np.asarray(want["n"]["b"]))
    np.testing.assert_array_equal(got["i"].numpy(), np.asarray(want["i"]))
    assert float(gm["skipped_nonfinite"]) == float(wm["skipped_nonfinite"])


def _state(cfg):
    return create_train_state(cfg, IQ(cfg, VOCAB), seed=0)


def _snapshot(state):
    opt = state.opt_state
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {f: {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                     else v.clone()) for k, v in getattr(opt, f).items()}
             for f in ("mu", "nu", "master")}, opt.count)


def _same(a, b) -> bool:
    (sa, oa, ca), (sb, ob, cb) = a, b
    flat = lambda d: [t for v in d.values()
                      for t in (v if isinstance(v, tuple) else (v,))]
    return (ca == cb and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for f in oa
                    for x, y in zip(flat(oa[f]), flat(ob[f]))))


def test_guarded_step_keeps_the_state_on_a_nonfinite_loss():
    torch.set_num_threads(1)
    cfg = Config(**TINY)
    batch = make_batch(cfg, VOCAB, 4, np.random.RandomState(0), device="cpu")
    guarded, plain = _state(cfg), _state(cfg.replace(guard_nonfinite=False))
    guarded, m = make_train_step(cfg, True)(
        guarded, batch, torch.Generator().manual_seed(1))
    plain, _ = make_train_step(cfg.replace(guard_nonfinite=False), True)(
        plain, batch, torch.Generator().manual_seed(1))
    assert float(m["skipped_nonfinite"]) == 0.0
    assert _same(_snapshot(guarded), _snapshot(plain))
    before = _snapshot(guarded)
    step, kliter = guarded.step, guarded.kliter
    # infinite posterior noise: a non-finite loss and gradients
    eps = torch.full((4, cfg.latent_dim), float("inf"))
    guarded, m = make_train_step(cfg, True)(
        guarded, batch, torch.Generator().manual_seed(2), eps=eps)
    assert not bool(torch.isfinite(m["loss"]))
    assert float(m["skipped_nonfinite"]) == 1.0
    assert _same(_snapshot(guarded), before)
    assert (guarded.step, guarded.kliter) == (step + 1, kliter + 1)
