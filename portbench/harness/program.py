"""What the harness takes from the program (``blt_vqg_tpu_torch``): its
configuration, its model with the benchmark's weights loaded, and its
kernel library.  Nothing else of the program is read: the weights, the
traffic and the checks are the benchmark's."""

from __future__ import annotations

import dataclasses

import torch

from portbench.harness.weights import make_weights


def port_config(model: dict, overrides: dict):
    """The program's ``Config`` from the configuration's ``model`` keys and
    the traffic's ``overrides`` (keys the Config does not have are
    refused)."""
    from blt_vqg_tpu_torch.core.config import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    values = {**model, **overrides}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise KeyError(f"not fields of the program's Config: {unknown}")
    return Config(**values)


def load_library(device) -> None:
    """Builds (first run in a checkout) or loads the program's kernels."""
    if torch.device(device).type == "cuda":
        from blt_vqg_tpu_torch.ops.kernels import _build
        _build.library()


def build_model(cfg, vocab: int, model: dict, seed: int, device,
                cast: bool):
    """The program's ``IQ`` made on ``device`` with the benchmark's
    weights for ``seed`` (``load_state_dict``, strict), cast once to the
    compute dtype when ``cast`` (the served form)."""
    from blt_vqg_tpu_torch.models.iq import IQ
    with torch.device(device):
        net = IQ(cfg, vocab)
    weights = make_weights(model, vocab, seed, device)
    net.load_state_dict(weights, strict=True)
    del weights
    if cast:
        from blt_vqg_tpu_torch.ops.layers import cast_to_compute_dtype_
        cast_to_compute_dtype_(net)
    return net
