"""Serving loop of the PyTorch port (counterpart of
``examples/serve_decode.py``): restore or seed a model once, then answer
batches of requests (images + category contexts) with greedy decoding.

Usage:
    python -m blt_vqg_tpu_torch.serve --model-dir runs/big [--stream]
    python -m blt_vqg_tpu_torch.serve --seed 0 --stream   # seed-made weights

``--model-dir`` holds the JAX trainer's ``args.json`` and its npz
checkpoints under ``checkpoints/``.  The model runs on the CUDA card unless
``--device cpu`` asks for the CPU; without a card the default fails.  Without it the model is the flagship
configuration (hidden 1024, 6 layers, 8 heads, FFN 2048, vocab 12,000,
bf16, int8 fused head) with weights made from ``--seed``.  ``--stream``
takes the streaming decode path through the stack kernel;
``stream_head_dtype`` comes from the configuration.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from blt_vqg_tpu_torch.convert import from_flax, load_npz
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops.layers import cast_to_compute_dtype_
from blt_vqg_tpu_torch.train.step import NUM_CATEGORIES, make_decode_step

FLAGSHIP_VOCAB = 12000


def flagship_config() -> Config:
    """The flagship model of ``bench.py`` with its measured-best serving
    head: int8 fused head over a bf16 stack."""
    return Config(
        emb_dim=300, hidden_dim=1024, latent_dim=1024, pwffn_dim=2048,
        num_layers=6, num_heads=8, input_mode="cat", dtype="bfloat16",
        image_size=224, stream_head_dtype="int8")


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of quietly running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no "
                           f"CUDA card (pass device='cpu' to run on the CPU)")
    return device


def build_model(model_dir=None, seed: int = 0, stream: bool = False,
                stream_weight_dtype: str = "bfloat16", device="cuda"):
    """Returns (cfg, model, latent_mode), the model in eval mode on
    ``device`` (the card unless the caller asks for the CPU) with its
    weights cast once to the compute dtype."""
    device = check_device(device)
    over = dict(use_stream_decode=stream,
                stream_weight_dtype=stream_weight_dtype)
    if model_dir is not None:
        cfg = Config.load(os.path.join(model_dir, "args.json")).replace(**over)
        params, stats, step = load_npz(os.path.join(model_dir, "checkpoints"))
        model = IQ(cfg, params["embed"]["embedding"].shape[0])
        model.load_state_dict(from_flax(params, stats))
        # the trainer's latent phase begins AT num_pretraining_steps
        latent = step is not None and step >= cfg.num_pretraining_steps
    else:
        cfg = flagship_config().replace(**over)
        model = IQ(cfg, FLAGSHIP_VOCAB)
        model.init_weights(torch.Generator().manual_seed(seed))
        latent = True
    cast_to_compute_dtype_(model)
    return cfg, model.to(device).eval(), latent


def make_requests(rng: np.random.RandomState, batch: int, cfg: Config,
                  device="cuda"):
    """A batch of random images [B, S, S, 3] and category contexts
    ``[<start>, cat_word, <end>]``."""
    images = rng.rand(batch, cfg.image_size, cfg.image_size, 3
                      ).astype(np.float32)
    cats = rng.randint(0, NUM_CATEGORIES, (batch,))
    context = np.zeros((batch, cfg.max_context_len), np.int32)
    context[:, 0] = 1
    context[:, 1] = 6 + cats
    context[:, 2] = 3
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(context).to(device))


def serve_rounds(cfg: Config, model, latent: bool, batch: int, rounds: int,
                 seed: int, device, log=print):
    """Answers ``rounds`` request batches.  Round r draws its requests from
    ``RandomState(seed)`` in order and its z noise from a generator seeded
    ``seed + r``.  Returns one dict per round (images, context, tokens
    [B, L] on the host, z_seed, seconds)."""
    decode = make_decode_step(cfg, model, latent_mode=latent,
                              with_probe=False)
    rng = np.random.RandomState(seed)
    dev = torch.device(device)
    out = []
    for r in range(rounds):
        images, context = make_requests(rng, batch, cfg, dev)
        gen = torch.Generator(dev).manual_seed(seed + r)
        t0 = time.perf_counter()
        tokens = decode(images, context, gen)["tokens"].cpu()  # sync point
        dt = time.perf_counter() - t0
        log(f"round {r}: {batch} questions in {dt * 1000:.1f} ms "
            f"({batch / dt:.1f} q/s incl. host round trip); first rows "
            f"{tokens[:2, :8].tolist()}")
        out.append({"images": images, "context": context, "tokens": tokens,
                    "z_seed": seed + r, "seconds": dt})
    return out


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--stream", action="store_true",
                        help="whole-stack streaming decode kernel")
    parser.add_argument("--stream-weight-dtype", default="bfloat16",
                        choices=("bfloat16", "int8"))
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the CUDA card; there "
                        "is no fallback to the CPU)")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    cfg, model, latent = build_model(args.model_dir, args.seed, args.stream,
                                     args.stream_weight_dtype, args.device)
    return serve_rounds(cfg, model, latent, args.batch, args.rounds,
                        args.seed, args.device)


if __name__ == "__main__":
    main()
