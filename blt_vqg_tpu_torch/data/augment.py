"""Image augmentation on the batch's device (counterpart of
``blt_vqg_tpu/data/augment.py``).

The batch goes to the device once (uint8 or f32) and the crop, resize and
normalisation run there as a few batched tensor operations: per-example
random crop geometry, a bilinear resample of each crop box by four batched
gathers and a lerp (:func:`_batched_crop_resize`, the JAX package's
algorithm), then ImageNet mean/std normalisation.  The crop boxes are drawn
from an explicit ``torch.Generator``; in a sharded step each rank draws
the global batch's boxes and keeps its rows' (``collectives.draw``).

As in the JAX package, ``scale`` is the area fraction of the image and the
default (1.0, 1.2) asks for crops at least as large as the image: the
sampled box is clamped inside it, so those configurations are close to a
full-image resize, and scale <= 1.0 behaves like RandomResizedCrop.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from blt_vqg_tpu_torch.parallel import collectives as col

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] float in [0,1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _sample_crop_boxes(generator: torch.Generator, batch: int, in_size: int,
                       scale: Tuple[float, float],
                       ratio: Tuple[float, float], device=None):
    """Per-example (y0, x0, h, w) [B] f32 in input pixels, clamped to the
    image; drawn on ``device`` (the generator's by default)."""
    device = generator.device if device is None else device

    def uniform(lo: float, hi: float):
        u = col.draw(torch.rand, (batch,), generator, device)
        return lo + u * (hi - lo)

    area_frac = uniform(scale[0], scale[1])
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    target_area = area_frac * float(in_size * in_size)
    w = torch.clamp(torch.sqrt(target_area * aspect), 8.0, float(in_size))
    h = torch.clamp(torch.sqrt(target_area / aspect), 8.0, float(in_size))
    y0 = uniform(0.0, 1.0) * (in_size - h)
    x0 = uniform(0.0, 1.0) * (in_size - w)
    return y0, x0, h, w


def _batched_crop_resize(x: torch.Tensor, y0, x0, h, w,
                         out_size: int) -> torch.Tensor:
    """Bilinear-resamples per-example crop boxes, fully batched.

    x [B, S, S, C] f32; y0/x0/h/w [B] crop geometry in input pixels.
    Returns [B, out, out, C]."""
    b, in_size = x.shape[0], x.shape[1]
    # sample centers in input coordinates: [B, out]
    u = (torch.arange(out_size, dtype=torch.float32, device=x.device)
         + 0.5) / out_size
    ys = y0[:, None] + u[None, :] * h[:, None] - 0.5
    xs = x0[:, None] + u[None, :] * w[:, None] - 0.5
    y0i = torch.clamp(torch.floor(ys).long(), 0, in_size - 1)
    x0i = torch.clamp(torch.floor(xs).long(), 0, in_size - 1)
    y1i = torch.clamp(y0i + 1, 0, in_size - 1)
    x1i = torch.clamp(x0i + 1, 0, in_size - 1)
    fy = torch.clamp(ys - y0i.float(), 0.0, 1.0)[:, :, None, None]
    fx = torch.clamp(xs - x0i.float(), 0.0, 1.0)[:, None, :, None]

    bi = torch.arange(b, device=x.device)[:, None, None]

    def grab(yi, xi):  # [B, out, out, C]
        return x[bi, yi[:, :, None], xi[:, None, :], :]

    top = grab(y0i, x0i) * (1 - fx) + grab(y0i, x1i) * fx
    bot = grab(y1i, x0i) * (1 - fx) + grab(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def make_augment_fn(out_size: int = 224,
                    scale: Tuple[float, float] = (1.0, 1.2),
                    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
                    train: bool = True,
                    input_scale: float = 255.0):
    """Returns ``augment(images [B,S,S,3], generator) -> [B,o,o,3]`` f32 on
    the images' device.

    uint8 inputs are always divided by 255; float inputs by
    ``input_scale`` (255.0 matches the dataset schema's raw 0..255 float
    RGB; pass 1.0 for images already in [0, 1]).  The eval path
    (``train=False``) is a deterministic full-image resize and normalise,
    and takes no generator (pass None)."""

    def augment(images: torch.Tensor, generator=None) -> torch.Tensor:
        if images.dtype == torch.uint8:
            x = images.float() / 255.0
        else:
            x = images.float() / input_scale
        b, in_size = x.shape[0], x.shape[1]
        if train:
            y0, x0, h, w = _sample_crop_boxes(generator, b, in_size, scale,
                                              ratio, device=x.device)
            x = _batched_crop_resize(x, y0, x0, h, w, out_size)
        elif in_size != out_size:
            zeros = torch.zeros((b,), device=x.device)
            full = torch.full((b,), float(in_size), device=x.device)
            x = _batched_crop_resize(x, zeros, zeros, full, full, out_size)
        return normalize_images(x)

    return augment
