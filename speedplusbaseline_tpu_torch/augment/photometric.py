"""Batched training augmentations (counterpart of ``speedplusbaseline_tpu/
augment/photometric.py``; reference transforms.py:38-110), split into a draw
step and an apply step.

``draw_augment`` takes every random number from a ``torch.Generator`` on the
device; ``apply_augment`` is a deterministic function of the images, the
keypoints and those draws, so a test can hand both frameworks the same
numbers. Semantics, per sample, each aug applied independently with p=0.5
in this order:

  * Rotate: k ~ uniform{1,2,3} quarter turns (``torch.rot90`` over (H, W),
    numpy's direction); keypoints (x,y) -> (y,1-x) / (1-x,1-y) / (1-y,x).
  * Flip: horizontal (x -> 1-x) with p=0.5, else vertical (y -> 1-y).
  * BrightnessContrast: a = exp(U[log .5, log 2]), b = U[-25, 25]/255,
    clip(a*img + b, 0, 1).
  * GaussianNoise: clip(img + N(0,1) * 25/255, 0, 1).

Images are (B, 3, H, W) float in [0, 1] with H == W; keypoints (B, 2, K).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

NOISE_STD = 25.0 / 255.0
_LOG_LO, _LOG_HI = math.log(0.5), math.log(2.0)


def draw_augment(generator: torch.Generator, batch: int, image_shape,
                 p: float = 0.5) -> Dict[str, torch.Tensor]:
    """Random draws for one batch; ``image_shape`` is (3, H, W)."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return {
        "rot_on": u(batch) < p,
        "rot_k": torch.randint(1, 4, (batch,), generator=generator, device=dev),
        "flip_on": u(batch) < p,
        "flip_h": u(batch) < 0.5,
        "bc_on": u(batch) < p,
        "bc_a": torch.exp(u(batch) * (_LOG_HI - _LOG_LO) + _LOG_LO),
        "bc_b": (u(batch) * 50.0 - 25.0) / 255.0,
        "noise_on": u(batch) < p,
        "noise": torch.randn((batch, *image_shape), generator=generator, device=dev),
    }


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample where(mask, a, b)."""
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def apply_augment(images: torch.Tensor, keypts: torch.Tensor,
                  d: Dict[str, torch.Tensor]):
    """Apply the aug stack with draws ``d``; returns (images, keypts)."""
    x, y = keypts[:, 0], keypts[:, 1]
    remaps = {1: (y, 1.0 - x), 2: (1.0 - x, 1.0 - y), 3: (1.0 - y, x)}
    out_img, out_x, out_y = images, x, y
    for k, (nx, ny) in remaps.items():
        m = d["rot_on"] & (d["rot_k"] == k)
        out_img = _sel(m, torch.rot90(images, k, dims=(2, 3)), out_img)
        out_x = _sel(m, nx, out_x)
        out_y = _sel(m, ny, out_y)
    images, x, y = out_img, out_x, out_y

    h = d["flip_on"] & d["flip_h"]
    v = d["flip_on"] & ~d["flip_h"]
    images = _sel(h, images.flip(3), _sel(v, images.flip(2), images))
    x = _sel(h, 1.0 - x, x)
    y = _sel(v, 1.0 - y, y)

    a = d["bc_a"].to(images.dtype).view(-1, 1, 1, 1)
    b = d["bc_b"].to(images.dtype).view(-1, 1, 1, 1)
    images = _sel(d["bc_on"], torch.clamp(a * images + b, 0.0, 1.0), images)

    noisy = torch.clamp(images + d["noise"].to(images.dtype) * NOISE_STD, 0.0, 1.0)
    images = _sel(d["noise_on"], noisy, images)
    return images.contiguous(memory_format=torch.channels_last), torch.stack([x, y], 1)
