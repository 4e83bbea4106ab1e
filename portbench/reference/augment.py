"""The trainer's random draws, plain.

A step seeds one generator on the device from (seed, step) and draws, in
this order: the model's input augmentations where its reference has any
(``inputs``), the style normals (on a restyled step), then the model's own
draws inside the forward (SPN's dropout masks). Drawing the same shapes
from the same generator in the same order gives the same numbers, so the
reference repeats the draws rather than reading the program's.
"""
from __future__ import annotations

import torch

EMBED_DIM = 100


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The step's generator: seeded with (seed << 32) + step."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step)
    return gen


def style_normals(gen: torch.Generator, batch: int) -> torch.Tensor:
    return torch.randn((batch, EMBED_DIM), generator=gen, device=gen.device)


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 in [0, 1]."""
    return images_u8.permute(0, 3, 1, 2).float() / 255.0
