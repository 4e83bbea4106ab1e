"""KRN's photometric augmentations, plain: the draws a training step makes
from its (seed, step) generator, and their effect on the images and the
keypoints (the SPEED+ baseline's ``transforms.py:38-110``).

Each image is changed independently, each augmentation with probability
p (the configuration's ``augment_p``, 0.5 in the recipe), in this order:

* rotate by k quarter turns, k uniform over {1, 2, 3}, counterclockwise as
  numpy's ``rot90`` over (H, W); a keypoint (x, y), normalized to the
  crop, turns once to (y, 1 - x);
* flip, left-right (x -> 1 - x) with p = 0.5, else upside down (y -> 1 - y);
* brightness and contrast: clip(a img + b, 0, 1), log a uniform on
  [log 1/2, log 2], b uniform on [-25, 25] / 255;
* Gaussian noise: clip(img + n 25 / 255, 0, 1), n a unit normal a pixel.

The draws are made for the whole batch, in this order of shapes: rotate's
coin (B), its k (B), flip's coin (B), its direction (B), brightness's coin
(B), a (B), b (B), noise's coin (B), the noise (B, 3, H, W). A step draws
them before the style normals. Drawing the same shapes from the same
generator in the same order gives the program's numbers.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

NOISE_STD = 25.0 / 255.0
LOG_A = (math.log(0.5), math.log(2.0))


def draw(gen: torch.Generator, batch: int, image_shape, p: float) -> Dict[str, torch.Tensor]:
    """The draws for a batch of images of ``image_shape`` (3, H, W)."""
    dev = gen.device

    def u():
        return torch.rand((batch,), generator=gen, device=dev)

    d = {"rot_on": u() < p,
         "rot_k": torch.randint(1, 4, (batch,), generator=gen, device=dev)}
    d["flip_on"] = u() < p
    d["flip_h"] = u() < 0.5
    d["bc_on"] = u() < p
    d["bc_a"] = torch.exp(u() * (LOG_A[1] - LOG_A[0]) + LOG_A[0])
    d["bc_b"] = (u() * 50.0 - 25.0) / 255.0
    d["noise_on"] = u() < p
    d["noise"] = torch.randn((batch, *image_shape), generator=gen, device=dev)
    return d


def apply(images: torch.Tensor, keypts: torch.Tensor, d: Dict[str, torch.Tensor]):
    """(B, 3, H, W) in [0, 1] and (B, 2, K) -> both augmented, image by
    image."""
    flags = {k: d[k].tolist() for k in ("rot_on", "rot_k", "flip_on", "flip_h", "bc_on",
                                        "noise_on")}
    out_images, out_keypts = [], []
    for i in range(images.shape[0]):
        img, x, y = images[i], keypts[i, 0], keypts[i, 1]
        if flags["rot_on"][i]:
            for _ in range(flags["rot_k"][i]):
                # out[:, r, c] = img[:, c, W - 1 - r]
                img = img.transpose(1, 2).flip(1)
                x, y = y, 1.0 - x
        if flags["flip_on"][i]:
            if flags["flip_h"][i]:
                img, x = img.flip(2), 1.0 - x
            else:
                img, y = img.flip(1), 1.0 - y
        if flags["bc_on"][i]:
            img = torch.clamp(d["bc_a"][i] * img + d["bc_b"][i], 0.0, 1.0)
        if flags["noise_on"][i]:
            img = torch.clamp(img + d["noise"][i] * NOISE_STD, 0.0, 1.0)
        out_images.append(img)
        out_keypts.append(torch.stack([x, y]))
    return torch.stack(out_images), torch.stack(out_keypts)
