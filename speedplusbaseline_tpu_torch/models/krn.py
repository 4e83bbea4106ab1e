"""Keypoint Regression Network (counterpart of ``speedplusbaseline_tpu/
models/krn.py``; reference park2019.py:101-165).

MobileNetV2 backbone + depthwise-separable extras + RouterV2 skip + a
full-map VALID head conv producing 2K scalars, the normalized (x, y) of K
keypoints.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvDw, RouterV2, flax_default_init_
from .mobilenetv2 import MobileNetV2Features


class KeypointRegressionNet(nn.Module):
    """``input_shape`` (H, W) fixes the head's kernel: the full (H/32, W/32)
    map, which is the reference's 7x7 at 224^2 (flax sizes it at trace
    time). The weights start as flax's defaults (``flax_default_init_``)."""

    def __init__(self, num_keypoints: int = 11,
                 input_shape: Sequence[int] = (224, 224)):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.base = MobileNetV2Features()
        self.extra0 = ConvDw(320, 1024)
        self.extra1 = ConvDw(1024, 1024)
        self.router = RouterV2(96, 64)
        self.extra3 = ConvDw(4 * 64 + 1024, 1024)
        hk, wk = -(-input_shape[0] // 32), -(-input_shape[1] // 32)
        self.head = nn.Conv2d(1024, 2 * num_keypoints, (hk, wk))
        flax_default_init_(self)

    def forward(self, x, return_features: bool = False):
        """(B, 3, H, W) images in [0, 1] -> (xc, yc), each (B, K) float32,
        and with ``return_features`` also the backbone's 320-channel map
        (B, 320, H/32, W/32), which DANN's domain head reads. The input is
        cast to the parameters' dtype, as the flax module casts it to its
        ``dtype`` (under autocast the convs then run in bf16)."""
        feat, tap = self.base(x.to(self.head.weight.dtype))
        y = self.extra1(self.extra0(feat))
        y = self.extra3(self.router(y, tap))
        y = self.head(y).reshape(x.shape[0], 2 * self.num_keypoints).float()
        if return_features:
            return y[:, 0::2], y[:, 1::2], feat
        return y[:, 0::2], y[:, 1::2]


def krn_loss(xc, yc, target):
    """Per-keypoint MSE, batch-mean then summed over keypoints and over x/y
    (park2019.py:146-162). target: (B, 2, K)."""
    loss_x = torch.sum(torch.mean((xc - target[:, 0, :]) ** 2, dim=0))
    loss_y = torch.sum(torch.mean((yc - target[:, 1, :]) ** 2, dim=0))
    return loss_x + loss_y, {"loss_x": loss_x, "loss_y": loss_y}
