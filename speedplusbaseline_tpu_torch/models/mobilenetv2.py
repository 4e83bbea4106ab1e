"""MobileNetV2 feature extractor (counterpart of ``speedplusbaseline_tpu/
models/mobilenetv2.py``): torchvision's ``mobilenet_v2().features`` without
the final 1280-channel conv, with a skip tap at features[13]."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBN

# (expand_ratio t, out_channels c, repeats n, first_stride s) — the standard
# MobileNetV2 inverted-residual schedule (Sandler et al. 2018, Table 2).
_IR_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.use_res = stride == 1 and in_ch == features
        if expand_ratio != 1:
            self.expand = ConvBN(in_ch, hidden, 1, 1, act=F.relu6)
        else:
            self.expand = None
        self.depthwise = ConvBN(hidden, hidden, 3, stride, groups=hidden,
                                act=F.relu6)
        self.project = ConvBN(hidden, features, 1, 1, act=None)

    def forward(self, x):
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.depthwise(y))
        return x + y if self.use_res else y


class MobileNetV2Features(nn.Module):
    """features[0:18] of torchvision MobileNetV2 (stem + 17 IR blocks).

    Returns (final 320ch map, 96ch tap map after block ``tap_index``)."""

    def __init__(self, tap_index: int = 13):
        super().__init__()
        self.tap_index = tap_index
        self.stem = ConvBN(3, 32, 3, 2, act=F.relu6)
        in_ch, idx = 32, 1
        self.num_blocks = sum(n for (_, _, n, _) in _IR_SETTINGS)
        for (t, c, n, s) in _IR_SETTINGS:
            for i in range(n):
                self.add_module(f"block{idx}",
                                InvertedResidual(in_ch, c, s if i == 0 else 1, t))
                in_ch = c
                idx += 1

    def forward(self, x):
        x = self.stem(x)
        tap = None
        for idx in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{idx}")(x)
            if idx == self.tap_index:
                tap = x
        return x, tap
