"""Style predictor, InceptionV3 cut at Mixed_6e (counterpart of
``speedplusbaseline_tpu/models/style_predictor.py``; reference
src/styleaug/stylePredictor.py:6-243).

Offline only: it maps images to 100-dim style embeddings, from which
``python -m speedplusbaseline_tpu_torch.embedding`` computes the SPEED+
embedding mean and covariance that the style augmentor samples from. The
trunk is the stem convs, 3x InceptionA, InceptionB and 4x InceptionC,
mean-pooled to 768 features, then Linear(768 -> 100).

Submodules carry flax's names, which are the reference's (``Conv2d_1a_3x3``
... ``Mixed_6e``, ``branch*``, ``conv`` / ``bn`` in each BasicConv2d,
``fc``), so a reference ``state_dict`` loads unchanged but for its
``num_batches_tracked`` entries. In ``convert.py`` this model's ``conv`` /
``bn`` are flax's own names (``state_dict_to_flax(...,
flax_auto_names=False)``).

Keeps the reference's double preprocessing (stylePredictor.py:32-41): the
ImageNet normalization with the 0.255-for-0.225 typo, then the torchvision
Inception re-normalization, in f32. Runs in f32; BatchNorm eps is 1e-3 and
the eval forward uses the running statistics.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, flax_default_init_

EMBED_DIM = 100

_MEAN1 = (0.485, 0.456, 0.406)
_STD1 = (0.229, 0.224, 0.255)  # the reference's typo for 0.225, kept on purpose
_SCALE2 = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_SHIFT2 = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + ReLU (stylePredictor.py:232-243)."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm(features, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        d = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), d, _max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        d = x
        for i in range(1, 6):
            d = getattr(self, f"branch7x7dbl_{i}")(d)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, d, bp], dim=1)


class StylePredictor(nn.Module):
    """(B, 3, H, W) images in [0, 1] -> (B, 100) f32 style embeddings. H and W
    must be at least 43, the least input that leaves Mixed_6a a pixel. The
    weights start as flax's defaults (``flax_default_init_``)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean1", torch.tensor(_MEAN1).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std1", torch.tensor(_STD1).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale2", torch.tensor(_SCALE2).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("shift2", torch.tensor(_SHIFT2).view(1, 3, 1, 1), persistent=False)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.fc = nn.Linear(768, EMBED_DIM)
        flax_default_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.float() - self.mean1) / self.std1
        x = x * self.scale2 + self.shift2
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))
