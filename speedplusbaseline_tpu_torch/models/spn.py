"""Spacecraft Pose Network (counterpart of ``speedplusbaseline_tpu/models/
spn.py``; reference spn.py:50-143).

AlexNet-style trunk (grouped convs + LocalResponseNorm) with two FC branches
off the flattened pool5 tensor: attitude classification (fc6-7-8,
``num_classes`` logits) and attitude regression "weights" (fc9-10-11).
Submodules carry the flax names (conv1..conv5, fc6..fc11), so
``convert.py`` maps the JAX parameter tree without a rule of its own.

pool5 is flattened in HWC order, as flax flattens its NHWC tensor, so the
converted fc6/fc9 kernels line up; in channels_last memory the NHWC view is
the storage itself. A CHW flatten would be silently wrong wherever pool5 is
larger than 1x1.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LocalResponseNorm

# (name, in, out, kernel, stride, padding, groups) of the trunk.
_CONVS = (("conv1", 3, 96, 11, 4, 0, 1), ("conv2", 96, 256, 5, 1, 2, 2),
          ("conv3", 256, 384, 3, 1, 1, 1), ("conv4", 384, 384, 3, 1, 1, 2),
          ("conv5", 384, 256, 3, 1, 1, 2))


def _pooled(n: int) -> int:
    """Side of pool5 for an input side n: conv1 (11, stride 4), then the
    three VALID 3x3 / 2 max pools; the other convs keep the size."""
    n = (n - 11) // 4 + 1
    for _ in range(3):
        n = (n - 3) // 2 + 1
    return n


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            training: bool, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Drop each element with probability ``p`` and scale the survivors by
    1 / (1 - p), with the mask drawn from ``generator``; the identity in eval
    mode and at p = 0. With ``rows`` = (offset, total), ``x`` holds rows
    offset: of a batch of ``total``: the mask of the whole batch is drawn
    and those rows kept, so the ranks of a data-parallel step draw the masks
    of the one-process step."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    offset, total = rows or (0, x.shape[0])
    keep = torch.rand((total, *x.shape[1:]), generator=generator, device=x.device) >= p
    return x * keep[offset:offset + x.shape[0]].to(x.dtype) / (1.0 - p)


class SpacecraftPoseNet(nn.Module):
    """``keep_prob`` keeps the reference's name; it is torch Dropout's drop
    probability. ``input_shape`` (H, W) fixes fc6/fc9's input width (9216 at
    227^2, as flax sizes it at trace time)."""

    def __init__(self, num_classes: int = 5000, keep_prob: float = 0.5,
                 input_shape: Sequence[int] = (227, 227)):
        super().__init__()
        self.keep_prob = keep_prob
        for name, cin, cout, k, s, p, g in _CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, k, s, p, groups=g))
        self.norm1 = LocalResponseNorm()
        self.norm2 = LocalResponseNorm()
        flat = 256 * _pooled(input_shape[0]) * _pooled(input_shape[1])
        for a, b, c in (("fc6", "fc7", "fc8"), ("fc9", "fc10", "fc11")):
            self.add_module(a, nn.Linear(flat, 4096))
            self.add_module(b, nn.Linear(4096, 4096))
            self.add_module(c, nn.Linear(4096, num_classes))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None):
        """(B, 3, H, W) images in [0, 1] -> (classes, weights), each
        (B, num_classes) float32. The input is cast to the parameters' dtype,
        as the flax module casts it to its ``dtype``; in train mode the four
        dropout masks come from ``generator`` (``rows``: see ``dropout``)."""
        x = x.to(self.conv1.weight.dtype)
        x = self.norm1(_maxpool(F.relu(self.conv1(x))))
        x = self.norm2(_maxpool(F.relu(self.conv2(x))))
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = _maxpool(F.relu(self.conv5(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # HWC, as flax

        def drop(y):
            return dropout(y, self.keep_prob, generator, self.training, rows)

        c = drop(F.relu(self.fc6(x)))
        c = drop(F.relu(self.fc7(c)))
        c = self.fc8(c).float()
        r = drop(F.relu(self.fc9(x)))
        r = drop(F.relu(self.fc10(r)))
        r = self.fc11(r).float()
        return c, r


def softmax_cross_entropy_with_logits(logits, target, reduction: str = "mean"):
    """TF-semantics soft-label cross-entropy (reference spn.py:37-48),
    the target detached: loss_i = -sum_c target[i, c] * log_softmax(logits)[i, c]."""
    loss = -torch.sum(target.detach() * F.log_softmax(logits, dim=1), dim=1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def spn_loss(classes, weights, y_classes, y_weights):
    """SPN training loss (reference trainer.py:152-165): loss_class +
    10 * loss_regress, both soft-label cross-entropies."""
    loss_c = softmax_cross_entropy_with_logits(classes, y_classes)
    loss_r = softmax_cross_entropy_with_logits(weights, y_weights)
    return loss_c + 10.0 * loss_r, {"loss_c": loss_c, "loss_r": loss_r}
