"""DANN model: KRN with a gradient-reversed domain classifier (counterpart
of ``speedplusbaseline_tpu/models/revgrad.py``; reference revgrad.py:36-96).

The reference captures the 320-channel backbone map with a forward hook;
here ``KeypointRegressionNet.forward(x, return_features=True)`` returns it.
The gradient reversal layer is the identity forward and multiplies the
gradient by -alpha backward. The submodules keep flax's names, ``net`` and
``domain_classifier`` (``conv0``, ``conv1``), so ``convert.py`` carries a JAX
DANN checkpoint across unchanged.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io_utils.spans import span
from .krn import KeypointRegressionNet
from .layers import flax_default_init_


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Identity forward; the backward multiplies the gradient by -alpha and
    gives alpha no gradient. ``alpha`` is a number (the loop passes an
    np.float32); f32 gradients are scaled in f32."""
    return _GradReverse.apply(x, float(alpha))


class DomainClassifier(nn.Module):
    """1x1 conv 320 -> 1280, ReLU, the mean over the whole map, 1x1 conv
    1280 -> 1: (B,) f32 logits. The mean is the reference's AvgPool2d(7) at
    224^2 and stays a global mean at any other size, as in JAX. The weights
    start as flax's defaults (``flax_default_init_``)."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(320, 1280, 1)
        self.conv1 = nn.Conv2d(1280, 1, 1)
        flax_default_init_(self)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(feat.to(self.conv0.weight.dtype)))
        x = self.conv1(x.mean(dim=(2, 3), keepdim=True))
        return x.reshape(x.shape[0]).float()


class RevGrad(nn.Module):
    """``forward(x)`` returns KRN's (xc, yc); ``forward(x, alpha)`` returns
    ((xc, yc), domain logits), the domain head reading the backbone map
    through the gradient reversal layer."""

    def __init__(self, num_keypoints: int = 11, input_shape: Sequence[int] = (224, 224)):
        super().__init__()
        self.net = KeypointRegressionNet(num_keypoints, input_shape)
        self.domain_classifier = DomainClassifier()

    def forward(self, x, alpha=None):
        xc, yc, feat = self.net(x, return_features=True)
        if alpha is None:
            return xc, yc
        # The reversal acts on the f32 map, as JAX's ``feat.astype(float32)``;
        # the head then casts it to its own dtype.
        with span("speedplus.domain"):
            return (xc, yc), self.domain_classifier(grad_reverse(feat.float(), alpha))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss(reduction='mean'): the mean over the batch."""
    return F.binary_cross_entropy_with_logits(logits, targets)
