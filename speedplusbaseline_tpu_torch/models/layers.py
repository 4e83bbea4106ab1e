"""Shared building blocks (counterpart of ``speedplusbaseline_tpu/models/
layers.py``): NCHW tensors in channels_last memory, torch-style symmetric
padding ``k // 2`` (not SAME), flax BatchNorm semantics.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, rank_world


def flax_default_init_(module: nn.Module) -> None:
    """Initialise ``module``'s Conv2d and Linear layers as flax's ``nn.Conv``
    and ``nn.Dense`` are by default, which every JAX model uses:
    ``lecun_normal`` kernels (a normal of variance 1 / fan_in truncated at
    two standard deviations, fan_in = the kernel's input channels per group
    times its window) and zero biases. torch's default (a uniform of
    variance 1 / (3 fan_in), uniform biases) leaves the untrained SPN's
    logits about 25x smaller and, where BatchNorm follows a conv, triples
    the update relative to the weight."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            # flax draws from a unit normal truncated at +-2, which has
            # standard deviation 0.8796..., then scales it to sqrt(1 / fan_in).
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class BatchNorm(nn.Module):
    """BatchNorm2d with flax's running-statistics update.

    Flax updates ``var`` with the BIASED batch variance; ``nn.BatchNorm2d``
    uses the unbiased one (n / (n - 1) larger; at n = B*H*W of 8 the two
    differ by 14%). The forward is ``F.batch_norm``; after it, the running
    variance is corrected to the biased update from the C-length vectors
    alone, with no second pass over the activation. Flax ``momentum=0.9`` is
    torch ``momentum=0.1``.

    Under data parallelism (a default process group), training mode
    normalizes with the statistics of the global batch, as the JAX step
    sharded over a mesh does: the per-channel sum(x) and sum(x^2) of this
    rank's rows, in f32 (or x's wider dtype), are summed over the ranks by
    an autograd-aware ``all_reduce`` (``parallel.all_reduce_sum``), and
    mean and biased variance follow flax's E[x^2] - E[x]^2 over the global
    count. Not ``nn.SyncBatchNorm``, whose running variance takes the
    unbiased update.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if rank_world() is not None:
            return self._global_batch_norm(x)
        m = self.momentum
        n = x.numel() // x.shape[1]
        # F.batch_norm updates a copy (its backward keeps the tensor it was
        # given, so the buffer itself must not change under it):
        # new = (1-m) old + m * unbiased; swap unbiased for biased.
        new_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new_var, self.weight,
                         self.bias, True, m, self.eps)
        with torch.no_grad():
            old = self.running_var
            self.running_var.copy_((1.0 - m) * old
                                   + (new_var - (1.0 - m) * old) * ((n - 1) / n))
        return y

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        c, world = x.shape[1], rank_world()[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                         xf.square().sum(dim=(0, 2, 3))]))
        n = x.numel() // c * world  # every rank holds as many rows
        mean = sums[:c] / n
        var = torch.clamp(sums[c:] / n - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_(m * var.to(self.running_var.dtype))
        scale = self.weight.to(xf.dtype) * torch.rsqrt(var + self.eps)
        shift = self.bias.to(xf.dtype) - mean * scale
        return (xf * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)).to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + optional activation (reference
    park2019.py:43-56)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1,
                 act: Optional[Callable] = F.relu):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                              padding=kernel_size // 2, groups=groups,
                              bias=False)
        self.bn = BatchNorm(out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class ConvDw(nn.Module):
    """Depthwise-separable conv block (reference park2019.py:32-58):
    3x3 depthwise + BN + ReLU, then 1x1 pointwise + BN + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, 3, stride, groups=in_ch)
        self.pw = ConvBN(in_ch, out_ch, 1, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NCHW space-to-depth with the reference's reorg channel order
    (park2019.py:74-79): out channel = (s_h*block + s_w)*C + c.
    ``F.pixel_unshuffle`` orders c*block^2 + s_h*block + s_w instead."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (b, s_h, s_w, c, h', w')
    return x.reshape(b, block * block * c, h // block, w // block)


def _leaky02(v):
    return F.leaky_relu(v, 0.2)


class RouterV2(nn.Module):
    """Skip-connection router (reference park2019.py:60-80): 1x1 conv + BN +
    LeakyReLU(0.2) on the high-res tap, space-to-depth reorg, concat with the
    low-res stream (reorg first)."""

    def __init__(self, in_ch: int, features: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = ConvBN(in_ch, features, 1, 1, act=_leaky02)

    def forward(self, x1, x2):
        x2 = space_to_depth(self.conv(x2), self.stride)
        return torch.cat([x2, x1], dim=1)


def _leaky01(v):
    return F.leaky_relu(v, 0.1)


class RouterV3(nn.Module):
    """Upsampling router (reference park2019.py:82-97): 1x1 conv + BN +
    LeakyReLU(0.1) on the low-res stream, a 2x bilinear upsample with
    half-pixel centres (``jax.image.resize(..., "bilinear")``, which is
    ``align_corners=False`` here; the reference's module would use
    ``align_corners=True`` but is never called), then concat with the
    high-res stream. KRN does not use it; it is kept, as the JAX package
    keeps it, for parity of the layer inventory."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = ConvBN(in_ch, features, 1, 1, act=_leaky01)

    def forward(self, x1, x2):
        x1 = F.interpolate(self.conv(x1), scale_factor=2, mode="bilinear",
                           align_corners=False)
        return torch.cat([x1, x2], dim=1)


class LocalResponseNorm(nn.Module):
    """``torch.nn.LocalResponseNorm`` semantics (spn.py:63,68), computed in
    f32 and cast back to x's dtype, as the flax module does: the channel axis
    is padded with size//2 leading and (size-1)//2 trailing zeros, and the
    denominator is (k + alpha * mean_window(x^2)) ** beta. Written out rather
    than ``F.local_response_norm``, whose ``avg_pool3d`` would run in bf16
    under the autocast."""

    def __init__(self, size: int = 2, alpha: float = 2e-5, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        C = x.shape[1]
        sq = F.pad(xf.square(), (0, 0, 0, 0, self.size // 2, (self.size - 1) // 2))
        mean = sum(sq[:, i:i + C] for i in range(self.size)) / self.size
        return (xf / torch.pow(self.k + self.alpha * mean, self.beta)).to(x.dtype)
