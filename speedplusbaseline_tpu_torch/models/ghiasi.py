"""Ghiasi arbitrary-style-transfer generator (counterpart of
``speedplusbaseline_tpu/models/ghiasi.py``, plain lowering; reference
ghiasi.py:106-136).

Three unconditioned downsampling ConvInRelu layers, five FiLM-conditioned
residual blocks, two FiLM-conditioned upsample layers and a 9x9 output conv
+ sigmoid. FiLM gamma/beta = Linear(100 -> C) of the style embedding, in f32.

Every instance norm goes through ``ops.instance_norm_film`` (kernel B2 on
CUDA) and every residual block through ``ops.ghiasi_resblock`` (kernel B1 on
CUDA); there is no switch that turns them off on the card. The 9x9, strided
and upsample convs are plain ``F.conv2d``, as the JAX package leaves them to
XLA.

``dtype`` is the compute dtype, as the flax module's: the input and the conv
weights are cast to it, FiLM stays f32, and the output is the sigmoid cast to
``dtype``. Tensors are NCHW in channels_last memory; the kernels see the
(B, H, W, C) view of the same storage.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instancenorm import instance_norm_film
from ..ops.resblock import ghiasi_resblock

EMBED_DIM = 100


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride)


class ConvInRelu(nn.Module):
    """ReflectionPad + Conv + InstanceNorm + ReLU (ghiasi.py:6-23)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride)

    def forward(self, x):
        y = _conv(self.conv, reflect_pad(x, self.conv.kernel_size[0] // 2))
        return _nchw(instance_norm_film(_nhwc(y), relu=True))


class UpsampleConvInRelu(nn.Module):
    """Optional upsample + ReflectionPad + Conv + IN + FiLM (+ ReLU)
    (ghiasi.py:26-62)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 upsample: int = 0, use_relu: bool = True):
        super().__init__()
        self.upsample = upsample
        self.use_relu = use_relu
        self.fc_gamma = nn.Linear(EMBED_DIM, features)
        self.fc_beta = nn.Linear(EMBED_DIM, features)
        self.conv = nn.Conv2d(in_ch, features, kernel_size)

    def forward(self, x, style):
        gamma = self.fc_gamma(style)
        beta = self.fc_beta(style)
        if self.upsample:
            x = upsample_nearest(x, self.upsample)
        y = _conv(self.conv, reflect_pad(x, self.conv.kernel_size[0] // 2))
        return _nchw(instance_norm_film(_nhwc(y), gamma, beta, relu=self.use_relu))


class ResidualBlock(nn.Module):
    """Residual block with two FiLM-conditioned 3x3 convs (ghiasi.py:65-103),
    computed in f32 and returned in x's dtype, as the fused TPU kernel does.

    The kernel takes HWIO f32 conv weights. The block is frozen, so it holds
    them as non-persistent buffers, made at init and remade after every
    ``load_state_dict``, rather than permuting both weights on every call."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3)
        self.conv2 = nn.Conv2d(features, features, 3)
        for i in ("1", "2"):
            setattr(self, f"fc_gamma{i}", nn.Linear(EMBED_DIM, features))
            setattr(self, f"fc_beta{i}", nn.Linear(EMBED_DIM, features))
        self.register_buffer("w1_hwio", None, persistent=False)
        self.register_buffer("w2_hwio", None, persistent=False)
        self._refresh_hwio()
        self.register_load_state_dict_post_hook(
            lambda module, _incompatible: module._refresh_hwio())

    @torch.no_grad()
    def _refresh_hwio(self) -> None:
        for name, conv in (("w1_hwio", self.conv1), ("w2_hwio", self.conv2)):
            setattr(self, name, conv.weight.permute(2, 3, 1, 0).float().contiguous())

    def forward(self, x, style):
        out = ghiasi_resblock(
            _nhwc(x), self.w1_hwio, self.conv1.bias.float(),
            self.w2_hwio, self.conv2.bias.float(),
            self.fc_gamma1(style), self.fc_beta1(style),
            self.fc_gamma2(style), self.fc_beta2(style))
        return _nchw(out)


class Ghiasi(nn.Module):
    """Full generator (ghiasi.py:106-136): sigmoid(conv_stack(x, style))."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer0 = ConvInRelu(3, 32, 9, 1)
        self.layer1 = ConvInRelu(32, 64, 3, 2)
        self.layer2 = ConvInRelu(64, 128, 3, 2)
        for i in range(5):
            self.add_module(f"layer{3 + i}", ResidualBlock(128))
        self.layer8 = UpsampleConvInRelu(128, 64, 3, upsample=2)
        self.layer9 = UpsampleConvInRelu(64, 32, 3, upsample=2)
        self.layer10 = UpsampleConvInRelu(32, 3, 9, use_relu=False)

    def forward(self, x, styles):
        """x: (B, 3, H, W) in [0, 1]; styles: (B, 100). Returns
        (B, 3, 4 ceil(H/4), 4 ceil(W/4)) in ``self.dtype``: the two stride-2
        convs round odd sides up and the two upsamples double them, so SPN's
        227^2 comes out 228^2, as in the JAX package's plain lowering and the
        reference. Runs outside any autocast region: its dtypes are set here,
        as the flax module sets them."""
        with torch.autocast(x.device.type, enabled=False):
            x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
            styles = styles.float()
            x = self.layer2(self.layer1(self.layer0(x)))
            for i in range(5):
                x = getattr(self, f"layer{3 + i}")(x, styles)
            x = self.layer8(x, styles)
            x = self.layer9(x, styles)
            x = self.layer10(x, styles)
            return torch.sigmoid(x.float()).to(self.dtype)
