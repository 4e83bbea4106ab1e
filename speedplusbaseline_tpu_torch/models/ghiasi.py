"""Ghiasi arbitrary-style-transfer generator (counterpart of
``speedplusbaseline_tpu/models/ghiasi.py``; reference ghiasi.py:106-136).

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

``Ghiasi(phase_space=True)`` is the JAX module's ``tpu_opt``: the
full-resolution layers run as the phase-space rewrites of
``ops/phase_conv.py`` (every conv at half resolution with 4x the channels,
reflect pads in phase space, the nearest upsamples folded into subpixel
convs), from the same parameters, so checkpoints and the converters serve
both lowerings. The residual blocks still run B1 and the instance norms of
layers 1-2 B2. The port's default is the plain lowering.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instancenorm import instance_norm_film
from ..ops.phase_conv import (conv3x3_s2_phase_aligned, conv9x9_phase, conv9x9_phase_dp,
                              depth_to_space2, phase_instance_norm_packed,
                              phase_weights_9x9, phase_weights_9x9_dp,
                              phase_weights_s2_aligned, phase_weights_up_aligned,
                              space_to_depth2, upconv3x3_phase_packed)
from ..ops.resblock import ghiasi_resblock
from .layers import flax_default_init_

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
        flax_default_init_(self)

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
        flax_default_init_(self)

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
        flax_default_init_(self)
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


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0).float()


class Ghiasi(nn.Module):
    """Full generator (ghiasi.py:106-136): sigmoid(conv_stack(x, style)).

    ``phase_space`` selects the phase-space lowering (the JAX module's
    ``tpu_opt``), whose output layer emits the double-packed phase tensor
    (conv9x9_phase_dp), as the JAX module's default. The rewritten kernels
    are non-persistent buffers, made at init and remade after every
    ``load_state_dict``, as ``ResidualBlock`` keeps B1's. Untrained, each
    layer's weights start as flax's defaults (``flax_default_init_``)."""

    def __init__(self, dtype: torch.dtype = torch.float32, phase_space: bool = False):
        super().__init__()
        self.dtype = dtype
        self.phase_space = phase_space
        self.layer0 = ConvInRelu(3, 32, 9, 1)
        self.layer1 = ConvInRelu(32, 64, 3, 2)
        self.layer2 = ConvInRelu(64, 128, 3, 2)
        for i in range(5):
            self.add_module(f"layer{3 + i}", ResidualBlock(128))
        self.layer8 = UpsampleConvInRelu(128, 64, 3, upsample=2)
        self.layer9 = UpsampleConvInRelu(64, 32, 3, upsample=2)
        self.layer10 = UpsampleConvInRelu(32, 3, 9, use_relu=False)
        if phase_space:
            for layer in (0, 1, 2, 8, 9, 10):
                self.register_buffer(f"phase_w{layer}", None, persistent=False)
            self._refresh_phase()
            self.register_load_state_dict_post_hook(
                lambda module, _incompatible: module._refresh_phase())

    @torch.no_grad()
    def _refresh_phase(self) -> None:
        """The phase-space kernels (HWIO, f32) of the current conv weights."""
        self.phase_w0 = phase_weights_9x9(_hwio(self.layer0.conv))
        self.phase_w1 = phase_weights_s2_aligned(_hwio(self.layer1.conv))
        self.phase_w2 = phase_weights_s2_aligned(_hwio(self.layer2.conv))
        self.phase_w8 = phase_weights_up_aligned(_hwio(self.layer8.conv))
        self.phase_w9 = phase_weights_up_aligned(_hwio(self.layer9.conv))
        self.phase_w10 = phase_weights_9x9_dp(_hwio(self.layer10.conv))

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
            if self.phase_space:
                return self._phase_forward(x, styles)
            x = self.layer2(self.layer1(self.layer0(x)))
            for i in range(5):
                x = getattr(self, f"layer{3 + i}")(x, styles)
            x = self.layer8(x, styles)
            x = self.layer9(x, styles)
            x = self.layer10(x, styles)
            return torch.sigmoid(x.float()).to(self.dtype)

    def _phase_forward(self, x: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """The JAX module's ``_phase_forward``, layer for layer. A side that
        is not a multiple of 4 is first reflect-padded up to one (227 ->
        228): the plain lowering's output is 4 ceil(H/4) too, and only a
        band along the padded border differs from it."""
        ph, pw = -x.shape[2] % 4, -x.shape[3] % 4
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = _nhwc(x)

        # layer0: 9x9 3 -> 32 as a 5x5 conv on the phases: (B, H/2, W/2, 4*32)
        a = conv9x9_phase(space_to_depth2(x), None, self.layer0.conv.bias,
                          phase_w=self.phase_w0)
        a = F.relu(phase_instance_norm_packed(a)).to(self.dtype)
        # layer1: 3x3 s2 32 -> 64; its s2d input is layer0's phase output
        y = conv3x3_s2_phase_aligned(a, None, self.layer1.conv.bias, phase_w=self.phase_w1)
        y = instance_norm_film(y.contiguous(), relu=True)
        # layer2: 3x3 s2 64 -> 128
        y = conv3x3_s2_phase_aligned(space_to_depth2(y), None, self.layer2.conv.bias,
                                     phase_w=self.phase_w2)
        y = _nchw(instance_norm_film(y.contiguous(), relu=True))
        for i in range(5):
            y = getattr(self, f"layer{3 + i}")(y, styles)

        # layer8: up2 + 3x3 128 -> 64 as one subpixel conv (packed phases)
        l8 = self.layer8
        z = upconv3x3_phase_packed(_nhwc(y), None, l8.conv.bias, phase_w=self.phase_w8)
        z = F.relu(phase_instance_norm_packed(z, l8.fc_gamma(styles), l8.fc_beta(styles)))
        y = depth_to_space2(z).to(self.dtype)
        # layer9: up2 + 3x3 64 -> 32; its packed output is layer10's s2d input
        l9 = self.layer9
        z = upconv3x3_phase_packed(y, None, l9.conv.bias, phase_w=self.phase_w9)
        a = F.relu(phase_instance_norm_packed(z, l9.fc_gamma(styles),
                                              l9.fc_beta(styles))).to(self.dtype)
        # layer10: 9x9 32 -> 3 + IN + FiLM, no ReLU. The padded input makes
        # a's sides even, which the double-packed form needs.
        l10 = self.layer10
        z = conv9x9_phase_dp(a, None, l10.conv.bias, phase_w=self.phase_w10)
        z = phase_instance_norm_packed(z, l10.fc_gamma(styles), l10.fc_beta(styles), phases=16)
        return _nchw(depth_to_space2(depth_to_space2(torch.sigmoid(z.float()).to(self.dtype))))
