"""Ghiasi arbitrary-style-transfer generator (counterpart of
``speedplusbaseline_tpu/models/ghiasi.py``; reference ghiasi.py:106-136).

Three unconditioned downsampling ConvInRelu layers, five FiLM-conditioned
residual blocks, two FiLM-conditioned upsample layers and a 9x9 output conv
+ sigmoid. FiLM gamma/beta = Linear(100 -> C) of the style embedding, in f32.

Every instance norm goes through ``ops.instance_norm_film`` (kernel B2 on
CUDA) and every residual block through ``ops.ghiasi_resblock`` (kernel B1 on
CUDA); there is no switch that turns them off on the card. The JAX package
leaves the other convs to XLA. Where their input is bf16 on CUDA, the two
9x9 convs (layers 0 and 10, reflect pad included) go through
``ops.reflect_conv9x9`` (the edge-conv kernel, E1), and the four 3x3 convs
(layers 1 and 2 with their stride 2, layers 8 and 9 with their nearest 2x
upsample, reflect pad included) through ``ops.reflect_conv3x3`` (the
mid-conv kernel, E2), which reads the NHWC input as it is: no upsampled or
padded copy and no layout transpose. In f32, on the CPU and in the
phase-space lowering they stay ``upsample_nearest`` + ``reflect_pad`` +
``F.conv2d``.

``dtype`` is the compute dtype, as the flax module's: the input and the conv
weights are cast to it, FiLM stays f32, and the output is the sigmoid cast to
``dtype``, or the f32 sigmoid itself with ``f32_out`` (the JAX module's flag,
which only moves that last cast). Tensors are NCHW in channels_last memory;
the kernels see the (B, H, W, C) view of the same storage. A float64 module in the plain
lowering (the CPU tests' float64 steps) computes FiLM, the norms and the
blocks in float64.

The generator is trainable. Every kernel is differentiable (its backward
is the VJP of its plain version, ``ops/_vjp.py``). B1, E2 and the phase-space
convs take rewritten conv weights (HWIO, bf16 OHWI, phase kernels): when the conv
weights require grad under grad mode, the forward rewrites them from the
live weights on every call, so that the gradient reaches them; otherwise it
reads the rewritten copies cached in non-persistent buffers, remade after
every ``load_state_dict``, as a frozen generator (the style augmentor's)
needs no rewrite per call.

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

from ..ops._vjp import needs_grad
from ..ops.edgeconv import reflect_conv9x9
from ..ops.instancenorm import compute_dtype, instance_norm_film
from ..ops.midconv import pack, reflect_conv3x3
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


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """The conv's weight as HWIO in f32 (float64 for a float64 weight)."""
    return conv.weight.permute(2, 3, 1, 0).to(compute_dtype(conv.weight.dtype))


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _padded_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Reflect pad + conv of an NCHW (channels_last) x, as (B, H, W, C). A
    9x9 conv of a bf16 x on the card runs the edge-conv kernel, on the same
    bf16 operands as ``_conv``; any other takes ``reflect_pad`` + ``_conv``."""
    k = conv.kernel_size[0]
    if k == 9 and x.dtype == torch.bfloat16 and _on_card(x):
        return reflect_conv9x9(_nhwc(x), conv.weight.to(x.dtype), conv.bias.to(x.dtype))
    return _nhwc(_conv(conv, reflect_pad(x, k // 2)))


class _ConvLayer(nn.Module):
    """A generator layer around ``self.conv``. A 3x3 conv also keeps its
    weight packed for E2 (bf16 OHWI) in a non-persistent buffer, made after
    the init and remade after every ``load_state_dict``, as
    ``ResidualBlock`` keeps B1's; under grad mode, when the conv weight
    requires grad, the forward packs the live weight on every call instead."""

    def _pack_conv(self) -> None:
        if self.conv.kernel_size[0] == 3:
            self.register_buffer("w_ohwi", None, persistent=False)
            self._refresh_ohwi()
            self.register_load_state_dict_post_hook(
                lambda module, _incompatible: module._refresh_ohwi())

    @torch.no_grad()
    def _refresh_ohwi(self) -> None:
        self.w_ohwi = pack(self.conv.weight, torch.bfloat16)

    def _conv_nhwc(self, x: torch.Tensor, upsample: int = 0) -> torch.Tensor:
        """Nearest ``upsample`` (when set) + reflect pad + conv of an NCHW
        (channels_last) x, as (B, H, W, C). A 3x3 conv of a bf16 x on the
        card runs E2 on the NHWC view of x, on the bf16 weights ``_conv``
        would use and the f32 bias; any other takes ``upsample_nearest`` +
        ``_padded_conv``."""
        conv = self.conv
        if conv.kernel_size[0] == 3 and x.dtype == torch.bfloat16 and _on_card(x):
            w = (pack(conv.weight, x.dtype) if needs_grad((conv.weight,))
                 else self.w_ohwi.to(x.dtype))
            return reflect_conv3x3(_nhwc(x), w, conv.bias.to(compute_dtype(x.dtype)),
                                   conv.stride[0], upsample or 1)
        if upsample:
            x = upsample_nearest(x, upsample)
        return _padded_conv(conv, x)


class ConvInRelu(_ConvLayer):
    """ReflectionPad + Conv + InstanceNorm + ReLU (ghiasi.py:6-23)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride)
        flax_default_init_(self)
        self._pack_conv()

    def forward(self, x):
        return _nchw(instance_norm_film(self._conv_nhwc(x), relu=True))


class UpsampleConvInRelu(_ConvLayer):
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
        self._pack_conv()

    def forward(self, x, style):
        gamma = self.fc_gamma(style)
        beta = self.fc_beta(style)
        return _nchw(instance_norm_film(self._conv_nhwc(x, self.upsample), gamma, beta,
                                        relu=self.use_relu))


class ResidualBlock(nn.Module):
    """Residual block with two FiLM-conditioned 3x3 convs (ghiasi.py:65-103),
    computed in f32 and returned in x's dtype, as the fused TPU kernel does.

    The kernel takes HWIO f32 conv weights. A frozen block reads them from
    non-persistent buffers, made at init and remade after every
    ``load_state_dict``; a block whose conv weights require grad under grad
    mode permutes the live weights on every call instead."""

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
        self.w1_hwio = _hwio(self.conv1).contiguous()
        self.w2_hwio = _hwio(self.conv2).contiguous()

    def forward(self, x, style):
        w1, w2 = self.w1_hwio, self.w2_hwio
        if needs_grad((self.conv1.weight, self.conv2.weight)):
            w1, w2 = _hwio(self.conv1).contiguous(), _hwio(self.conv2).contiguous()
        b1, b2 = (c.bias.to(compute_dtype(c.bias.dtype)) for c in (self.conv1, self.conv2))
        out = ghiasi_resblock(
            _nhwc(x), w1, b1, w2, b2,
            self.fc_gamma1(style), self.fc_beta1(style),
            self.fc_gamma2(style), self.fc_beta2(style))
        return _nchw(out)


class Ghiasi(nn.Module):
    """Full generator (ghiasi.py:106-136): sigmoid(conv_stack(x, style)).

    ``phase_space`` selects the phase-space lowering (the JAX module's
    ``tpu_opt``), whose output layer emits the double-packed phase tensor
    (conv9x9_phase_dp), as the JAX module's default. The rewritten kernels
    are non-persistent buffers, made at init and remade after every
    ``load_state_dict``, as ``ResidualBlock`` keeps B1's, and rewritten from
    the live weights on every call when those require grad under grad mode.
    Untrained, each layer's weights start as flax's defaults
    (``flax_default_init_``)."""

    # The layers whose convs the phase-space lowering rewrites.
    _PHASE_LAYERS = (0, 1, 2, 8, 9, 10)

    def __init__(self, dtype: torch.dtype = torch.float32, phase_space: bool = False,
                 f32_out: bool = False):
        super().__init__()
        self.dtype = dtype
        self.phase_space = phase_space
        self.f32_out = f32_out
        self.layer0 = ConvInRelu(3, 32, 9, 1)
        self.layer1 = ConvInRelu(32, 64, 3, 2)
        self.layer2 = ConvInRelu(64, 128, 3, 2)
        for i in range(5):
            self.add_module(f"layer{3 + i}", ResidualBlock(128))
        self.layer8 = UpsampleConvInRelu(128, 64, 3, upsample=2)
        self.layer9 = UpsampleConvInRelu(64, 32, 3, upsample=2)
        self.layer10 = UpsampleConvInRelu(32, 3, 9, use_relu=False)
        if phase_space:
            for layer in self._PHASE_LAYERS:
                self.register_buffer(f"phase_w{layer}", None, persistent=False)
            self._refresh_phase()
            self.register_load_state_dict_post_hook(
                lambda module, _incompatible: module._refresh_phase())

    def _phase_kernels(self):
        """The phase-space kernels (HWIO, f32) of the current conv weights,
        layers 0, 1, 2, 8, 9, 10."""
        rewrite = {0: phase_weights_9x9, 1: phase_weights_s2_aligned,
                   2: phase_weights_s2_aligned, 8: phase_weights_up_aligned,
                   9: phase_weights_up_aligned, 10: phase_weights_9x9_dp}
        return tuple(rewrite[i](_hwio(getattr(self, f"layer{i}").conv))
                     for i in self._PHASE_LAYERS)

    def _out(self, z: torch.Tensor) -> torch.Tensor:
        """The sigmoid of the output layer: in f32 with ``f32_out``, else in
        ``self.dtype``."""
        z = torch.sigmoid(z.to(compute_dtype(z.dtype)))
        return z if self.f32_out else z.to(self.dtype)

    @torch.no_grad()
    def _refresh_phase(self) -> None:
        for i, w in zip(self._PHASE_LAYERS, self._phase_kernels()):
            setattr(self, f"phase_w{i}", w)

    def forward(self, x, styles):
        """x: (B, 3, H, W) in [0, 1]; styles: (B, 100). Returns
        (B, 3, 4 ceil(H/4), 4 ceil(W/4)) in ``self.dtype`` (f32 with
        ``f32_out``): the two stride-2 convs round odd sides up and the two
        upsamples double them, so SPN's 227^2 comes out 228^2, as in the JAX package's plain lowering and the
        reference. Runs outside any autocast region: its dtypes are set here,
        as the flax module sets them."""
        with torch.autocast(x.device.type, enabled=False):
            x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
            styles = styles.to(compute_dtype(self.dtype))
            if self.phase_space:
                return self._phase_forward(x, styles)
            x = self.layer2(self.layer1(self.layer0(x)))
            for i in range(5):
                x = getattr(self, f"layer{3 + i}")(x, styles)
            x = self.layer8(x, styles)
            x = self.layer9(x, styles)
            x = self.layer10(x, styles)
            return self._out(x)

    def _phase_forward(self, x: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """The JAX module's ``_phase_forward``, layer for layer. A side that
        is not a multiple of 4 is first reflect-padded up to one (227 ->
        228): the plain lowering's output is 4 ceil(H/4) too, and only a
        band along the padded border differs from it."""
        ph, pw = -x.shape[2] % 4, -x.shape[3] % 4
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = _nhwc(x)
        convs = [getattr(self, f"layer{i}").conv.weight for i in self._PHASE_LAYERS]
        w0, w1, w2, w8, w9, w10 = (self._phase_kernels() if needs_grad(convs) else
                                   [getattr(self, f"phase_w{i}") for i in self._PHASE_LAYERS])

        # layer0: 9x9 3 -> 32 as a 5x5 conv on the phases: (B, H/2, W/2, 4*32)
        a = conv9x9_phase(space_to_depth2(x), None, self.layer0.conv.bias,
                          phase_w=w0)
        a = F.relu(phase_instance_norm_packed(a)).to(self.dtype)
        # layer1: 3x3 s2 32 -> 64; its s2d input is layer0's phase output
        y = conv3x3_s2_phase_aligned(a, None, self.layer1.conv.bias, phase_w=w1)
        y = instance_norm_film(y.contiguous(), relu=True)
        # layer2: 3x3 s2 64 -> 128
        y = conv3x3_s2_phase_aligned(space_to_depth2(y), None, self.layer2.conv.bias,
                                     phase_w=w2)
        y = _nchw(instance_norm_film(y.contiguous(), relu=True))
        for i in range(5):
            y = getattr(self, f"layer{3 + i}")(y, styles)

        # layer8: up2 + 3x3 128 -> 64 as one subpixel conv (packed phases)
        l8 = self.layer8
        z = upconv3x3_phase_packed(_nhwc(y), None, l8.conv.bias, phase_w=w8)
        z = F.relu(phase_instance_norm_packed(z, l8.fc_gamma(styles), l8.fc_beta(styles)))
        y = depth_to_space2(z).to(self.dtype)
        # layer9: up2 + 3x3 64 -> 32; its packed output is layer10's s2d input
        l9 = self.layer9
        z = upconv3x3_phase_packed(y, None, l9.conv.bias, phase_w=w9)
        a = F.relu(phase_instance_norm_packed(z, l9.fc_gamma(styles),
                                              l9.fc_beta(styles))).to(self.dtype)
        # layer10: 9x9 32 -> 3 + IN + FiLM, no ReLU. The padded input makes
        # a's sides even, which the double-packed form needs.
        l10 = self.layer10
        z = conv9x9_phase_dp(a, None, l10.conv.bias, phase_w=w10)
        z = phase_instance_norm_packed(z, l10.fc_gamma(styles), l10.fc_beta(styles), phases=16)
        return _nchw(depth_to_space2(depth_to_space2(self._out(z))))
