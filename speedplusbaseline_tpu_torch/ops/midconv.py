"""Reflect pad 1 + 3x3 conv + bias on (B, H, W, C) tensors, with a stride of
2 or a nearest 2x upsample folded in: the convs of the Ghiasi generator's
layers 1 and 2 (stride 2: 32 -> 64, 64 -> 128 channels) and 8 and 9
(upsampled: 128 -> 64, 64 -> 32), as ``models/ghiasi.py`` computes them:

    y = conv3x3(reflect_pad1(upsample_nearest(x, upsample)), w, stride) + b

The JAX package leaves these convs to XLA; ``csrc/midconv.cu`` is the
port's own kernel for them, added because on the card the plain path's
layout glue (the upsampled copy, the padded NCHW copy, cuDNN's NCHW <-> NHWC
transposes and the channels_last copy after it) took about 33 of a bf16
restyle's 49 ms at batch 192 and 224^2, around 2.8 ms of convs.

* ``reflect_conv3x3_plain``: ``F.interpolate`` + ``F.pad(reflect)`` +
  ``F.conv2d``, computed in f32 (float64 for float64) from the operands'
  values. The CPU tests use it; ``chip_smoke.py`` holds the kernel to it.
* ``reflect_conv3x3``: the wrapper. It checks its arguments on every device;
  a CPU tensor then takes the plain version, a bf16 CUDA tensor launches the
  kernel, and any other CUDA input raises ``ValueError``. Under grad mode,
  when an argument requires grad, the call goes through ``_vjp.PlainVJP``
  (forward: the same call; backward: the VJP of the plain version,
  recomputed), as B1, B2 and the edge convs do.

The weight is the conv's packed once as OHWI, (Cout, 3, 3, Cin), in x's
dtype (``pack``): the kernel's B operand, k = (3 i + j) Cin + c. The bias
stays in f32 (float64 for float64). The kernel sums the exact products of
bf16 x and bf16 w in f32 on the tensor cores, adds the bias in f32 and rounds
to bf16 once, reading the reflected border and the upsampled pixels straight
from x: no padded or upsampled copy exists. Its bound at (192, 224^2) on an
H100: layers 8 and 9 operations (0.36 ms each at 989 TFLOP/s), layers 1 and 2
bytes (0.28 / 0.14 ms at 3.35 TB/s): ``flops`` and ``bytes_moved``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._vjp import PlainVJP, needs_grad
from .instancenorm import compute_dtype

# (Cin, Cout, stride, upsample) of the four layers the kernel takes.
SHAPES = ((32, 64, 2, 1), (64, 128, 2, 1), (128, 64, 1, 2), (64, 32, 1, 2))
KERNEL, PAD = 3, 1
DTYPES = (torch.bfloat16, torch.float32, torch.float64)


def pack(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An ``nn.Conv2d`` weight (Cout, Cin, 3, 3) as the contiguous OHWI
    (Cout, 3, 3, Cin) tensor in ``dtype`` that ``reflect_conv3x3`` takes."""
    return weight.permute(0, 2, 3, 1).to(dtype).contiguous()


def out_side(side: int, stride: int, upsample: int) -> int:
    """The output side of an input side: ceil(side / 2) at stride 2, 2 side
    upsampled (``F.conv2d`` on the padded input)."""
    return (side * upsample - 1) // stride + 1


def reflect_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                          upsample: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (Cout, 3, 3, Cin); b: (Cout,). Returns (B, Ho, Wo,
    Cout) in x's dtype, computed in f32 (float64 for a float64 x)."""
    cd = compute_dtype(x.dtype)
    xc = x.permute(0, 3, 1, 2).to(cd)
    if upsample > 1:
        xc = F.interpolate(xc, scale_factor=upsample, mode="nearest")
    xp = F.pad(xc, (PAD,) * 4, mode="reflect")
    wc = w.permute(0, 3, 1, 2).to(cd).contiguous()
    return F.conv2d(xp, wc, b.to(cd), stride).permute(0, 2, 3, 1).to(x.dtype)


def reflect_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                    upsample: int = 1) -> torch.Tensor:
    """The reflect-padded 3x3 conv (see module docstring); same arguments as
    ``reflect_conv3x3_plain``. x and w must be contiguous and of one dtype, b
    in x's compute dtype; on CUDA x must be bfloat16. Differentiable in
    every argument (``PlainVJP``)."""
    args = (x, w, b)
    kwargs = {"stride": stride, "upsample": upsample}
    if needs_grad(args):
        return PlainVJP.apply(_reflect_conv3x3, reflect_conv3x3_plain, kwargs, *args)
    return _reflect_conv3x3(*args, **kwargs)


def check(x, w, b, stride: int, upsample: int) -> None:
    """Raise ``ValueError`` for what neither version of the call takes."""
    if x.dim() != 4 or x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"reflect_conv3x3: x must be a contiguous (B, H, W, C) tensor of one of "
                         f"{DTYPES}, got {x.dtype} {tuple(x.shape)}")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if (cin, cout, stride, upsample) not in SHAPES:
        raise ValueError(f"reflect_conv3x3: (Cin, Cout, stride, upsample) must be one of "
                         f"{SHAPES}, got {(cin, cout, stride, upsample)}")
    if min(H, W) * upsample < 2:
        raise ValueError(f"reflect_conv3x3: reflect pad 1 needs a side of at least 2, got "
                         f"{H}x{W} upsampled {upsample}x")
    for name, t, shape, dtype in (("w", w, (cout, KERNEL, KERNEL, cin), x.dtype),
                                  ("b", b, (cout,), compute_dtype(x.dtype))):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"reflect_conv3x3: {name} must be a contiguous {dtype} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"reflect_conv3x3: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def _reflect_conv3x3(x, w, b, stride: int = 1, upsample: int = 1):
    check(x, w, b, stride, upsample)
    if x.device.type == "cpu":
        return reflect_conv3x3_plain(x, w, b, stride, upsample)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"reflect_conv3x3: a CUDA x must be bfloat16, got {x.dtype}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("reflect_conv3x3: x and w must be 16-byte aligned (16-byte loads)")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((B, out_side(H, stride, upsample), out_side(W, stride, upsample), cout),
                      device=x.device, dtype=x.dtype)
    err = _build.load("midconv").gk_midconv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W, cin, cout, stride,
        upsample, _build.stream_ptr(x.device))
    _build.check(err, "reflect_conv3x3")
    _build.launches["reflect_conv3x3"] += 1
    return out


def bytes_moved(shape, cin: int, cout: int, stride: int, upsample: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Compulsory traffic of one call at input ``shape`` (B, H, W): read x
    (at its own size, never upsampled), write out, read the weights and the
    f32 bias once."""
    B, H, W = shape
    elem = torch.finfo(dtype).bits // 8
    ho, wo = out_side(H, stride, upsample), out_side(W, stride, upsample)
    return ((B * H * W * cin + B * ho * wo * cout + cout * cin * KERNEL * KERNEL) * elem
            + cout * 4)


def flops(shape, cin: int, cout: int, stride: int, upsample: int) -> int:
    """2 * 9 * Cin * Cout an output pixel, at input ``shape`` (B, H, W)."""
    B, H, W = shape
    ho, wo = out_side(H, stride, upsample), out_side(W, stride, upsample)
    return 2 * KERNEL * KERNEL * cin * cout * B * ho * wo
