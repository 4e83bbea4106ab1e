"""Reflect pad 4 + 9x9 conv + bias on (B, H, W, C) tensors: the convs of the
Ghiasi generator's first and last layers (layer0: 3 -> 32 channels,
layer10: 32 -> 3), as ``models/ghiasi.py`` computes them:

    y = conv9x9(reflect_pad4(x), w) + b

The JAX package leaves these convs to XLA; ``csrc/edgeconv.cu`` is the
port's own kernel for them, added because cuDNN runs them in bf16 on engines
far from the card's bound (a non-tensor-core sgemm for layer0, a tf32 conv
after an upcast for layer10), each behind a padded copy and layout
transposes.

* ``reflect_conv9x9_plain``: ``F.pad(reflect)`` + ``F.conv2d``, computed in
  f32 (float64 for float64) from the operands' values. The CPU tests use it;
  ``chip_smoke.py`` holds the kernel to it.
* ``reflect_conv9x9``: the wrapper. A CPU tensor takes the plain version; a
  bf16 CUDA tensor launches the kernel; any other CUDA input raises
  ``ValueError``. Under grad mode, when an argument requires grad, the call
  goes through ``_vjp.PlainVJP`` (forward: the same call; backward: the VJP
  of the plain version, recomputed), as B1 and B2 do.

The kernel takes bf16 operands: x (B, H, W, Cin), w (Cout, Cin, 9, 9) as
``nn.Conv2d`` holds it, b (Cout,). It sums their exact products in f32 on
the tensor cores, adds the bias in f32 and rounds to bf16 once, reading the
reflected border straight from x (no padded copy). Its bound is bytes: 70
bytes a pixel, 0.20 ms a layer at (192, 224, 224) on an H100
(``bytes_moved``). Sides of at least 5 (a reflect pad of 4 needs 4 < side).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._vjp import PlainVJP, needs_grad
from .instancenorm import compute_dtype

# (Cin, Cout) of the two layers the kernel takes.
SHAPES = ((3, 32), (32, 3))
KERNEL, PAD, MIN_SIDE = 9, 4, 5


def reflect_conv9x9_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (Cout, Cin, 9, 9); b: (Cout,). Returns (B, H, W,
    Cout) in x's dtype, computed in f32 (float64 for a float64 x)."""
    cd = compute_dtype(x.dtype)
    xp = F.pad(x.permute(0, 3, 1, 2).to(cd), (PAD,) * 4, mode="reflect")
    return F.conv2d(xp, w.to(cd), b.to(cd)).permute(0, 2, 3, 1).to(x.dtype)


def reflect_conv9x9(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reflect-padded 9x9 conv (see module docstring); same arguments as
    ``reflect_conv9x9_plain``. On CUDA each argument must be a contiguous
    bfloat16 tensor. Differentiable in every argument (``PlainVJP``)."""
    args = (x, w, b)
    if needs_grad(args):
        return PlainVJP.apply(_reflect_conv9x9, reflect_conv9x9_plain, {}, *args)
    return _reflect_conv9x9(*args)


def _reflect_conv9x9(x, w, b):
    if x.device.type == "cpu":
        return reflect_conv9x9_plain(x, w, b)
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"reflect_conv9x9: x must be a contiguous (B, H, W, C) bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if (cin, cout) not in SHAPES:
        raise ValueError(f"reflect_conv9x9: (Cin, Cout) must be one of {SHAPES}, got "
                         f"{(cin, cout)}")
    if min(H, W) < MIN_SIDE:
        raise ValueError(f"reflect_conv9x9: reflect pad {PAD} needs H, W >= {MIN_SIDE}, got "
                         f"{H}x{W}")
    if x.data_ptr() % 16:
        raise ValueError("reflect_conv9x9: x must be 16-byte aligned (16-byte channel loads)")
    for name, t, shape in (("w", w, (cout, cin, KERNEL, KERNEL)), ("b", b, (cout,))):
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"reflect_conv9x9: {name} must be a contiguous bfloat16 tensor on "
                             f"{x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"reflect_conv9x9: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    out = torch.empty((B, H, W, cout), device=x.device, dtype=x.dtype)
    err = _build.load("edgeconv").gk_edgeconv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W, cin, cout,
        _build.stream_ptr(x.device))
    _build.check(err, "reflect_conv9x9")
    _build.launches["reflect_conv9x9"] += 1
    return out


def bytes_moved(shape, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Compulsory traffic of one call at output ``shape`` (B, H, W): read x,
    write out, read the weights and the bias once."""
    B, H, W = shape
    elem = torch.finfo(dtype).bits // 8
    return (B * H * W * (cin + cout) + cout * cin * KERNEL * KERNEL + cout) * elem


def flops(shape, cin: int, cout: int) -> int:
    """2 * 81 * Cin * Cout a pixel."""
    B, H, W = shape
    return 2 * KERNEL * KERNEL * cin * cout * B * H * W
