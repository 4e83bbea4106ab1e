"""Fused InstanceNorm + FiLM (+ ReLU) on (B, H, W, C) tensors.

Counterpart of ``speedplusbaseline_tpu/ops/instancenorm.py`` (the plain
version) and ``ops/pallas_instancenorm.py`` (the TPU kernel, which
``csrc/instancenorm.cu`` replaces).

* ``instance_norm_film_plain``: centered-variance PyTorch version. The CPU
  tests use it, and ``chip_smoke.py`` holds the kernel to it.
* ``instance_norm_film``: the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches the kernel or raises.

Layout is the JAX functions' (B, H, W, C), contiguous: a channels_last NCHW
tensor ``.permute(0, 2, 3, 1)`` is exactly that, with no copy. torch
InstanceNorm2d semantics: eps=1e-5, biased variance.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Aim for about this many blocks per launch (132 SMs, 8 blocks of 256 threads
# resident on each), and cut H*W into chunks of at least _MIN_ROWS rows.
_TARGET_BLOCKS = 1024
_MIN_ROWS = 64


def instance_norm_film_plain(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                             beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                             relu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C); gamma/beta: (B, C) or None. Same shape/dtype as x."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[:, None, None, :].float()
    if beta is not None:
        y = y + beta[:, None, None, :].float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def chunking(batch: int, rows: int, channels: int):
    """(rows_per_chunk, nchunks) for the split reduction over H*W."""
    ctiles = -(-channels // 32)
    want = max(1, -(-_TARGET_BLOCKS // (batch * ctiles)))
    nchunks = max(1, min(want, rows // _MIN_ROWS))
    per = -(-rows // nchunks)
    return per, -(-rows // per)


def check_x(x: torch.Tensor, what: str) -> None:
    """Raise unless x is a contiguous (B, H, W, C) float32/bfloat16 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (B, H, W, C) "
                         f"float32/bfloat16 tensor, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")


def check_f32(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    """Raise unless t is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def instance_norm_film(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                       relu: bool = False) -> torch.Tensor:
    """Instance norm over H, W per (sample, channel), optional FiLM and ReLU.

    x: (B, H, W, C) float32 or bfloat16; gamma, beta: (B, C) float32 or None.
    """
    if x.device.type == "cpu":
        return instance_norm_film_plain(x, gamma, beta, eps, relu)
    check_x(x, "instance_norm_film")
    B, H, W, C = x.shape
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v is not None:
            check_f32(v, name, (B, C), x.device)
    rows = H * W
    per, nchunks = chunking(B, rows, C)
    y = torch.empty_like(x)
    part = torch.empty((B, nchunks, C, 2), device=x.device, dtype=torch.float32)
    err = _build.load("instancenorm").gk_instance_norm_film(
        x.data_ptr(), y.data_ptr(), part.data_ptr(),
        gamma.data_ptr() if gamma is not None else None,
        beta.data_ptr() if beta is not None else None,
        B, rows, C, per, nchunks, _DTYPES[x.dtype], float(eps), int(relu),
        _build.stream_ptr(x.device))
    _build.check(err, "instance_norm_film")
    _build.launches["instance_norm_film"] += 1
    return y


def bytes_moved(shape, dtype: torch.dtype, film: bool) -> int:
    """Compulsory traffic of one call: read x, write y, read gamma/beta."""
    B, H, W, C = shape
    elem = torch.finfo(dtype).bits // 8
    return 2 * B * H * W * C * elem + (2 * B * C * 4 if film else 0)


def flops(shape) -> int:
    """Arithmetic of one call: sum, centered square, scale+shift (+relu)."""
    return 6 * math.prod(shape)
