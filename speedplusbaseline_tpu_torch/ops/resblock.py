"""Ghiasi residual block, forward only, on (B, H, W, C) tensors.

Counterpart of ``speedplusbaseline_tpu/ops/pallas_resblock.py``
(``ghiasi_resblock_pallas``, the TPU kernel that ``csrc/resblock.cu``
replaces) and of the plain block in ``models/ghiasi.py::ResidualBlock``:

    y = conv3x3(reflect_pad1(x), W1) + b1;  y = relu(FiLM1(IN(y)))
    y = conv3x3(reflect_pad1(y), W2) + b2;  y = FiLM2(IN(y))
    out = x + y

computed in f32 from x's dtype and cast back, as the Pallas kernel does.

* ``ghiasi_resblock_plain``: ``F.pad(reflect)`` + ``F.conv2d`` + the plain
  instance norm, all f32. The CPU tests use it; ``chip_smoke.py`` holds the
  kernel to it.
* ``ghiasi_resblock``: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel chain or raises. Under grad mode, when an
  argument requires grad, the call goes through ``_vjp.PlainVJP``, an
  autograd Function whose forward is that same call and whose backward is
  the VJP of ``ghiasi_resblock_plain``, recomputed from the saved inputs
  (the JAX package has no backward kernel either: its Pallas kernel serves
  the frozen generator, and training differentiates the XLA block). Without
  grad mode, or with no argument that requires grad, the wrapper calls the
  kernel directly, with no autograd bookkeeping.

The kernel runs both convs on the Hopper tensor cores (``wgmma``) at f32
accuracy through split-bf16 operands: each f32 operand v becomes
hi = bf16(v) and lo = bf16(v - hi), and each product is taken as
hi*hi + hi*lo + lo*hi with f32 accumulation (the dropped lo*lo and the
rounding of lo are each ~2^-17 relative). bf16 tensor cores are the only
full-rate path, and single-pass bf16 operands would change the function the
TPU kernel computes. A bf16 x has lo = 0, so conv 1 from bf16 x takes two
passes and conv 2 three. The bound is operations: five passes of
2 * 9 * C^2 * H*W * B flops at the 989 TFLOP/s bf16 peak, 0.224 ms per call
at (48, 56, 56, 128) (``flops(shape, passes)``).

The chain (six launches, one counted call): a prep kernel writes the split
weights into ``wsplit`` scratch in the byte image of the MMA's B operand;
each conv block (128 pixels x 128 channels, two warpgroups) loads, per
32-channel chunk, the reflect-padded rows its pixels span (the halo) into
shared memory as hi/lo bf16, and per tap ``ldmatrix`` reads each lane's
shifted pixel into the register-A form of ``wgmma`` while the B tiles
arrive by ``cp.async.bulk``; IN partials come from the epilogue, conv 2
applies IN1+FiLM1+ReLU as it loads y1, and a last pass adds IN2+FiLM2 to x.
TMA tensor maps, a persistent grid and warp specialisation are left for
later. A shape the kernel does not take raises ``ValueError``: C not a
multiple of 8, or a halo that does not fit one block's shared memory (W
above 324).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from ._vjp import PlainVJP, needs_grad
from .instancenorm import (_DTYPES, check_f32, check_x, compute_dtype,
                           instance_norm_film_plain)


def _conv3x3_reflect(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    x = F.pad(x_nhwc.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype), b.to(x.dtype))
    return y.permute(0, 2, 3, 1)


def ghiasi_resblock_plain(x, w1, b1, w2, b2, gamma1, beta1, gamma2, beta2):
    """x: (B, H, W, C); w1/w2: (3, 3, C, C) HWIO; b1/b2: (C,);
    gamma/beta: (B, C). Returns (B, H, W, C) in x's dtype, computed in f32
    (float64 for a float64 x)."""
    xf = x.to(compute_dtype(x.dtype))
    y = _conv3x3_reflect(xf, w1, b1)
    y = instance_norm_film_plain(y, gamma1, beta1, relu=True)
    y = _conv3x3_reflect(y, w2, b2)
    y = instance_norm_film_plain(y, gamma2, beta2)
    return (xf + y).to(x.dtype)


# Dynamic shared memory one block may opt into on an H100 (227 KB).
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _geometry(lib, H: int, W: int, C: int):
    """(conv tiles per sample, split-weight scratch bytes, conv shared memory
    bytes) of a shape, from csrc/resblock.cu, read once per shape."""
    return (-(-(H * W) // lib.gk_resblock_tile_pixels()), lib.gk_resblock_wsplit_bytes(C),
            lib.gk_resblock_smem_bytes(H, W))


def ghiasi_resblock(x, w1, b1, w2, b2, gamma1, beta1, gamma2, beta2):
    """Fused residual block (see module docstring); same arguments as
    ``ghiasi_resblock_plain``. On CUDA every argument but x must be a
    contiguous float32 tensor; x is float32 or bfloat16, contiguous.
    Differentiable in every argument (``PlainVJP``)."""
    args = (x, w1, b1, w2, b2, gamma1, beta1, gamma2, beta2)
    if needs_grad(args):
        return PlainVJP.apply(_ghiasi_resblock, ghiasi_resblock_plain, {}, *args)
    return _ghiasi_resblock(*args)


def _ghiasi_resblock(x, w1, b1, w2, b2, gamma1, beta1, gamma2, beta2):
    if x.device.type == "cpu":
        return ghiasi_resblock_plain(x, w1, b1, w2, b2, gamma1, beta1, gamma2, beta2)
    check_x(x, "ghiasi_resblock")
    B, H, W, C = x.shape
    if H < 2 or W < 2:
        raise ValueError(f"ghiasi_resblock: reflect pad needs H, W >= 2, got {H}x{W}")
    if C % 8 or x.data_ptr() % 16:
        raise ValueError(f"ghiasi_resblock: the kernel loads 16-byte channel groups, so C "
                         f"must be a multiple of 8 and x 16-byte aligned, got C={C}")
    for name, t in (("w1", w1), ("w2", w2)):
        check_f32(t, name, (3, 3, C, C), x.device)
    for name, t in (("b1", b1), ("b2", b2)):
        check_f32(t, name, (C,), x.device)
    for name, t in (("gamma1", gamma1), ("beta1", beta1), ("gamma2", gamma2),
                    ("beta2", beta2)):
        check_f32(t, name, (B, C), x.device)

    lib = _build.load("resblock")
    ntiles, wsplit_bytes, smem = _geometry(lib, H, W, C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ghiasi_resblock: W={W} needs a {smem}-byte halo block, over the "
                         f"{SMEM_LIMIT} bytes of shared memory a block can have")
    out = torch.empty_like(x)
    wsplit = torch.empty(wsplit_bytes, device=x.device, dtype=torch.uint8)
    y1 = torch.empty((B, H * W, C), device=x.device, dtype=torch.float32)
    y2 = torch.empty_like(y1)
    part = torch.empty((B, ntiles, C, 2), device=x.device, dtype=torch.float32)
    scale = torch.empty((B, C), device=x.device, dtype=torch.float32)
    shift = torch.empty_like(scale)
    err = lib.gk_resblock(
        x.data_ptr(), out.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma1.data_ptr(), beta1.data_ptr(),
        gamma2.data_ptr(), beta2.data_ptr(), wsplit.data_ptr(), y1.data_ptr(), y2.data_ptr(),
        part.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        B, H, W, C, _DTYPES[x.dtype], 1e-5, _build.stream_ptr(x.device))
    _build.check(err, "ghiasi_resblock")
    _build.launches["ghiasi_resblock"] += 1
    return out


def bytes_moved(shape, dtype: torch.dtype) -> int:
    """Compulsory traffic of one call: read x, write out, read the weights
    and the FiLM vectors once."""
    B, H, W, C = shape
    elem = torch.finfo(dtype).bits // 8
    return 2 * B * H * W * C * elem + 4 * (2 * 9 * C * C + 2 * C + 4 * B * C)


def flops(shape, passes: int = 2) -> int:
    """``passes`` 3x3 C->C convs per sample: passes * (2 * 9 * C^2 * H * W) * B.
    The f32 function is two; the split-bf16 kernel's tensor-core work is five
    from bf16 x (2 + 3) and six from f32 x."""
    B, H, W, C = shape
    return passes * 2 * 9 * C * C * H * W * B
