"""Full-f32 math for the geometry (counterpart of ``speedplusbaseline_tpu/
geometry/_precision.py``).

Pose recovery needs true float32: a 2e-3 relative error in M^T M shifts the
EPnP attitude by more than the 0.169 deg SPEED+ HIL threshold. Two things
would quietly take that away in PyTorch: an enclosing ``torch.autocast``
(the eval forward runs under a bf16 one with ``--use_fp16``; a ``bmm``
inside it runs in bf16 without any error), and a float32 matmul precision
below ``"highest"`` (TF32 on the card). Every public geometry entry point
runs under ``f32_math()``, which turns autocast off and sets the precision
to ``"highest"`` for the call, then restores both.

``fma`` rounds a * b + c once, as a fused multiply-add does: XLA's CPU code
sums its dots and reductions that way, in index order, and the projection
and quaternion norm follow it, so that the label CSVs the port writes are
the JAX package's, byte for byte.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_math():
    """Context manager and decorator (``@f32_math()``): autocast off and
    float32 matmul precision ``"highest"`` inside, the caller's settings
    restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with contextlib.ExitStack() as stack:
            for device_type in ("cpu", "cuda"):
                if torch.is_autocast_enabled(device_type):
                    stack.enter_context(torch.autocast(device_type, enabled=False))
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to the dtype of ``a``: for float32 operands the
    product is exact in float64, and the float64 sum is rounded to float32."""
    return (a.double() * b.double() + c.double()).to(a.dtype)
