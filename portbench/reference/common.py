"""What the plain references share: the arithmetic of every conv and
dense layer, in float32 (TF32 off) or, for the control, with each operand
rounded to float8 first.

Everything here is plain ``torch``: no module of the measured program, no
JAX. Parameters are a dict of tensors keyed by the names the harness
generates them under (``param_spec`` of each model); tensors are NCHW.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

#: The largest finite float8 e4m3 value.
E4M3_MAX = 448.0
#: The draw a flax ``lecun_normal`` init scales: a unit normal truncated at
#: +-2 has this standard deviation.
TRUNC2_STD = 0.87962566103423978


def f32_only() -> None:
    """The reference's float32 is float32: no TF32 in cuDNN or cuBLAS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: The largest finite float8 e5m2 value.
E5M2_MAX = 57344.0


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to float8 ``dtype`` under one scale for the tensor (its
    largest magnitude to ``top``), returned in ``t``'s dtype."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Output(torch.autograd.Function):
    """A float8 product's output: rounded to float8 e4m3 going forward (where
    the configurations' autocast puts out bf16), its gradient rounded to
    float8 e5m2 going back."""

    @staticmethod
    def forward(ctx, y):
        return _round8(y, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """How a conv or dense layer rounds. ``"f32"`` leaves everything in
    float32. ``"fp8"`` (the control, one precision below the bf16 that the
    configurations train in) computes each product as an fp8 path would:
    both operands rounded to float8 e4m3 under a scale per tensor (its
    largest magnitude to 448), the gradient passed straight through them,
    the product accumulated in float32 and put out in e4m3 too, and the
    gradient that comes back to it rounded to e5m2 under a scale per tensor.
    Everything else (norms, activations, the loss, the optimizer) stays
    float32, as the program keeps them outside its bf16 products."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        if self.name == "f32":
            return t
        with torch.no_grad():
            q = _round8(t.detach(), torch.float8_e4m3fn, E4M3_MAX)
        return t + (q - t).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output."""
        return y if self.name == "f32" else _Fp8Output.apply(y)


def conv(p: Params, name: str, x: torch.Tensor, prec: Precision, stride: int = 1,
         padding: int = 0, groups: int = 1, bias: bool = True) -> torch.Tensor:
    b = p[f"{name}.bias"] if bias else None
    return prec.out(F.conv2d(prec(x), prec(p[f"{name}.weight"]), b, stride, padding, 1, groups))


def dense(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.out(F.linear(prec(x), prec(p[f"{name}.weight"]), p[f"{name}.bias"]))


def instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None, relu: bool = False,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over (H, W) with the biased variance, then FiLM
    (``y * gamma + beta``, gamma and beta (B, C)) and an optional ReLU."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[:, :, None, None]
    if beta is not None:
        y = y + beta[:, :, None, None]
    return torch.relu(y) if relu else y


def lecun_fan_in(shape) -> int:
    """The fan-in of a conv (O, I/g, kh, kw) or dense (out, in) weight."""
    n = 1
    for s in shape[1:]:
        n *= int(s)
    return n
