"""Gradients through the forward-only kernels.

``csrc/resblock.cu`` (B1), ``csrc/instancenorm.cu`` (B2),
``csrc/edgeconv.cu`` (the edge convs) and ``csrc/midconv.cu`` (the 3x3
convs of layers 1, 2, 8 and 9) compute forward passes only: their wrappers
write the kernel's output into a fresh tensor,
which autograd cannot see into. ``PlainVJP`` wraps such a call: its forward
is the wrapper's own call (the kernel on CUDA, the plain version on the
CPU), and its backward is the VJP of the plain PyTorch version, recomputed
from the saved inputs. The JAX package differentiates its plain XLA version
too: its Pallas kernels have no VJP.

``needs_grad`` says whether a call must go through it: under grad mode, with
an argument that requires grad. The wrappers call their kernel directly
otherwise, so the frozen generator of a styled step pays no autograd cost.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch


def needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class PlainVJP(torch.autograd.Function):
    """``PlainVJP.apply(fn, plain, kwargs, *args)``: ``fn(*args, **kwargs)``
    forward, the VJP of ``plain(*args, **kwargs)`` backward. ``args`` are
    tensors or None; their gradients come back in their own dtypes."""

    @staticmethod
    def forward(ctx, fn: Callable, plain: Callable, kwargs: Mapping,
                *args: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*args)
        return fn(*args, **kwargs)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            args = [a if a is None else a.detach().requires_grad_(n)
                    for a, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*args, **ctx.kwargs)
            grads = iter(torch.autograd.grad(out, [a for a, n in zip(args, needs) if n],
                                             grad_out))
        return (None, None, None) + tuple(next(grads) if n else None for n in needs)
