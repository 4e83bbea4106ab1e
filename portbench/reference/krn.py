"""The Keypoint Regression Network, plain (Park, Sharma and D'Amico 2019,
"Towards Robust Learning-Based Pose Estimation of Noncooperative
Spacecraft", arXiv:1909.00392; the SPEED+ baseline's
``src/nets/park2019.py:101-165``).

A MobileNetV2 trunk (Sandler et al. 2018, arXiv:1801.04381, Table 2),
``features[0:18]``: a 3x3 / 2 stem to 32 channels, then 17 inverted
residual blocks (expand 1x1 + ReLU6 where the ratio is not 1, depthwise 3x3
+ ReLU6, linear project 1x1; the input added back where the stride is 1
and the width is kept). The output of block 13 (96 channels at 14^2) is
the skip tap. Then three depthwise-separable ``ConvDw`` extras, each 3x3
depthwise + BN + ReLU and 1x1 pointwise + BN + ReLU: 320 -> 1024, 1024 ->
1024, and after ``RouterV2`` 1280 -> 1024. The router: a 1x1 conv from 96
to 64 channels + BN + LeakyReLU(0.2) on the tap, a 2x2 space-to-depth
(out channel (s_h * 2 + s_w) * 64 + c), concatenated in front of the
extras' stream to 1280 channels at 7^2. The head: one conv over the whole
map (7x7 at 224^2, no padding, with a bias) to 2K numbers, read as
(x_0, y_0, x_1, y_1, ...). Every other conv is unbiased and followed by a
BatchNorm. The loss sums over the keypoints and over x and y the batch
mean of the squared error; the trainer clips the gradients by their global
norm to the configuration's ``clip_norm`` (1.0 in the recipe).

Departures from ``park2019.py``, all of them the program's too:

* Weights start as flax's defaults (``lecun_normal`` kernels, zero biases,
  BatchNorm scales and variances one), not torch's.
* BatchNorm is flax's (momentum 0.9, eps 1e-5): in training mode it
  normalizes with the batch's mean and biased variance, and the running
  variance takes the biased variance too (torch's takes the unbiased one).
* The head's kernel is sized from the input, ceil(H / 32) x ceil(W / 32),
  where ``park2019.py`` fixes it at 7x7.
* Convs pad k // 2 on every side, as torch's do.

The network is a list of ``Layer``s, each a function of (parameters,
inputs) that writes one tensor: a conv, a BatchNorm, or a junction (an
activation, the residual sum, the router's reorder and concatenation). A
tensor is named by a port of the program's module that reads or writes it,
``<module>:in`` or ``<module>:out``; the input is ``base.stem.conv:in``.
``forward`` runs the list; a check that recomputes one layer alone hands it
the program's own inputs.

The targets of a batch, in the loader's format ((B, 2, K), normalized to
the crop): the K points of ``assets/tango_points.npy`` (P, K x 3, metres)
turned by a random attitude q (a unit quaternion, a normalized 4-normal,
so uniform over rotations), projected orthographically, u = R(q) P^T, and
scaled into the crop axis by axis:

    x_k = 0.1 + 0.8 (u_0k - min_j u_0j) / (max_j u_0j - min_j u_0j)

and y_k likewise from the second row u_1.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .common import Params, Precision, conv

#: (expand ratio t, out channels c, repeats n, first stride s): MobileNetV2's
#: inverted residual schedule.
IR_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
TAP = 13
EXTRA = 1024
ROUTER = 64
INPUT = "base.stem.conv:in"
OUTPUT = "head:out"
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclass(frozen=True)
class Layer:
    """``out = fn(p, prec, *inputs)``, the inputs being the tensors named
    by ``ins``; ``params`` are the parameters it reads."""
    out: str
    ins: Tuple[str, ...]
    fn: Callable
    params: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Unit:
    """A conv (no bias) + BatchNorm pair."""
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    groups: int


# The activations pass no gradient at their kinks (x = 0, and x = 6 for
# ReLU6), as torch's do.
def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 6, relu(x), 6.0)


def leaky02(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.2 * x)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2): out channel (s_h * 2 + s_w) * C + c
    holds x[:, c, 2i + s_h, 2j + s_w] (park2019.py's reorg)."""
    return torch.cat([x[:, :, sh::block, sw::block] for sh in range(block)
                      for sw in range(block)], dim=1)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Training mode: normalized by the batch's mean and biased variance
    over (B, H, W), then scaled and shifted."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * weight.view(1, -1, 1, 1) \
        + bias.view(1, -1, 1, 1)


def running_stats(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """The running (mean, variance) after a training-mode forward on x:
    m <- 0.9 m + 0.1 batch mean, v <- 0.9 v + 0.1 biased batch variance."""
    bm = x.mean(dim=(0, 2, 3))
    bv = (x - bm.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    return (BN_MOMENTUM * mean + (1.0 - BN_MOMENTUM) * bm,
            BN_MOMENTUM * var + (1.0 - BN_MOMENTUM) * bv)


class _Value:
    """A tensor on its way to the next conv: ``fn`` of the tensors ``srcs``,
    or ``srcs[0]`` itself where ``fn`` is None."""

    def __init__(self, srcs: Tuple[str, ...], fn: Callable = None):
        self.srcs, self.fn = srcs, fn

    def __call__(self, *xs):
        return xs[0] if self.fn is None else self.fn(*xs)

    def then(self, act: Callable) -> "_Value":
        return _Value(self.srcs, lambda *xs: act(self(*xs)))


class _Net:
    def __init__(self):
        self.layers: List[Layer] = []
        self.units: List[Unit] = []

    def take(self, v: _Value, port: str) -> str:
        """The name of the tensor that the reader at ``port`` takes: ``v``'s
        own where it is one tensor unchanged, else a junction made there."""
        if v.fn is None:
            return v.srcs[0]
        self.layers.append(Layer(port, v.srcs, lambda p, prec, *xs: v(*xs)))
        return port

    def unit(self, name: str, v: _Value, cin: int, cout: int, k: int, stride: int,
             groups: int, act) -> _Value:
        """conv + BatchNorm reading ``v``; the BatchNorm's output with
        ``act`` pending."""
        src = self.take(v, f"{name}.conv:in")
        self.units.append(Unit(name, cin, cout, k, stride, groups))
        conv_name, bn_name = f"{name}.conv", f"{name}.bn"

        def conv_fn(p, prec, x):
            return conv(p, conv_name, x, prec, stride, k // 2, groups, bias=False)

        def bn_fn(p, prec, x):
            return batch_norm(x, p[f"{bn_name}.weight"], p[f"{bn_name}.bias"])

        self.layers.append(Layer(f"{conv_name}:out", (src,), conv_fn, (f"{conv_name}.weight",)))
        self.layers.append(Layer(f"{bn_name}:out", (f"{conv_name}:out",), bn_fn,
                                 (f"{bn_name}.weight", f"{bn_name}.bias")))
        out = _Value((f"{bn_name}:out",))
        return out.then(act) if act is not None else out


def network() -> _Net:
    """KRN's layers in the program's order and its conv + BatchNorm units."""
    net = _Net()
    v = net.unit("base.stem", _Value((INPUT,)), 3, 32, 3, 2, 1, relu6)
    cin, idx, tap = 32, 1, None
    for t, c, n, s in IR_SETTINGS:
        for i in range(n):
            b, stride, hidden = f"base.block{idx}", s if i == 0 else 1, cin * t
            first = "expand" if t != 1 else "depthwise"
            x = net.take(v, f"{b}.{first}.conv:in")
            h = _Value((x,))
            if t != 1:
                h = net.unit(f"{b}.expand", h, cin, hidden, 1, 1, 1, relu6)
            h = net.unit(f"{b}.depthwise", h, hidden, hidden, 3, stride, hidden, relu6)
            h = net.unit(f"{b}.project", h, hidden, c, 1, 1, 1, None)
            if stride == 1 and cin == c:
                v = _Value((x, h.srcs[0]), lambda a, y: a + y)
            else:
                v = h
            if idx == TAP:
                # The tap is the tensor that block TAP + 1's expand conv reads.
                tap = net.take(v, f"base.block{idx + 1}.expand.conv:in")
                v = _Value((tap,))
            cin, idx = c, idx + 1
    v = net.unit("extra0.dw", v, cin, cin, 3, 1, cin, relu)
    v = net.unit("extra0.pw", v, cin, EXTRA, 1, 1, 1, relu)
    v = net.unit("extra1.dw", v, EXTRA, EXTRA, 3, 1, EXTRA, relu)
    v = net.unit("extra1.pw", v, EXTRA, EXTRA, 1, 1, 1, relu)
    r = net.unit("router.conv", _Value((tap,)), 96, ROUTER, 1, 1, 1, leaky02)
    cat = _Value(r.srcs + v.srcs, lambda a, y: torch.cat([space_to_depth(r(a)), v(y)], dim=1))
    width = 4 * ROUTER + EXTRA
    v = net.unit("extra3.dw", cat, width, width, 3, 1, width, relu)
    v = net.unit("extra3.pw", v, width, EXTRA, 1, 1, 1, relu)
    head_in = net.take(v, "head:in")
    net.layers.append(Layer(OUTPUT, (head_in,), lambda p, prec, x: conv(p, "head", x, prec),
                            ("head.weight", "head.bias")))
    return net


def head_kernel(config: dict) -> Tuple[int, int]:
    side = config["input_side"]
    return -(-side // 32), -(-side // 32)


def param_spec(config: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and BatchNorm statistic, under
    the program's state-dict names."""
    spec: List[Tuple[str, tuple, str]] = []
    for u in network().units:
        spec += [(f"{u.name}.conv.weight", (u.cout, u.cin // u.groups, u.k, u.k), "lecun"),
                 (f"{u.name}.bn.weight", (u.cout,), "ones"),
                 (f"{u.name}.bn.bias", (u.cout,), "zeros"),
                 (f"{u.name}.bn.running_mean", (u.cout,), "zeros"),
                 (f"{u.name}.bn.running_var", (u.cout,), "ones")]
    out = 2 * config["num_keypoints"]
    spec += [("head.weight", (out, EXTRA, *head_kernel(config)), "lecun"),
             ("head.bias", (out,), "zeros")]
    return spec


def outputs(head_out: torch.Tensor):
    """The head's (B, 2K, 1, 1) -> (xc, yc), each (B, K)."""
    y = head_out.reshape(head_out.shape[0], -1)
    return y[:, 0::2], y[:, 1::2]


def forward(p: Params, x: torch.Tensor, prec: Precision, gen: torch.Generator = None):
    """(B, 3, H, W) in [0, 1] -> (xc, yc), each (B, K). KRN draws nothing in
    its forward; ``gen`` is the interface's."""
    env = {INPUT: x}
    for layer in network().layers:
        env[layer.out] = layer.fn(p, prec, *(env[s] for s in layer.ins))
    return outputs(env[OUTPUT])


def loss(outs, target: Dict[str, torch.Tensor]):
    """Sum over keypoints and over x and y of the batch-mean squared error;
    ``target["keypts"]`` (B, 2, K)."""
    xc, yc = outs
    kp = target["keypts"]
    loss_x = (xc - kp[:, 0]).square().mean(dim=0).sum()
    loss_y = (yc - kp[:, 1]).square().mean(dim=0).sum()
    return loss_x + loss_y, {"loss_x": loss_x, "loss_y": loss_y}


def total(terms: Dict[str, float]) -> float:
    return terms["loss_x"] + terms["loss_y"]


def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by max_norm / their global norm where it is larger."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    for g in grads.values():
        g.mul_(scale.to(g.dtype))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q.unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def targets(config: dict, gen: torch.Generator, n: int, b: int, assets: str) -> List[dict]:
    """``n`` batches of ``b`` rows' keypoints (B, 2, K), drawn from ``gen``
    on its device (the module's docstring has the formula)."""
    device = gen.device
    points = torch.as_tensor(np.load(os.path.join(assets, config["keypoints"])),
                             dtype=torch.float32, device=device)[:config["num_keypoints"]]
    q = torch.randn((n, b, 4), generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    u = (rotation(q) @ points.T)[:, :, :2]
    lo, hi = u.amin(-1, keepdim=True), u.amax(-1, keepdim=True)
    kp = 0.1 + 0.8 * (u - lo) / (hi - lo)
    return [{"keypts": kp[i].contiguous()} for i in range(n)]

