"""The Spacecraft Pose Network, plain (Sharma and D'Amico 2019, "Pose
estimation for non-cooperative spacecraft rendezvous using convolutional
neural networks", arXiv:1809.07238; the SPEED+ baseline's ``spn.py``).

An AlexNet trunk: conv1 11x11 / 4 (96), ReLU, max pool 3 / 2, local
response norm; conv2 5x5 in two groups (256), ReLU, pool, LRN; conv3 3x3
(384), conv4 3x3 in two groups (384), conv5 3x3 in two groups (256), each
with a ReLU, and a last pool. The pooled map is flattened in (H, W, C)
order and feeds two branches of three dense layers, 4096, 4096 and the
classes: attitude classification (fc6-fc8) and attitude weights (fc9-fc11),
with dropout 0.5 after each hidden layer. The LRN pads the channels with
one zero in front and averages x^2 over a window of 2: x / (1 + 2e-5
mean)^0.75. The loss is the soft-label cross-entropy of the classes plus 10
times that of the weights; the trainer clips each gradient element to
[-1, 1].

The targets of a batch, in the loader's format: n-hot rows over the
``num_neighbors`` attitude classes nearest a random attitude, and weights
1 - theta / pi^2 over them, normalized.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Params, Precision, conv, dense

#: (name, in, out, kernel, stride, padding, groups).
CONVS = (("conv1", 3, 96, 11, 4, 0, 1), ("conv2", 96, 256, 5, 1, 2, 2),
         ("conv3", 256, 384, 3, 1, 1, 1), ("conv4", 384, 384, 3, 1, 1, 2),
         ("conv5", 384, 256, 3, 1, 1, 2))
HIDDEN = 4096
DROP = 0.5
CLIP_VALUE = 1.0


def pooled(n: int) -> int:
    n = (n - 11) // 4 + 1
    for _ in range(3):
        n = (n - 3) // 2 + 1
    return n


def param_spec(config: dict) -> List[Tuple[str, tuple, str]]:
    spec: List[Tuple[str, tuple, str]] = []
    for name, cin, cout, k, _s, _p, g in CONVS:
        spec += [(f"{name}.weight", (cout, cin // g, k, k), "lecun"),
                 (f"{name}.bias", (cout,), "zeros")]
    flat = 256 * pooled(config["input_side"]) ** 2
    for a, b, c in (("fc6", "fc7", "fc8"), ("fc9", "fc10", "fc11")):
        for name, cin, cout in ((a, flat, HIDDEN), (b, HIDDEN, HIDDEN),
                                (c, HIDDEN, config["num_classes"])):
            spec += [(f"{name}.weight", (cout, cin), "lecun"), (f"{name}.bias", (cout,), "zeros")]
    return spec


def _lrn(x: torch.Tensor, size: int = 2, alpha: float = 2e-5, beta: float = 0.75,
         k: float = 1.0) -> torch.Tensor:
    c = x.shape[1]
    sq = F.pad(x.square(), (0, 0, 0, 0, size // 2, (size - 1) // 2))
    mean = sum(sq[:, i:i + c] for i in range(size)) / size
    return x / torch.pow(k + alpha * mean, beta)


def forward(p: Params, x: torch.Tensor, prec: Precision, gen: torch.Generator):
    """(B, 3, H, W) -> (classes, weights); the four dropout masks are drawn
    from ``gen``, fc6, fc7, fc9 then fc10, each ``rand(B, 4096) >= 0.5``."""
    def c(name, y):
        _, _, _, _, s, pad, g = next(v for v in CONVS if v[0] == name)
        return F.relu(conv(p, name, y, prec, s, pad, g))

    def pool(y):
        return F.max_pool2d(y, 3, 2)

    def drop(y):
        keep = torch.rand(y.shape, generator=gen, device=y.device) >= DROP
        return y * keep.to(y.dtype) / (1.0 - DROP)

    y = _lrn(pool(c("conv1", x)))
    y = _lrn(pool(c("conv2", y)))
    y = pool(c("conv5", c("conv4", c("conv3", y))))
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    h = drop(F.relu(dense(p, "fc6", y, prec)))
    h = drop(F.relu(dense(p, "fc7", h, prec)))
    classes = dense(p, "fc8", h, prec)
    h = drop(F.relu(dense(p, "fc9", y, prec)))
    h = drop(F.relu(dense(p, "fc10", h, prec)))
    return classes, dense(p, "fc11", h, prec)


def _xent(logits, target):
    return torch.mean(-torch.sum(target * F.log_softmax(logits, dim=1), dim=1))


def loss(outputs, target: Dict[str, torch.Tensor]):
    classes, weights = outputs
    loss_c = _xent(classes, target["y_classes"])
    loss_r = _xent(weights, target["y_weights"])
    return loss_c + 10.0 * loss_r, {"loss_c": loss_c, "loss_r": loss_r}


def total(terms: Dict[str, float]) -> float:
    return terms["loss_c"] + 10.0 * terms["loss_r"]


def clip(grads: Dict[str, torch.Tensor]) -> None:
    for g in grads.values():
        g.clamp_(-CLIP_VALUE, CLIP_VALUE)


def targets(config: dict, gen: torch.Generator, n: int, b: int, assets: str) -> List[dict]:
    """``n`` batches of ``b`` rows' targets, drawn from ``gen`` on its device."""
    device = gen.device
    q_class = torch.as_tensor(np.load(os.path.join(assets, config["attitude_classes"])),
                              dtype=torch.float32, device=device)[:config["num_classes"]]
    q = torch.randn((n, b, 4), generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    angles = 2.0 * torch.acos(torch.clamp((q @ q_class.T).abs(), max=1.0))
    near, idx = torch.topk(angles, config["num_neighbors"], dim=-1, largest=False)
    w = 1.0 - near / math.pi ** 2
    w = w / w.sum(-1, keepdim=True)
    yc = torch.zeros((n, b, config["num_classes"]), device=device)
    yc.scatter_(-1, idx, 1.0 / config["num_neighbors"])
    yw = torch.zeros_like(yc).scatter_(-1, idx, w)
    return [{"y_classes": yc[i], "y_weights": yw[i]} for i in range(n)]
