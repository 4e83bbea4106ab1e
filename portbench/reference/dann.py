"""DANN on the Keypoint Regression Network, plain (Ganin et al. 2016,
"Domain-Adversarial Training of Neural Networks", JMLR, arXiv:1505.07818;
as the SPEED+ baseline adapts KRN to the target domain, Park et al. 2021,
"SPEED+: Next-Generation Dataset for Spacecraft Pose Estimation across
Domain Gap", arXiv:2110.03101, upstream ``src/nets/revgrad.py`` and
``dann.py``).

A training step takes a labelled source batch and an unlabelled target
batch, each with its own photometric augmentations. Both pass through KRN
(``reference/krn.py``) in training mode, source first, so that every
BatchNorm's running statistics move twice, by the source batch and then by
the target batch. The domain head reads KRN's 320-channel backbone map (the
output of MobileNetV2 block 17) through the gradient reversal layer, the
identity going forward whose backward multiplies the map's gradient by
-alpha: a 1x1 conv 320 -> 1280 with a bias, ReLU, the mean over the map,
and a 1x1 conv 1280 -> 1 with a bias, one logit an image. The loss is
KRN's keypoint loss on the source batch plus two binary cross-entropies
with logits, each the mean over its batch: the source's logits against 1,
the target's against 0. The target's keypoint outputs reach no loss. The
gradients of all three go back in one backward, are clipped by their
global norm, and RMSprop updates every parameter (torch's, which the
recipe names):

    g <- g + wd p;  s <- a s + (1 - a) g^2;  p <- p - lr g / (sqrt(s) + eps)

with a = 0.9, eps = 1e-8 outside the square root and wd = 5e-5. alpha at
training progress p in [0, 1] is 2 / (1 + exp(-10 p)) - 1.

Departures from upstream ``dann.py``, all of them the program's too:

* KRN's departures (``reference/krn.py``): flax's init, flax's BatchNorm
  (the biased running variance), the head's kernel sized from the input.
* The domain head's weights start as flax's defaults (``lecun_normal``
  kernels, zero biases).
* The domain head reads the map as the program's ``RevGrad`` hands it over,
  where upstream captures it with a forward hook; the mean over the map
  is upstream's ``AvgPool2d(7)`` at 224^2.
* The target batch's keypoints are zeros that the augmentations remap and
  no loss reads.

The network of one stream is KRN's layers under the program's ``net.``
prefix, then the reversal and the domain head, each a ``Layer`` of
``reference/krn.py`` that writes one tensor named by the program's port;
the reversal is built for one alpha (``network(alpha)``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import replace
from typing import Dict, List, Mapping, Tuple

import torch

from . import krn
from .common import Params, Precision, conv

PREFIX = "net."
INPUT = PREFIX + krn.INPUT
HEAD = PREFIX + krn.OUTPUT
DOMAIN_IN = "domain_classifier.conv0:in"
LOGIT = "domain_classifier.conv1:out"
FEATURES, HIDDEN = 320, 1280


def _feature_port() -> str:
    """The backbone map: the tensor KRN's first extra reads."""
    return PREFIX + next(layer.ins[0] for layer in krn.network().layers
                         if layer.out == "extra0.dw.conv:out")


FEATURE = _feature_port()


@contextlib.contextmanager
def float32():
    """The reference's float32 is float32: TF32 off in cuBLAS and cuDNN while
    it computes, each switch as it was after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


#: Added to the (seed, step) seed of a step's generator for the target
#: stream's draws (the source's is KRN's, ``reference/augment.py``).
TARGET_STREAM = 1 << 63


def stream_generator(device: torch.device, seed: int, step: int,
                     target: bool) -> torch.Generator:
    """The generator a stream's augmentations draw from at ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step + (TARGET_STREAM if target else 0))
    return gen


def progress(idx: int, n_batches: int, epoch: int, max_epochs: int) -> float:
    """Training progress p of step ``idx`` of ``n_batches`` in 0-based ``epoch``."""
    return (idx + epoch * n_batches) / max_epochs / n_batches


def grl_alpha(p: float) -> float:
    return 2.0 / (1.0 + math.exp(-10.0 * p)) - 1.0


class _Reverse(torch.autograd.Function):
    """The identity going forward; backward, -alpha times the gradient."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


class _Named(Mapping):
    """``p`` read under ``prefix``: KRN's layers name their parameters
    without the program's ``net.``."""

    def __init__(self, p: Params, prefix: str):
        self.p, self.prefix = p, prefix

    def __getitem__(self, name):
        return self.p[self.prefix + name]

    def __iter__(self):
        return (k[len(self.prefix):] for k in self.p if k.startswith(self.prefix))

    def __len__(self):
        return sum(1 for _ in self)


def _prefixed(layer: krn.Layer) -> krn.Layer:
    return krn.Layer(PREFIX + layer.out, tuple(PREFIX + s for s in layer.ins),
                     lambda p, prec, *xs: layer.fn(_Named(p, PREFIX), prec, *xs),
                     tuple(PREFIX + n for n in layer.params))


def network(alpha: float):
    """One stream's layers in the program's order (KRN's, then the reversal
    at ``alpha`` and the domain head) and KRN's conv + BatchNorm units, all
    under the program's names."""
    net = krn.network()
    c0, c1 = "domain_classifier.conv0", "domain_classifier.conv1"
    net.layers = [_prefixed(layer) for layer in net.layers] + [
        krn.Layer(DOMAIN_IN, (FEATURE,), lambda p, prec, x: _Reverse.apply(x, alpha)),
        krn.Layer(f"{c0}:out", (DOMAIN_IN,), lambda p, prec, x: conv(p, c0, x, prec),
                  (f"{c0}.weight", f"{c0}.bias")),
        krn.Layer(f"{c1}:in", (f"{c0}:out",),
                  lambda p, prec, x: krn.relu(x).mean(dim=(2, 3), keepdim=True)),
        krn.Layer(LOGIT, (f"{c1}:in",), lambda p, prec, x: conv(p, c1, x, prec),
                  (f"{c1}.weight", f"{c1}.bias")),
    ]
    net.units = [replace(u, name=PREFIX + u.name) for u in net.units]
    return net


def param_spec(config: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and BatchNorm statistic, under
    the program's state-dict names."""
    spec = [(PREFIX + n, s, i) for n, s, i in krn.param_spec(config)]
    return spec + [("domain_classifier.conv0.weight", (HIDDEN, FEATURES, 1, 1), "lecun"),
                   ("domain_classifier.conv0.bias", (HIDDEN,), "zeros"),
                   ("domain_classifier.conv1.weight", (1, HIDDEN, 1, 1), "lecun"),
                   ("domain_classifier.conv1.bias", (1,), "zeros")]


def targets(config: dict, gen: torch.Generator, n: int, b: int, assets: str) -> List[dict]:
    """The source batches' keypoints, as KRN's (``reference/krn.py``)."""
    return krn.targets(config, gen, n, b, assets)


def forward(p: Params, x: torch.Tensor, alpha: float,
            prec: Precision = Precision()) -> Dict[str, torch.Tensor]:
    """One stream (B, 3, H, W) in [0, 1] through ``network(alpha)``: every
    tensor by its port."""
    env = {INPUT: x}
    with float32():
        for layer in network(alpha).layers:
            env[layer.out] = layer.fn(p, prec, *(env[s] for s in layer.ins))
    return env


def bce_with_logits(z: torch.Tensor, y: float) -> torch.Tensor:
    """The mean over the batch of -y log s(z) - (1 - y) log(1 - s(z))."""
    return (torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def loss(head_src: torch.Tensor, logit_src: torch.Tensor, logit_tgt: torch.Tensor,
         keypts: torch.Tensor):
    """The step's loss and its three terms, from the source's head output,
    the two streams' logits and the source's keypoints (B, 2, K)."""
    pose, _ = krn.loss(krn.outputs(head_src), {"keypts": keypts})
    src = bce_with_logits(logit_src.reshape(-1), 1.0)
    tgt = bce_with_logits(logit_tgt.reshape(-1), 0.0)
    return pose + src + tgt, {"loss_pose": pose, "loss_source": src, "loss_target": tgt}


TERMS = ("loss_pose", "loss_source", "loss_target")


def running_stats(units, bn_in: List[Mapping[str, torch.Tensor]],
                  stats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every BatchNorm's running mean and variance after the training-mode
    passes whose BatchNorm inputs ``bn_in`` holds (by port, source first),
    from ``stats`` before them."""
    out = {}
    for u in units:
        m, v = f"{u.name}.bn.running_mean", f"{u.name}.bn.running_var"
        mean, var = stats[m], stats[v]
        for env in bn_in:
            x = env[f"{u.name}.conv:out"]
            mean, var = krn.running_stats(x.to(torch.promote_types(x.dtype, torch.float32)),
                                          mean, var)
        out[m], out[v] = mean, var
    return out


clip = krn.clip


class RMSprop:
    """torch's RMSprop (not centered, no momentum), written out: the
    module's docstring."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, alpha: float, eps: float,
                 wd: float):
        self.lr, self.alpha, self.eps, self.wd = lr, alpha, eps, wd
        self.s = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        for k, p in params.items():
            g = grads[k] + self.wd * p
            self.s[k].mul_(self.alpha).add_((1.0 - self.alpha) * g * g)
            p.sub_(self.lr * g / (self.s[k].sqrt() + self.eps))
