"""The first training steps, plain: restyle, forward, loss, backward, clip
and AdamW, from the weights and batches the harness made.

A step restyles the batch when it is a restyled one, then runs the
configuration's reference model (``reference.<name>``: its forward with
its own draws, its loss and its clip). Gradients come from autograd in
float32. AdamW (decoupled decay) updates every parameter:

    p <- p (1 - lr wd);  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p - lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)

``run`` returns what the harness compares: each step's loss, each leaf's
gradient norm at step 1, and each leaf's change over the steps.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import torch

from . import augment, ghiasi
from .common import Precision, f32_only


def model(config: dict):
    """The reference module of a configuration (``reference.<name>``)."""
    return importlib.import_module(f"{__package__}.{config['reference']}")


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def trainable(config: dict) -> List[str]:
    """Names of the parameters the optimizer updates (not the statistics)."""
    return [n for n, _s, _i in model(config).param_spec(config) if ".running_" not in n]


def run(config: dict, weights: Dict[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]],
        styled: Sequence[bool], seed: int, generator_params, style_stats,
        precision: str = "f32", steps: int = 3) -> dict:
    """``steps`` training steps from ``weights`` on ``batches`` (one a step,
    in the loader's format), restyling where ``styled``; ``seed`` is the
    trainer's, whose (seed, step) generator the draws come from. Returns
    {"loss": [...], "grad_norm": {leaf: ...}, "change_norm": {leaf: ...}},
    numbers on the host."""
    f32_only()
    ref = model(config)
    prec = Precision(precision)
    names = trainable(config)
    params = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
    start = {n: weights[n].detach().clone().float() for n in names}
    opt = AdamW(params, config["lr"], config["weight_decay"], (config["momentum"], 0.999))
    losses: List[float] = []
    grad_norm: Dict[str, float] = {}
    for t in range(steps):
        batch = batches[t]
        device = batch["image"].device
        gen = augment.step_generator(device, seed, t)
        x = augment.to_unit(batch["image"])
        if styled[t]:
            z = augment.style_normals(gen, x.shape[0])
            x = ghiasi.restyle(generator_params, style_stats, config["texture_alpha"], x, z,
                               prec)
        outputs = ref.forward(params, x, prec, gen)
        loss, terms = ref.loss(outputs, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        ref.clip(grads)
        if t == 0:
            grad_norm = _norms(grads)
        opt.step(params, grads)
        losses.append(ref.total({k: float(v.detach()) for k, v in terms.items()}))
        del outputs, loss, grads, x
    change = _norms({n: params[n].detach() - start[n] for n in names})
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    vals = torch.stack([tensors[k].float().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))
