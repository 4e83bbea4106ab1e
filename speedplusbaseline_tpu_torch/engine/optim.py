"""Optimizers, clipping and the StepLR schedule (counterpart of
``speedplusbaseline_tpu/engine/optim.py``; reference src/nets/build.py:60-78,
train.py:107-109).

The four optimizers map to ``torch.optim`` exactly as the optax chains of
the JAX package do (cfg.momentum doubles as beta1 / the RMS decay):

  sgd     -> SGD(momentum=m, weight_decay=wd): L2 added into the grad, buffer
             b = m*b + g (optax ``trace``)
  rmsprop -> RMSprop(alpha=m, eps=1e-8, weight_decay=wd): eps outside the
             sqrt (optax ``scale_by_rms(eps_in_sqrt=False)``)
  adam    -> Adam(betas=(m, 0.999), eps=1e-8, weight_decay=wd): L2 into grad
  adamw   -> AdamW(betas=(m, 0.999), eps=1e-8, weight_decay=wd): decoupled
             decay, p -= lr*(adam_update + wd*p)

KRN and DANN clip by global norm 1.0 before the step (trainer.py:97,
dann.py:99).
``clip_grad_norm_`` scales by max_norm / (norm + 1e-6); optax by
max_norm / norm. The relative difference is 1e-6 / norm, below f32 noise at
any norm this clip acts on. SPN, unless it is DANN, clips each gradient
element to [-1, 1] (``clip_grad_value_``, trainer.py:184; optax
``clip(1.0)``), as the JAX package's ``spn and not dann``.

Adam and AdamW take torch's fused update (the port's parameters are floating
tensors on CUDA or the CPU, where torch has it): one pass reads p, g, m and v
and writes p, m and v, where the foreach update makes eight passes and a
temporary the size of the model. The formula is the same, but on CUDA the
fused kernel takes 1 - beta from the f32 betas, so its second moment reads
1.3e-5 (relative) from foreach's. The class, and so the profiler's
``Optimizer.step#AdamW.step`` range, stays torch's.
"""
from __future__ import annotations

from typing import Iterable, Type

import torch

KRN_CLIP_NORM = 1.0
SPN_CLIP_VALUE = 1.0


def clip_gradients(model_name: str, params: Iterable[torch.nn.Parameter],
                   dann: bool = False) -> None:
    """The model's clip, in place, between backward and the step."""
    if model_name == "spn" and not dann:
        torch.nn.utils.clip_grad_value_(params, SPN_CLIP_VALUE)
    else:
        torch.nn.utils.clip_grad_norm_(params, KRN_CLIP_NORM)


def step_lr_schedule(base_lr: float, decay_alpha: float, decay_step: int,
                     steps_per_epoch: int):
    """torch StepLR(step_size=decay_step, gamma=decay_alpha) as a function
    of the optimizer step count."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * (decay_alpha ** (epoch // max(decay_step, 1)))

    return schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _keep_update_path(optimizer: torch.optim.Optimizer, state_dict: dict) -> dict:
    """A saved param group carries the update path of the optimizer that
    wrote it, and ``load_state_dict`` would take it over: keep this
    optimizer's, so that a checkpoint of the foreach update resumes fused
    (its ``step`` then moves to the parameters' device)."""
    groups = [{**saved, "fused": live["fused"], "foreach": live["foreach"]}
              for saved, live in zip(state_dict["param_groups"], optimizer.param_groups)]
    return {**state_dict, "param_groups": groups}


def adam(cls: Type[torch.optim.Adam], params: Iterable[torch.nn.Parameter], lr: float,
         beta1: float, weight_decay: float) -> torch.optim.Adam:
    """``cls`` (Adam or AdamW) at betas (beta1, 0.999) and eps 1e-8, fused."""
    optimizer = cls(params, lr=lr, betas=(beta1, 0.999), eps=1e-8,
                    weight_decay=weight_decay, fused=True)
    optimizer.register_load_state_dict_pre_hook(_keep_update_path)
    return optimizer


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    wd, m, lr = cfg.weight_decay, cfg.momentum, cfg.lr
    params = list(params)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=m, weight_decay=wd)
    if cfg.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=m, eps=1e-8, weight_decay=wd)
    if cfg.optimizer == "adam":
        return adam(torch.optim.Adam, params, lr, m, wd)
    if cfg.optimizer == "adamw":
        return adam(torch.optim.AdamW, params, lr, m, wd)
    raise ValueError(f"unknown optimizer: {cfg.optimizer}")
