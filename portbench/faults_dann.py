"""Faults a DANN training step can have, and the two controls, each planted
in the program's timed path as ``faults.py``'s are (context managers that
patch the program while they are open). ``correct`` has to come out false
under each of them, in the tests at a size the CPU holds and in
``calibrate_dann`` at the cell's own size on the card.

A DANN step calls the model, ``apply_augment`` and the domain loss twice,
the source stream first; a fault of the target stream acts on every second
call.

* ``grl_kept``: the gradient reversal hands the map +alpha times its
  gradient, the sign kept; caught where the check recomputes the map's
  gradient after the reversal.
* ``target_detached``: the target's logits leave the backward, so its
  domain loss teaches nothing; caught in the gradient at the target's
  logits, which the check takes from the reference's loss.
* ``target_eval``: the target's pass runs in eval mode, so its BatchNorms
  normalize by the running statistics and leave them as they were; caught
  in the target's BatchNorm outputs and in the statistics.
* ``target_augment_left_out``: the target's photometric augmentations hand
  the images back unchanged; caught at the target's stem input.
* ``rmsprop_default_alpha``: RMSprop at torch's default square-average
  decay, 0.99, where the recipe sets 0.9; caught in the update.

The controls compute what the configuration states, float32, in a lower
precision: ``tf32`` leaves cuBLAS and cuDNN their TF32 (which only the card
has), ``bf16`` runs the step's forward under the bf16 autocast of
``--use_fp16``.
"""
from __future__ import annotations

import contextlib
import itertools
from types import SimpleNamespace
from unittest import mock

import torch


def _alternate(source, target):
    """``source`` on a step's first call, ``target`` on its second."""
    calls = itertools.count()

    def call(*args, **kwargs):
        return (target if next(calls) % 2 else source)(*args, **kwargs)

    return call


def grl_kept():
    from speedplusbaseline_tpu_torch.models.revgrad import _GradReverse

    return mock.patch.object(_GradReverse, "backward",
                             staticmethod(lambda ctx, g: (ctx.alpha * g, None)))


def target_detached():
    from speedplusbaseline_tpu_torch.engine import steps

    loss = steps.bce_with_logits
    return mock.patch.object(steps, "bce_with_logits",
                             _alternate(loss, lambda logits, y: loss(logits.detach(), y)))


def target_eval():
    from speedplusbaseline_tpu_torch.models.revgrad import RevGrad

    forward = RevGrad.forward

    def in_eval_mode(self, x, alpha=None):
        self.train(False)
        try:
            return forward(self, x, alpha)
        finally:
            self.train(True)

    return mock.patch.object(RevGrad, "forward", _alternate(forward, in_eval_mode))


def target_augment_left_out():
    from speedplusbaseline_tpu_torch.engine import steps

    def unchanged(images, keypts, d):
        return images.contiguous(memory_format=torch.channels_last), keypts

    return mock.patch.object(steps, "apply_augment", _alternate(steps.apply_augment, unchanged))


def rmsprop_default_alpha():
    from speedplusbaseline_tpu_torch.engine import optim

    build = optim.build_optimizer

    def built(cfg, params):
        return build(SimpleNamespace(**{**vars(cfg), "momentum": 0.99}), params)

    return mock.patch.object(optim, "build_optimizer", built)


@contextlib.contextmanager
def tf32():
    from speedplusbaseline_tpu_torch import config

    def allowed():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        with mock.patch.object(config, "full_f32", allowed):
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def bf16():
    from speedplusbaseline_tpu_torch.engine import steps

    step = steps.dann_step
    return mock.patch.object(steps, "dann_step", lambda *args: step(*args[:-1], True))


FAULTS = {"grl_kept": grl_kept, "target_detached": target_detached, "target_eval": target_eval,
          "target_augment_left_out": target_augment_left_out,
          "rmsprop_default_alpha": rmsprop_default_alpha}
CONTROLS = {"tf32": tf32, "bf16": bf16}
