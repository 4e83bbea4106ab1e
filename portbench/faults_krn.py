"""Faults a KRN training step can have, planted in the program's timed path
as ``faults.py``'s are (context managers that patch the program while they
are open). ``correct`` has to come out false under each of them, in the
tests at a size the CPU holds and in ``calibrate_layerwise`` at the cell's
own size on the card.

* ``unchanged`` (``faults.py``): the step computes its loss and gradients
  and leaves the parameters and the optimizer as they were; the check
  catches it in the update, which it recomputes from the gradients.
* ``restyle_altered`` (``faults.py``): the style augmentor hands its input
  back where it should have restyled it; caught at the stem's input.
* ``half_batch``: ``krn_loss`` takes the first half of the batch, so half
  the images teach nothing; caught in the loss and in the gradient at the
  head's output, which the check takes from the reference's loss.
* ``bn_running_stats``: BatchNorm normalizes a training batch by its
  running statistics instead of the batch's own, as it would in eval
  mode, so nothing is normalized at flax's init (mean 0, variance 1);
  caught in the BatchNorms' outputs.
* ``augment_left_out``: the photometric augmentations hand the images and
  keypoints back unchanged; caught at the stem's input and in the loss.
"""
from __future__ import annotations

from unittest import mock

import torch
import torch.nn.functional as F

from .faults import restyle_altered, unchanged


def half_batch():
    from speedplusbaseline_tpu_torch.engine import steps

    loss = steps.krn_loss

    def half(xc, yc, target):
        h = xc.shape[0] // 2
        return loss(xc[:h], yc[:h], target[:h])

    return mock.patch.object(steps, "krn_loss", half)


def bn_running_stats():
    from speedplusbaseline_tpu_torch.models.layers import BatchNorm

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)

    return mock.patch.object(BatchNorm, "forward", forward)


def augment_left_out():
    from speedplusbaseline_tpu_torch.engine import steps

    def unchanged_images(images, keypts, d):
        return images.contiguous(memory_format=torch.channels_last), keypts

    return mock.patch.object(steps, "apply_augment", unchanged_images)


ALL = {"unchanged": unchanged, "restyle_altered": restyle_altered, "half_batch": half_batch,
       "bn_running_stats": bn_running_stats, "augment_left_out": augment_left_out}


def of(traffic: dict) -> dict:
    """The faults a cell can have: all of them where it restyles."""
    return {k: v for k, v in ALL.items()
            if k != "restyle_altered" or traffic["texture_ratio"] > 0}
