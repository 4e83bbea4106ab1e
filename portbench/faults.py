"""Faults planted in the program's timed path, each a context manager that
patches the program while it is open and restores it after. ``correct``
has to come out false under each of them, in the tests at a size the CPU
holds and in ``calibrate`` at the cell's own size on the card.

* ``unchanged``: the step computes its loss and gradients and leaves the
  parameters and the optimizer as they were.
* ``half_batch``: SPN's loss is taken over the first half of the batch.
* ``restyle_altered``: the style augmentor hands its input back where it
  should have restyled it (the cells that restyle).

The cells run on one chip, so the exchange between chips is not among
them.
"""
from __future__ import annotations

from unittest import mock


def unchanged():
    from speedplusbaseline_tpu_torch.engine import steps

    def update(state, model_name, loss, sm, dann=False, clip=True):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.step += 1
        return {k: v.detach() for k, v in sm.items()}

    return mock.patch.object(steps, "_update", update)


def half_batch():
    from speedplusbaseline_tpu_torch.engine import steps

    loss = steps.spn_loss

    def half(classes, weights, y_classes, y_weights):
        h = classes.shape[0] // 2
        return loss(classes[:h], weights[:h], y_classes[:h], y_weights[:h])

    return mock.patch.object(steps, "spn_loss", half)


def restyle_altered():
    from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor

    return mock.patch.object(StyleAugmentor, "__call__",
                             lambda self, x, generator=None, z=None: x.to(self.ghiasi.dtype))


#: The faults a cell can have: all of them where it restyles, else the first two.
ALL = {"unchanged": unchanged, "half_batch": half_batch, "restyle_altered": restyle_altered}


def of(traffic: dict) -> dict:
    return {k: v for k, v in ALL.items()
            if k != "restyle_altered" or traffic["texture_ratio"] > 0}
