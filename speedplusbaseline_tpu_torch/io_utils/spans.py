"""The program's own profiler spans at the layer boundaries of training and
evaluation.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
is recording, so the span lands in the same trace as the device kernels and
on their clock; otherwise it is a shared no-op context, which costs one
check of the profiler's state instead of a ``record_function`` (about 10
us on a host core). Whether a span is recorded is decided when it is
entered: a span entered before a profiler starts is not recorded, and one
still open when the profiler stops is exported up to the stop.

The spans, all on the thread that runs the loop:

  speedplus.loader_wait  fetching the next batch (or DANN's pair) from the loader
  speedplus.step         one ``train_step(...)`` call: the host's enqueue of a step
  speedplus.augment      KRN's and DANN's aug draws, and ``apply_augment``
  speedplus.restyle      the style embedding and the Ghiasi generator
  speedplus.forward      the model's forward and the loss
  speedplus.target       DANN's target-stream forward, inside ``speedplus.forward``
  speedplus.domain       DANN's gradient reversal and domain head, once a stream,
                         inside ``speedplus.forward`` (the target's inside
                         ``speedplus.target``); autograd launches its backward
                         outside every span
  speedplus.backward     ``zero_grad`` and ``loss.backward()`` (autograd launches
                         the kernels from its own thread while this one waits)
  speedplus.all_reduce   the gradients' sum over the ranks
  speedplus.clip         the model's gradient clip
  speedplus.optimizer    ``optimizer.step()``
  speedplus.readback     the host blocking on a step's losses, or on eval results
  speedplus.progress     the meters and the progress bar
  speedplus.eval_step    ``eval_step(model, batch)``
"""
from __future__ import annotations

import contextlib

import torch

SPANS = ("speedplus.loader_wait", "speedplus.step", "speedplus.augment",
         "speedplus.restyle", "speedplus.forward", "speedplus.target",
         "speedplus.domain", "speedplus.backward",
         "speedplus.all_reduce", "speedplus.clip", "speedplus.optimizer",
         "speedplus.readback", "speedplus.progress", "speedplus.eval_step")

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` while a profiler is recording."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
