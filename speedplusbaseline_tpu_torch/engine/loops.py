"""Epoch loop (counterpart of ``speedplusbaseline_tpu/engine/loops.py::
train_epoch``): host-side style gate, meters, progress bar, TB scalars."""
from __future__ import annotations

import time
from typing import List

import numpy as np

from ..io_utils.meters import AverageMeter, report_progress

_NAMES = ("loss_x", "loss_y")


def style_gate(seed: int, epoch: int) -> np.random.Generator:
    """Per-batch bernoulli(texture_ratio) stream of the JAX loop (reference
    trainer.py:68 ``random.random() < cfg.texture_ratio``), keyed by
    (seed, epoch): both frameworks restyle the same steps."""
    return np.random.Generator(np.random.Philox(
        key=np.uint64([(seed << 20) + epoch, 0x57E1E])))


def train_epoch(epoch, cfg, state, train_step, loader, writer,
                styled: bool = False, lr_value: float = 0.0) -> List[dict]:
    """One training epoch. ``styled`` says whether a style augmentor exists;
    each step is then restyled when the gate draws < texture_ratio.
    Returns one record per step: {step, styled, loss_x, loss_y, ms}."""
    time_meter = AverageMeter("ms")
    meters = {n: AverageMeter("-") for n in _NAMES}
    loader.set_epoch(epoch)
    n_batches = len(loader)
    gate = style_gate(cfg.seed, epoch)
    records: List[dict] = []

    def _flush(pending):
        # Read step i's losses after step i+1 was enqueued, so the host's
        # readback waits on work already done instead of stalling the queue.
        idx, B, sm, ms, was_styled = pending
        vals = {k: float(v) for k, v in sm.items()}
        time_meter.update(ms, B)
        for name in _NAMES:
            meters[name].update(vals[name], B)
        records.append({"step": idx, "styled": was_styled, "ms": ms, **vals})
        report_progress(epoch=epoch, lr=lr_value, epoch_iter=idx + 1,
                        epoch_size=n_batches, time=time_meter, is_train=True,
                        **meters)

    pending = None
    start = time.time()
    for idx, batch in enumerate(loader):
        B = batch["image"].shape[0]
        step_styled = styled and gate.random() < cfg.texture_ratio
        sm = train_step(state, batch, step_styled)
        # Timestamp BEFORE flushing the lagged readback so step i's recorded
        # wall-time never includes step i-1's host fetch.
        now = time.time()
        if pending is not None:
            _flush(pending)
        pending = (idx, B, sm, (now - start) * 1000, step_styled)
        start = time.time()
    if pending is not None:
        _flush(pending)

    if writer is not None:
        for name in _NAMES:
            writer.add_scalar(f"train/{name}", meters[name].avg, epoch)
    return records
