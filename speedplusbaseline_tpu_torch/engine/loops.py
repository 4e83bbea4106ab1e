"""Epoch loops (counterpart of ``speedplusbaseline_tpu/engine/loops.py::
train_epoch`` and ``run_validation``): host-side style gate, meters,
progress bar, TB scalars, per-image dumps, and the loop's profiler spans
(``io_utils/spans.py``)."""
from __future__ import annotations

import os
import os.path as osp
import time
from typing import List

import numpy as np
import torch

from ..io_utils.meters import AverageMeter, report_progress
from ..io_utils.spans import span
from ..parallel.mesh import global_rows, is_main

_END = object()


def _meter_names(model_name: str, dann: bool = False):
    """The loss terms a train step returns (reference trainer.py and dann.py
    meters)."""
    if dann:
        return ("loss_pose", "loss_source", "loss_target")
    return ("loss_c", "loss_r") if model_name == "spn" else ("loss_x", "loss_y")


def style_gate(seed: int, epoch: int) -> np.random.Generator:
    """Per-batch bernoulli(texture_ratio) stream of the JAX loop (reference
    trainer.py:68 ``random.random() < cfg.texture_ratio``), keyed by
    (seed, epoch): both frameworks restyle the same steps."""
    return np.random.Generator(np.random.Philox(
        key=np.uint64([(seed << 20) + epoch, 0x57E1E])))


def _waited(batches):
    """``batches``, each fetch inside a ``speedplus.loader_wait`` span."""
    it = iter(batches)
    while True:
        with span("speedplus.loader_wait"):
            batch = next(it, _END)
        if batch is _END:
            return
        yield batch


def train_epoch(epoch, cfg, state, train_step, loader, writer,
                styled: bool = False, lr_value: float = 0.0, dann_loaders=None,
                dann_alpha_fn=None) -> List[dict]:
    """One training epoch. ``styled`` says whether a style augmentor exists;
    each step is then restyled when the gate draws < texture_ratio.
    For DANN, pass ``dann_loaders=(source_loader, target_loader)`` and
    ``dann_alpha_fn(idx, n_batches) -> alpha`` (dann.py:55-78) in place of
    ``loader``: the epoch zips the two for min(len) steps and calls
    ``train_step(state, source_batch, target_batch, np.float32(alpha))``.
    Returns one record per step: {step, styled, ms} and the loss terms
    (loss_x, loss_y for KRN; loss_c, loss_r for SPN; loss_pose,
    loss_source, loss_target for DANN)."""
    names = _meter_names(cfg.model_name, cfg.dann)
    time_meter = AverageMeter("ms")
    meters = {n: AverageMeter("-") for n in names}
    if dann_loaders is not None:
        source_loader, target_loader = dann_loaders
        source_loader.set_epoch(epoch)
        target_loader.set_epoch(epoch)
        n_batches = min(len(source_loader), len(target_loader))
        batches = zip(source_loader, target_loader)
    else:
        loader.set_epoch(epoch)
        n_batches = len(loader)
        batches = loader
    gate = style_gate(cfg.seed, epoch)
    records: List[dict] = []

    def _flush(pending):
        # Read step i's losses after step i+1 was enqueued, so the host's
        # readback waits on work already done instead of stalling the queue.
        idx, B, sm, ms, was_styled = pending
        with span("speedplus.readback"):
            vals = {k: float(v) for k, v in sm.items()}
        with span("speedplus.progress"):
            time_meter.update(ms, B)
            for name in names:
                meters[name].update(vals[name], B)
            records.append({"step": idx, "styled": was_styled, "ms": ms, **vals})
            report_progress(epoch=epoch, lr=lr_value, epoch_iter=idx + 1,
                            epoch_size=n_batches, time=time_meter, is_train=True,
                            **meters)

    pending = None
    start = time.time()
    for idx, batch in enumerate(_waited(batches)):
        if dann_loaders is not None:
            source_batch, target_batch = batch
            B, step_styled = source_batch["image"].shape[0], False
            alpha = np.float32(dann_alpha_fn(idx, n_batches))
            with span("speedplus.step"):
                sm = train_step(state, source_batch, target_batch, alpha)
        else:
            B = batch["image"].shape[0]
            step_styled = styled and gate.random() < cfg.texture_ratio
            with span("speedplus.step"):
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
        for name in names:
            writer.add_scalar(f"train/{name}", meters[name].avg, epoch)
    return records


_EVAL_KEYS = ("err_q", "err_t", "speed_raw", "speed_mod", "acc")


def run_validation(epoch, cfg, eval_step, model, loader, writer):
    """Batched validation with the reference's metrics and per-image dumps
    (inference.py:95-142): meters eR/eT/speed (raw)/speed (thr), the
    ``Valid/`` scalars and err_q.txt, err_t.txt, speed_raw.txt and
    speed_mod.txt in cfg.logdir, one ``%.5f`` line per test row in CSV
    order. One readback per batch. Returns the four meters.

    Under data parallelism every rank scores its rows of each batch; the
    per-row results and the ``valid`` mask go to every rank through one
    ``all_reduce`` of a zero-filled global buffer, the padding is dropped,
    and rank 0 alone writes the scalars and the dumps."""
    time_meter = AverageMeter("ms")
    meters = {"eR": AverageMeter("deg"), "eT": AverageMeter("m"),
              "speed (raw)": AverageMeter("-"), "speed (thr)": AverageMeter("-")}
    acc_meter = AverageMeter("%")
    dumps = {k: [] for k in _EVAL_KEYS[:4]}

    n_batches = len(loader)
    start = time.time()
    for idx, batch in enumerate(_waited(loader)):
        with span("speedplus.eval_step"):
            out = eval_step(model, batch)
        with span("speedplus.readback"):
            vals = torch.stack([out[k].float() for k in _EVAL_KEYS])
            if "valid" in batch:
                vals = global_rows(torch.cat([vals, batch["valid"].view(1, -1).float()]).T).T
                vals = vals[:-1, vals[-1] > 0.5]
            out = dict(zip(_EVAL_KEYS, vals.cpu().numpy()))
        B = vals.shape[1]
        with span("speedplus.progress"):
            for k, v in dumps.items():
                v.extend(out[k].tolist())
            time_meter.update((time.time() - start) * 1000, B)
            meters["eR"].update(float(np.mean(out["err_q"])), B)
            meters["eT"].update(float(np.mean(out["err_t"])), B)
            meters["speed (raw)"].update(float(np.mean(out["speed_raw"])), B)
            meters["speed (thr)"].update(float(np.mean(out["speed_mod"])), B)
            acc_meter.update(float(np.mean(out["acc"])) * 100, B)
            report_progress(epoch=epoch, lr=float("nan"), epoch_iter=idx + 1,
                            epoch_size=n_batches, time=time_meter, is_train=False,
                            eT=meters["eT"], eR=meters["eR"], speed=meters["speed (raw)"],
                            acc=acc_meter)
        start = time.time()

    if not is_main():
        return meters
    if writer is not None:
        writer.add_scalar("Valid/err_q [deg]", meters["eR"].avg, epoch)
        writer.add_scalar("Valid/err_t [m]", meters["eT"].avg, epoch)
        writer.add_scalar("Valid/speed (raw) [-]", meters["speed (raw)"].avg, epoch)
        writer.add_scalar("Valid/speed (thr) [-]", meters["speed (thr)"].avg, epoch)
    os.makedirs(cfg.logdir, exist_ok=True)
    for key, values in dumps.items():
        with open(osp.join(cfg.logdir, f"{key}.txt"), "w") as f:
            for v in values:
                f.write(f"{v:.5f}\n")
    return meters
