"""Time and profile the KRN train step on one device-resident batch.

    python -m speedplusbaseline_tpu_torch.profile_step

Builds the KRN + style augmentor of the README recipe (batch 48, 224^2,
AdamW, bf16 autocast, the Ghiasi asset), times the styled and the plain step in turns (styled,
plain, plain, styled; host clock around ``torch.cuda.synchronize()``), then
profiles a few steps of each with ``torch.profiler`` and prints the kernels
by device time and the device's busy share of the window. Needs a GPU.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .augment.styleaug import StyleAugmentor, load_ghiasi_params, load_style_stats
from .config import default_cfg
from .engine.optim import build_optimizer
from .engine.state import TrainState
from .engine.steps import make_krn_train_step
from .io_utils import default_assets_dir
from .models.krn import KeypointRegressionNet

BATCH, SIZE, REPS = 48, 224, 10


def build(dev: torch.device):
    """(state, train_step, batch) for the styled KRN recipe."""
    cfg = default_cfg(optimizer="adamw", weight_decay=0.01, fp16=True,
                      batch_size=BATCH, input_shape=(SIZE, SIZE))
    model = KeypointRegressionNet(11, (SIZE, SIZE)).to(dev, memory_format=torch.channels_last)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    aug = StyleAugmentor(0.5, load_style_stats(default_assets_dir()), torch.bfloat16, dev)
    aug.ghiasi.load_state_dict(load_ghiasi_params(
        os.path.join(default_assets_dir(), "ghiasi_params.msgpack")))
    rs = np.random.RandomState(0)
    data = {"image": torch.from_numpy(rs.randint(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)),
            "keypts": torch.from_numpy(rs.rand(BATCH, 2, 11).astype(np.float32))}
    return state, make_krn_train_step(cfg, dev, aug), {k: v.to(dev) for k, v in data.items()}


def time_step(state, step, batch, styled: bool) -> float:
    """Mean ms of one step over REPS steps after two warm-up steps."""
    for _ in range(2):
        step(state, batch, styled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        sm = step(state, batch, styled)
    torch.cuda.synchronize()
    if not np.isfinite(float(sm["loss_x"])):
        raise RuntimeError("non-finite loss")
    return (time.perf_counter() - t0) * 1000 / REPS


def profile(state, step, batch, styled: bool, steps: int = 3, rows: int = 15) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    step(state, batch, styled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch, styled)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # Device kernels only (annotations such as Optimizer.step span kernels
    # already counted), as the table's own "Self CUDA time total".
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    print(f"{'styled' if styled else 'plain'} step, {steps} steps profiled: device busy "
          f"{busy_us / 1000 / steps:.2f} ms per step, {100 * busy_us / wall_us:.1f}% of "
          f"the {wall_us / 1000:.2f} ms window (the window includes profiler overhead)")
    print(events.table(sort_by="self_device_time_total", row_limit=rows))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    state, step, batch = build(dev)
    for styled in (True, False, False, True):
        ms = time_step(state, step, batch, styled)
        print(f"{'styled' if styled else 'plain'} step: {ms:.3f} ms = "
              f"{BATCH * 1000 / ms:.1f} img/s (batch {BATCH}, {SIZE}^2)",
              flush=True)
    profile(state, step, batch, True)
    profile(state, step, batch, False)


if __name__ == "__main__":
    main()
