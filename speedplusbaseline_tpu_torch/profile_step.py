"""Time and profile a train step on device-resident batches.

    python -m speedplusbaseline_tpu_torch.profile_step [krn|spn|dann]

krn and spn: the model + style augmentor of the README recipe (batch 48,
AdamW, bf16 autocast, the Ghiasi asset; KRN at 224^2, SPN at 227^2 with 5000
classes); the styled and the plain step are timed in turns (styled, plain,
plain, styled; host clock around ``torch.cuda.synchronize()``), then a few
steps of each are profiled with ``torch.profiler``, which prints the kernels
by device time and the device's busy share of the window. dann: the README
adapt recipe's DANN step (RevGrad at 224^2, batch 16 source + 16 target,
RMSprop, the default optimizer), in f32 and then in bf16 (``--use_fp16``),
each timed and profiled. Needs a GPU.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .augment.styleaug import style_augmentor
from .config import default_cfg, full_f32
from .engine.state import TrainState
from .engine.steps import make_dann_train_step, make_train_step

BATCH, REPS = 48, 10
SIZE = {"krn": 224, "spn": 227, "dann": 224}
SPN_CLASSES, SPN_NEIGHBORS = 5000, 5
DANN_BATCH = 16  # per stream
DANN_ALPHA = 0.5


def build_dann(dev: torch.device, fp16: bool):
    """(state, step, batch) for the DANN step of the README adapt recipe:
    ``batch`` holds a source and a target batch, and ``step(state, batch,
    styled)`` (``styled`` unused: DANN has no restyle) runs one DANN step at
    alpha DANN_ALPHA."""
    S = SIZE["dann"]
    cfg = default_cfg(dann=True, batch_size=DANN_BATCH, input_shape=(S, S), fp16=fp16)
    state = TrainState.for_config(cfg, dev)
    rs = np.random.RandomState(0)
    source = {"image": rs.randint(0, 256, (DANN_BATCH, S, S, 3), np.uint8),
              "keypts": rs.rand(DANN_BATCH, 2, 11).astype(np.float32)}
    target = {"image": rs.randint(0, 256, (DANN_BATCH, S, S, 3), np.uint8)}
    batch = {name: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
             for name, b in (("source", source), ("target", target))}
    dann = make_dann_train_step(cfg, dev)
    return state, lambda st, b, styled: dann(st, b["source"], b["target"], DANN_ALPHA), batch


def build(dev: torch.device, model_name: str = "krn", phase_space: bool = False):
    """(state, train_step, batch) for the styled recipe of ``model_name``;
    ``phase_space`` restyles with the generator's phase-space lowering."""
    S = SIZE[model_name]
    cfg = default_cfg(model_name=model_name, optimizer="adamw", weight_decay=0.01, fp16=True,
                      batch_size=BATCH, input_shape=(S, S), num_classes=SPN_CLASSES)
    state = TrainState.for_config(cfg, dev)
    aug = style_augmentor(cfg, dev, phase_space)
    rs = np.random.RandomState(0)
    data = {"image": rs.randint(0, 256, (BATCH, S, S, 3), np.uint8)}
    if model_name == "krn":
        data["keypts"] = rs.rand(BATCH, 2, 11).astype(np.float32)
    else:  # n-hot targets over SPN_NEIGHBORS classes, as SPNDataset gives them
        y_classes = np.zeros((BATCH, SPN_CLASSES), np.float32)
        y_weights = np.zeros((BATCH, SPN_CLASSES), np.float32)
        for i in range(BATCH):
            idx = rs.choice(SPN_CLASSES, SPN_NEIGHBORS, replace=False)
            y_classes[i, idx] = 1.0 / SPN_NEIGHBORS
            y_weights[i, idx] = rs.dirichlet(np.ones(SPN_NEIGHBORS))
        data.update(y_classes=y_classes, y_weights=y_weights)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return state, make_train_step(cfg, dev, aug), batch


def time_step(state, step, batch, styled: bool) -> float:
    """Mean ms of one step over REPS steps after two warm-up steps."""
    for _ in range(2):
        step(state, batch, styled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        sm = step(state, batch, styled)
    torch.cuda.synchronize()
    if not all(np.isfinite(float(v)) for v in sm.values()):
        raise RuntimeError("non-finite loss")
    return (time.perf_counter() - t0) * 1000 / REPS


def profile(state, step, batch, styled: bool, steps: int = 3, rows: int = 15,
            table: bool = True, label: str = "") -> float:
    """Profile ``steps`` steps; print the device's busy time per step and
    share of the window (and, with ``table``, the kernels by device time);
    return the busy ms per step."""
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
    label = label or ("styled" if styled else "plain")
    print(f"{label} step, {steps} steps profiled: device busy "
          f"{busy_us / 1000 / steps:.2f} ms per step, {100 * busy_us / wall_us:.1f}% of "
          f"the {wall_us / 1000:.2f} ms window (the window includes profiler overhead)",
          flush=True)
    if table:
        print(events.table(sort_by="self_device_time_total", row_limit=rows))
    return busy_us / 1000 / steps


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA GPU")
    args = sys.argv[1:] if argv is None else list(argv)
    model_name = args[0] if args else "krn"
    dev = torch.device("cuda", 0)
    full_f32()
    if model_name == "dann":
        for fp16 in (False, True):
            state, step, batch = build_dann(dev, fp16)
            ms = [time_step(state, step, batch, False) for _ in range(2)]
            label = f"dann {'bf16' if fp16 else 'f32'}"
            print(f"{label} step: {[round(m, 3) for m in ms]} ms (batch {DANN_BATCH} + "
                  f"{DANN_BATCH}, {SIZE['dann']}^2, RMSprop)", flush=True)
            profile(state, step, batch, False, label=label)
            del state, step, batch
        return
    state, step, batch = build(dev, model_name)
    for styled in (True, False, False, True):
        ms = time_step(state, step, batch, styled)
        print(f"{model_name} {'styled' if styled else 'plain'} step: {ms:.3f} ms = "
              f"{BATCH * 1000 / ms:.1f} img/s (batch {BATCH}, {SIZE[model_name]}^2)",
              flush=True)
    profile(state, step, batch, True)
    profile(state, step, batch, False)


if __name__ == "__main__":
    main()
