"""Benchmark: KRN training throughput (images a second on one card), styled
at texture_ratio 0.5, and four secondary measures (the counterpart of the
JAX package's root ``bench.py``, with its measures, inputs, protocol and
keys).

    python -m speedplusbaseline_tpu_torch.bench [--no_cuda]

Prints ONE JSON line, last, with the root bench.py's keys:

  krn   -- ``metric`` ("krn_train_images_per_sec_per_chip"), ``value``
           (img/s), ``unit``, ``vs_baseline`` (against the root bench.py's
           derived estimate of 450 img/s for the reference),
           ``baseline_is_estimate``, ``baseline_img_per_sec``: the KRN
           recipe (224^2, batch 48, AdamW lr 1e-3 wd 0.01, bf16) with a
           host-side bernoulli(0.5) gate per step between the styled and the
           plain step. "Per chip" is per card: one card, where JAX's bench
           spans a mesh of every device;
  eval  -- ``eval_img_s_per_chip``, ``eval_step_ms``: the KRN eval step
           (forward, batched EPnP, SPEED score) at batch 48, bf16;
  dann  -- ``dann_img_s_per_chip`` (source + target images),
           ``dann_step_ms``: the DANN step (RevGrad, 224^2, batch 16 + 16,
           AdamW lr 1e-3 wd 0.01, bf16, alpha 0.5; not the README adapt
           recipe's RMSprop);
  spn   -- ``spn_img_s_per_chip`` (batch over the mean of the two steps),
           ``spn_plain_step_ms``, ``spn_styled_step_ms``: the SPN recipe
           (227^2, 5000 classes, batch 48, AdamW, bf16), each step from a
           fresh state;
  host  -- ``host_native_img_s_per_worker`` (null where the native decode
           core cannot be built), ``host_python_img_s_per_worker``,
           ``host_cached_img_s_per_worker``, ``host_rate_spread`` ([min,
           max] of each path's passes), ``host_cores``, and
           ``host_native_lt_python`` when the native rate is under cv2's:
           one worker's decode + crop rates on 48 synthetic 1920x1200 JPEGs
           (``perf/bench_host_loader``), on the CPU;

and the port's: ``card`` (nvidia-smi's name and power limit, ``"cpu"`` with
``--no_cuda``), ``lowering`` (the styled steps' Ghiasi lowering, ``"plain"``
or ``"phase"``) and, for each train step, the device's busy ms a step over
3 profiled steps taken after its timed chain (``krn_styled_device_busy_ms``,
``krn_plain_device_busy_ms``, ``spn_plain_device_busy_ms``,
``spn_styled_device_busy_ms``; null on the CPU). Numbers are unrounded.

Protocol (``perf/common.py``): a step's time is ``(t(n) - t(1)) / (n - 1)``
on the host clock, each stamp closed by a synchronize, after WARMUP_STEPS
steps; KRN and DANN time 150 steps, SPN 300 and the eval step 100. Each of
krn, eval, dann and spn runs in its own process (``--measure NAME``), once,
with a timeout of 900 s; the host rates run in this one. A measure that
fails, times out or prints no JSON line, or a non-finite loss, makes the
bench raise: nothing is retried or left out. Without a GPU and without
``--no_cuda`` it raises before it runs anything. On the CPU the full sizes
are slow: the measure functions take the sizes and step counts as arguments.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .config import default_cfg
from .engine.steps import make_dann_train_step, make_krn_eval_step, make_train_step
from .perf import bench_host_loader, common

BASELINE_IMG_PER_SEC = 450.0
BATCH = common.BATCH
TEXTURE_RATIO = 0.5
#: Seed of the host-side gate between the styled and the plain KRN step.
GATE_SEED = 7
DANN_BATCH = 16  # per stream, the reference DANN recipe's batch
DANN_ALPHA = 0.5
KRN_STEPS = DANN_STEPS = 150
SPN_STEPS = 300  # the plain SPN step is short: more steps amortize t(1)
EVAL_CALLS = 100
# The eval step's camera, distortion and per-row targets (the root bench.py's).
FOCAL_PX = 0.0176 / 5.86e-6
CAMERA = [[FOCAL_PX, 0.0, 960.0], [0.0, FOCAL_PX, 600.0], [0.0, 0.0, 1.0]]
DIST = [-0.2238, 0.5141, -6.65e-4, -2.14e-4, -0.1312]
EVAL_TILES = {"bbox": [700.0, 1300, 400, 900], "q_gt": [1.0, 0, 0, 0], "t_gt": [0.0, 0, 8.0]}
HOST_IMAGES, HOST_PASSES, HOST_SEED = 48, 3, 3
#: The argv that runs one measure in its own process (``--measure NAME``
#: and the flags follow).
CHILD = [sys.executable, "-m", "speedplusbaseline_tpu_torch.bench"]


def gate_draws(n: int) -> np.ndarray:
    """The first ``n`` draws of the gate: True where a KRN step is styled."""
    return np.random.RandomState(GATE_SEED).rand(n) < TEXTURE_RATIO


def krn_styled_steps(n: int = KRN_STEPS, profiled: bool = True) -> int:
    """Styled KRN steps that ``measure_krn(n=n)`` runs: WARMUP_STEPS, the
    gate's styled draws over the timed chain's n + 2 steps (the settle, t(1)
    and t(n)), and, where it profiles (on the card), the styled profile's
    steps."""
    return (common.WARMUP_STEPS + int(gate_draws(n + 2).sum())
            + (common.PROFILE_STEPS + 1 if profiled else 0))


def spn_styled_steps(n: int = SPN_STEPS, profiled: bool = True) -> int:
    """Styled SPN steps that ``measure_spn(n=n)`` runs."""
    return common.WARMUP_STEPS + n + 2 + (common.PROFILE_STEPS + 1 if profiled else 0)


def measure_krn(dev: torch.device, batch: int = BATCH, side: int = common.SIDE["krn"],
                n: int = KRN_STEPS) -> dict:
    """The headline measure: KRN steps on one resident batch, each styled or
    plain as the gate draws, WARMUP_STEPS styled steps and one plain step
    first; then the busy ms of the styled and the plain step."""
    cfg = common.recipe_cfg("krn", batch, side, randomize_texture=True,
                            texture_ratio=TEXTURE_RATIO)
    data = common.to_device(common.resident_batch(cfg), dev)
    state = common.new_state(cfg, dev)
    aug = common.generator(cfg, dev)
    train_step = make_train_step(cfg, dev, aug)
    gate = np.random.RandomState(GATE_SEED)
    last = {}

    def once():
        last.update(train_step(state, data, gate.rand() < cfg.texture_ratio))

    for _ in range(common.WARMUP_STEPS):
        train_step(state, data, True)
    train_step(state, data, False)
    common.sync(dev)
    per_step = common.timed_chain(once, n, dev)
    common.check_finite("krn", last)
    busy = {s: common.busy_ms(state, train_step, data, s, dev, f"krn {name}")
            for s, name in ((True, "styled"), (False, "plain"))}
    per_chip = batch / per_step
    return {"metric": "krn_train_images_per_sec_per_chip", "value": per_chip, "unit": "img/s",
            "vs_baseline": per_chip / BASELINE_IMG_PER_SEC, "baseline_is_estimate": True,
            "baseline_img_per_sec": BASELINE_IMG_PER_SEC,
            "krn_styled_device_busy_ms": busy[True], "krn_plain_device_busy_ms": busy[False],
            "lowering": common.lowering(aug)}


def eval_inputs(batch: int = BATCH, side: int = common.SIDE["krn"]):
    """(the 11 model points, the batch) from ``RandomState(7)``: the points
    uniform in [-0.4, 0.4] first, then the image; the tiles of EVAL_TILES."""
    rs = np.random.RandomState(7)
    pts = rs.uniform(-0.4, 0.4, size=(11, 3))
    data = {"image": rs.rand(batch, side, side, 3).astype(np.float32)}
    data.update({k: np.tile(v, (batch, 1)).astype(np.float32) for k, v in EVAL_TILES.items()})
    return pts, data


def measure_eval(dev: torch.device, batch: int = BATCH, side: int = common.SIDE["krn"],
                 n: int = EVAL_CALLS) -> dict:
    """The KRN eval step (bf16 forward, EPnP, score) on one resident batch:
    one call to settle, then ``timed_chain`` over ``n`` calls."""
    cfg = default_cfg(batch_size=batch, input_shape=(side, side), fp16=True)
    model = common.new_state(cfg, dev).model
    pts, data = eval_inputs(batch, side)
    data = common.to_device(data, dev)
    ev = make_krn_eval_step(pts, CAMERA, DIST, dev, fp16=True)
    out = {}

    def once():
        out.update(ev(model, data))

    once()
    common.sync(dev)
    per = common.timed_chain(once, n, dev)
    pose = torch.cat([out["q_pr"].flatten(), out["t_pr"].flatten()])
    if not torch.isfinite(pose).all():
        raise RuntimeError("eval: non-finite pose")
    return {"eval_img_s_per_chip": batch / per, "eval_step_ms": per * 1e3}


def dann_cfg(batch: int = DANN_BATCH, side: int = common.SIDE["krn"]):
    """The DANN measure's config: the JAX bench's AdamW recipe, bf16."""
    return default_cfg(dann=True, batch_size=batch, input_shape=(side, side),
                       optimizer="adamw", lr=1e-3, weight_decay=0.01, fp16=True)


def dann_inputs(batch: int = DANN_BATCH, side: int = common.SIDE["krn"]):
    """(source, target) from ``RandomState(0)``: the source image, its
    keypts, then the target image."""
    rs = np.random.RandomState(0)
    source = {"image": rs.rand(batch, side, side, 3).astype(np.float32),
              "keypts": rs.rand(batch, 2, 11).astype(np.float32)}
    return source, {"image": rs.rand(batch, side, side, 3).astype(np.float32)}


def measure_dann(dev: torch.device, batch: int = DANN_BATCH, side: int = common.SIDE["krn"],
                 n: int = DANN_STEPS) -> dict:
    """DANN steps at alpha DANN_ALPHA on resident source and target batches."""
    cfg = dann_cfg(batch, side)
    state = common.new_state(cfg, dev)
    source, target = (common.to_device(b, dev) for b in dann_inputs(batch, side))
    dann = make_dann_train_step(cfg, dev)
    last = {}

    def once():
        last.update(dann(state, source, target, DANN_ALPHA))

    for _ in range(common.WARMUP_STEPS):
        once()
    common.sync(dev)
    per_step = common.timed_chain(once, n, dev)
    common.check_finite("dann", last)
    return {"dann_img_s_per_chip": 2 * batch / per_step, "dann_step_ms": per_step * 1e3}


def measure_spn(dev: torch.device, batch: int = BATCH, side: int = common.SIDE["spn"],
                n: int = SPN_STEPS) -> dict:
    """The plain and then the styled SPN step on one resident batch, each
    from a fresh state (WARMUP_STEPS, then ``timed_chain`` over ``n``, then
    its busy ms); the rate is at texture_ratio 0.5, half of each."""
    cfg = common.recipe_cfg("spn", batch, side)
    data = common.to_device(common.resident_batch(cfg), dev)
    aug = common.generator(cfg, dev)
    train_step = make_train_step(cfg, dev, aug)
    ms, busy = {}, {}
    for styled, name in ((False, "plain"), (True, "styled")):
        state = common.new_state(cfg, dev)
        last = {}

        def once():
            last.update(train_step(state, data, styled))

        for _ in range(common.WARMUP_STEPS):
            once()
        common.sync(dev)
        ms[name] = common.timed_chain(once, n, dev) * 1e3
        common.check_finite(f"spn {name}", last)
        busy[name] = common.busy_ms(state, train_step, data, styled, dev, f"spn {name}")
    return {"spn_img_s_per_chip": batch * 1e3 / (0.5 * (ms["plain"] + ms["styled"])),
            "spn_plain_step_ms": ms["plain"], "spn_styled_step_ms": ms["styled"],
            "spn_plain_device_busy_ms": busy["plain"],
            "spn_styled_device_busy_ms": busy["styled"], "lowering": common.lowering(aug)}


MEASURES = {"krn": measure_krn, "eval": measure_eval, "dann": measure_dann, "spn": measure_spn}


def host_loader_rates(n_images: int = HOST_IMAGES, passes: int = HOST_PASSES) -> dict:
    """One worker's decode + crop rates (``perf/bench_host_loader``) on
    ``n_images`` JPEGs with boxes from ``RandomState(3)``: for each path one
    discarded pass, then the median of ``passes``, and the [min, max] of
    those passes under ``host_rate_spread``."""
    rs = np.random.RandomState(HOST_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "speedplus", "synthetic", "images")
        os.makedirs(img_dir)
        paths = bench_host_loader.make_jpegs(img_dir, n_images)
        boxes = bench_host_loader.rand_boxes(rs, n_images)
        paths_rates = {
            "native": lambda: bench_host_loader.bench_native(paths, boxes),
            "python": lambda: bench_host_loader.bench_python(paths, boxes),
            "cached": lambda: bench_host_loader.bench_python_cached(tmp, paths, boxes)}
        rates, spread = {}, {}
        for path, fn in paths_rates.items():
            fn()
            vals = [fn() for _ in range(passes)]
            if any(v is None for v in vals):  # the native core is not built here
                rates[path] = None
                continue
            rates[path] = statistics.median(vals)
            spread[path] = [min(vals), max(vals)]
    out = {f"host_{path}_img_s_per_worker": rate for path, rate in rates.items()}
    out.update(host_rate_spread=spread, host_cores=os.cpu_count())
    if rates["native"] is not None and rates["native"] < rates["python"]:
        out["host_native_lt_python"] = True
    return out


def run_measure(name: str, flags: Sequence[str]) -> dict:
    """``name`` in its own process (``CHILD --measure name flags``), once."""
    return common.run_child([*CHILD, "--measure", name, *flags], name, common.CHILD_TIMEOUT_S)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m speedplusbaseline_tpu_torch.bench")
    ap.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    ap.add_argument("--measure", choices=sorted(MEASURES),
                    help="run one measure in this process and print its JSON line")
    args = ap.parse_args(argv)
    dev = common.device(args.no_cuda)
    if args.measure:
        record = MEASURES[args.measure](dev)
        print(json.dumps(record), flush=True)
        return record
    flags = ["--no_cuda"] if args.no_cuda else []
    result = {}
    for name in MEASURES:
        result.update(run_measure(name, flags))
    result.update(host_loader_rates())
    return common.emit(result, dev)


if __name__ == "__main__":
    main()
