"""Training on resident batches: the program's own loop, step and optimizer,
timed over a window.

Set-up builds one train state as the program's trainer does (the model with
weights the benchmark draws on the device from the seed, AdamW, the bf16
autocast, the style augmentor on the shipped generator), and one step with
``make_train_step``. ``engine.loops.train_epoch`` drives it over a source of
a few distinct batches held on the device, in the loader's format. The
first ``WARMUP`` steps are set-up: they run every shape the cell uses, and
the first three of them are what ``correct`` compares with the plain
reference. Then the window: ``train_epoch`` runs until ``seconds`` have
passed and the last step has been read back.

The restyle is gated by the harness, not the program's Bernoulli draw:
every block of 4 steps restyles exactly ``texture_ratio * 4`` of them, in
an order drawn from the seed, and ``train_epoch`` is given
``styled=False``. A step's time is the interval between two successive
readbacks of its loss: the loop asks the source for batch i + 1 right
after it has read back step i - 1, so the source's stamps of its requests
mark them.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import trace as tr
from ..reference import ghiasi as ref_ghiasi
from ..reference import train as ref_train
from ..reference.common import TRUNC2_STD, lecun_fan_in

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.path.join(ROOT, "assets")
#: Steps run before the window, two blocks of the gate.
WARMUP = 8
#: Steps compared with the reference.
COMPARED = 3
BLOCK = 4
#: The traced stretch: it starts this many steps into the window and holds
#: this many, whole blocks of the gate both.
STRETCH_AT, STRETCH_STEPS = 8, 16


@dataclass
class Seeds:
    weights: int
    data: int
    gate: int
    program: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        s = np.random.SeedSequence(int(seed) & (2 ** 128 - 1)).generate_state(4, dtype=np.uint64)
        return cls(int(s[0] >> np.uint64(1)), int(s[1] >> np.uint64(1)),
                   int(s[2]), int(s[3] % np.uint64(2 ** 31)))


def make_weights(spec, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic of ``spec``: kernels as flax's default
    init draws them (a normal truncated at +-2, scaled to variance
    1 / fan_in), all of them from one draw on the device; biases and
    BatchNorm shifts and means zero, BatchNorm scales and variances one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = [(n, s) for n, s, kind in spec if kind == "lecun"]
    sizes = [math.prod(s) for _, s in drawn]
    lo, hi = 0.5 * math.erfc(2 / math.sqrt(2)), 0.5 * math.erfc(-2 / math.sqrt(2))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    flat = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    scales = torch.tensor([math.sqrt(1.0 / lecun_fan_in(s)) / TRUNC2_STD for _, s in drawn],
                          dtype=torch.float32, device=device)
    flat.mul_(scales.repeat_interleave(torch.tensor(sizes, device=device),
                                       output_size=sum(sizes)))
    out = dict(zip([n for n, _ in drawn],
                   (v.view(s) for v, (_, s) in zip(flat.split(sizes), drawn))))
    for n, s, kind in spec:
        if kind != "lecun":
            out[n] = (torch.ones if kind == "ones" else torch.zeros)(s, device=device)
    return out


def make_batches(config: dict, traffic: dict, seed: int, device: torch.device) -> List[dict]:
    """``traffic["distinct_batches"]`` batches in the loader's format: uint8
    (B, S, S, 3) images, then the targets the configuration's reference
    draws (``targets``), all from one generator on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, b, s = traffic["distinct_batches"], traffic["batch"], config["input_side"]
    images = torch.randint(0, 256, (n, b, s, s, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    targets = ref_train.model(config).targets(config, gen, n, b, ASSETS)
    return [{"image": images[i], **targets[i]} for i in range(n)]


class Gate:
    """Which steps restyle: in each block of 4, exactly ``round(4 * ratio)``,
    at places drawn from ``seed``; in the first block, which set-up runs,
    the restyled steps come first, so that the first step compared with the
    reference is a restyled one wherever the mix restyles."""

    def __init__(self, ratio: float, seed: int):
        self.k = round(BLOCK * ratio)
        if abs(self.k - BLOCK * ratio) > 1e-9:
            raise ValueError(f"texture_ratio {ratio} is not a whole share of {BLOCK} steps")
        self.rng = np.random.default_rng(seed)
        self.plan: List[bool] = [i < self.k for i in range(BLOCK)]

    def __getitem__(self, i: int) -> bool:
        while len(self.plan) <= i:
            self.plan.extend(bool(v) for v in self.rng.permutation(BLOCK) < self.k)
        return self.plan[i]


class Restyle:
    """The style augmentor as the step calls it, inside a span of its own."""

    def __init__(self, aug):
        self.aug = aug

    def __call__(self, x, generator=None, z=None):
        with torch.profiler.record_function(tr.RESTYLE_SPAN):
            return self.aug(x, generator, z)


class Stepper:
    """The program's step as ``train_epoch`` calls it: ignores the loop's
    ``styled`` and takes the gate's; runs ``hooks[i](state)`` before step i;
    each step inside a span of its own."""

    def __init__(self, step, gate: Gate, hooks: Dict[int, Callable]):
        self.step, self.gate, self.hooks, self.i = step, gate, hooks, 0

    def __call__(self, state, batch, styled):
        i = self.i
        if i in self.hooks:
            self.hooks[i](state)
        self.i += 1
        with torch.profiler.record_function(tr.STEP_SPAN):
            return self.step(state, batch, self.gate[i])


class Source:
    """The loader's part: batches cycled from ``batches``, the i-th request
    of the whole run served batch i mod their number. ``open(limit=n)``
    serves n batches; ``open(deadline=t)`` serves until the clock passes t.
    Every request is stamped, the last (refused) one too; ``on_request``
    maps a window request's index to a call made before it is served."""

    def __init__(self, batches: List[dict]):
        self.batches, self.served = batches, 0
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.stamps: List[float] = []
        self.on_request: Dict[int, Callable] = {}

    def open(self, limit: Optional[int] = None, deadline: Optional[float] = None) -> None:
        self.limit, self.deadline, self.stamps = limit, deadline, []

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.limit if self.limit is not None else 10 ** 6

    def __iter__(self):
        while True:
            k = len(self.stamps)
            if k in self.on_request:
                self.on_request[k]()
            now = time.perf_counter()
            self.stamps.append(now)
            if (self.limit is not None and k >= self.limit) or (
                    self.deadline is not None and now >= self.deadline):
                return
            batch = self.batches[self.served % len(self.batches)]
            self.served += 1
            yield batch


@dataclass
class Outcome:
    """What a run hands the harness."""
    setup_phases: Dict[str, float]
    window_s: float
    steps: int
    images: int
    step_ms: List[float]
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, dict]
    end_to_end: Dict[str, float]
    trace: Optional[dict] = None
    readings: Dict[str, object] = field(default_factory=dict)


@dataclass
class Context:
    """What the per-layer readers read: the traced stretch of ``steps``
    steps (``styled`` says which restyled), its device events (those the
    steps launched), their busy and spanned microseconds, the host's
    enqueue ms of the window's other steps, the shapes and the card's
    peaks (None where none are known)."""
    config: dict
    traffic: dict
    trace: tr.Trace
    events: List[tr.DeviceEvent]
    styled: List[bool]
    dispatch_ms: List[float]
    peak: Optional[dict]
    busy_us: float
    window_us: float
    tid: object

    @property
    def steps(self) -> int:
        return len(self.styled)

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    def launched_in(self, name: str) -> List[tr.DeviceEvent]:
        """The stretch's device events launched inside spans ``name``."""
        return self.trace.launched_in(self.trace.spans(name), self.events)

    def breakdown(self) -> dict:
        return {"device_ops": tr.top_ops(self.events),
                "idle_gaps": tr.idle_by_host(self.trace, self.events, self.tid)}


def context(cell, out: Outcome, kind: str) -> Context:
    from .. import work

    trace = out.trace["trace"]
    steps = trace.spans(tr.STEP_SPAN)
    events = trace.launched_in(steps)
    span = (max(e.ts + e.dur for e in events) - min(e.ts for e in events)) if events else 0.0
    try:
        peak = work.peaks(kind)
    except KeyError:
        peak = None
    return Context(cell.config, cell.traffic, trace, events, out.trace["styled"],
                   out.trace["dispatch_ms"], peak, tr.union_us(events), span,
                   steps[0].tid if steps else None)


def program_cfg(config: dict, traffic: dict, seed: int):
    from speedplusbaseline_tpu_torch.config import default_cfg

    side = config["input_side"]
    kw = dict(model_name=config["model_name"], batch_size=traffic["batch"],
              input_shape=(side, side), optimizer=config["optimizer"], lr=config["lr"],
              weight_decay=config["weight_decay"], momentum=config["momentum"],
              fp16=config["fp16"], seed=seed, texture_alpha=config["texture_alpha"],
              texture_ratio=traffic["texture_ratio"],
              randomize_texture=traffic["texture_ratio"] > 0)
    for key in ("num_keypoints", "num_classes", "num_neighbors"):
        if key in config:
            kw[key] = config[key]
    return default_cfg(**kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, traffic: dict, seeds: Seeds, device: torch.device, phases: dict):
    """The program's state, step, gate, source and the benchmark's weights
    and batches; ``phases`` gets each part's seconds."""
    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
    phases["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    from speedplusbaseline_tpu_torch.augment.styleaug import (StyleAugmentor,
                                                                load_ghiasi_params,
                                                                load_style_stats)
    from speedplusbaseline_tpu_torch.engine.optim import build_optimizer
    from speedplusbaseline_tpu_torch.engine.state import TrainState
    from speedplusbaseline_tpu_torch.engine.steps import make_train_step
    from speedplusbaseline_tpu_torch.models.build import get_model
    from speedplusbaseline_tpu_torch.ops import _build

    phases["program_import"] = time.perf_counter() - t
    # As the trainer (train.py) sets them: float32 math is float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    cfg = program_cfg(config, traffic, seeds.program)
    weights = make_weights(ref_train.model(config).param_spec(config), seeds.weights, device)
    _sync(device)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = make_batches(config, traffic, seeds.data, device)
    _sync(device)
    phases["batches"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.device("meta"):
        model = get_model(cfg)
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    _sync(device)
    phases["model"] = time.perf_counter() - t

    aug = None
    if traffic["texture_ratio"] > 0:
        t = time.perf_counter()
        torch.manual_seed(cfg.seed + 1)
        aug = StyleAugmentor(cfg.texture_alpha, load_style_stats(ASSETS),
                             dtype=torch.bfloat16 if cfg.fp16 else torch.float32, device=device)
        aug.ghiasi.load_state_dict(load_ghiasi_params(os.path.join(ASSETS, config["generator"])))
        _sync(device)
        phases["generator_asset"] = time.perf_counter() - t
        if device.type == "cuda":
            t = time.perf_counter()
            for name in _build.SOURCES:
                _build.load(name)
            phases["kernel_load"] = time.perf_counter() - t
    step = make_train_step(cfg, device, Restyle(aug) if aug is not None else None)
    return cfg, state, step, weights, batches


def _epoch(cfg, state, stepper, source, epoch: int):
    from speedplusbaseline_tpu_torch.engine.loops import train_epoch

    # The loop's progress bar goes to stderr, so that the result line stands alone.
    with contextlib.redirect_stdout(sys.stderr):
        records = train_epoch(epoch, cfg, state, stepper, source, None, styled=False)
    sys.stderr.write("\n")
    return records


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors.values()])


def warm_up(config: dict, cfg, state, step, weights, batches, gate: Gate, device):
    """Run the first WARMUP steps through ``train_epoch``; return the
    source, the stepper and the program's readings of the first COMPARED
    steps: each step's loss, each leaf's gradient at step 1 as AdamW holds
    it (its first moment over 1 - beta1) and each leaf's change over the
    steps, taken before step COMPARED + 1 runs."""
    names = [n for n, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    got: Dict[str, torch.Tensor] = {}

    def after_first(st):
        # A leaf the optimizer holds no moment for has had no gradient.
        m = {n: st.optimizer.state.get(params[n], {}).get("exp_avg", torch.zeros(()))
             for n in names}
        got["grad"] = torch.stack([t.float().norm().to(device) for t in m.values()]) / (
            1.0 - cfg.momentum)

    def after_compared(st):
        got["change"] = _leaf_norms({n: params[n].detach() - weights[n] for n in names})

    source = Source(batches)
    stepper = Stepper(step, gate, {1: after_first, COMPARED: after_compared})
    source.open(limit=WARMUP)
    records = _epoch(cfg, state, stepper, source, 1)
    _sync(device)
    ref = ref_train.model(config)
    prog = {"loss": [ref.total(r) for r in records[:COMPARED]],
            "grad_norm": dict(zip(names, got["grad"].tolist())),
            "change_norm": dict(zip(names, got["change"].tolist()))}
    return source, stepper, prog


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers ``correct`` holds to its limits. ``loss1_gap``: the
    relative gap of the first step's loss (the later steps' losses follow
    AdamW's first, sign-like step, which turns round-off into gaps of a few
    percent in sound runs; they are read, not held). ``grad_gap``: the
    largest gap of a leaf's gradient norm at step 1; ``grad_gap_median``:
    the median leaf's. ``change_gap``: the largest gap of a leaf's change
    norm over the compared steps. A leaf's gap is over its reference norm
    or the median leaf's, whichever is larger. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change."""
    g = ref["grad_norm"]
    med = float(np.median(list(g.values())))
    grads = [abs(prog["grad_norm"][n] - g[n]) / max(g[n], med) for n in g]
    kept = [n for n in g if g[n] >= 1e-3 * med]
    c = ref["change_norm"]
    medc = float(np.median([c[n] for n in kept]))
    change = max(abs(prog["change_norm"][n] - c[n]) / max(c[n], medc) for n in kept)
    return {"loss1_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "grad_gap": max(grads), "grad_gap_median": float(np.median(grads)),
            "change_gap": change}


def loss_gaps(prog: dict, ref: dict) -> List[float]:
    """Each compared step's relative loss gap, for the record."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]


def reference_readings(config, weights, batches, gate: Gate, seed: int, device,
                       precision: str = "f32") -> dict:
    gen = (ref_ghiasi.load_params(os.path.join(ASSETS, config["generator"]), device)
           if any(gate[i] for i in range(COMPARED)) else None)
    stats = ref_ghiasi.load_style_stats(ASSETS, device)
    return ref_train.run(config, weights, batches[:COMPARED], [gate[i] for i in range(COMPARED)],
                         seed, gen, stats, precision, COMPARED)


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float) -> Outcome:
    """One run of ``cell``; ``t0`` is the host clock when the process began
    its set-up."""
    config, traffic = cell.config, cell.traffic
    phases: Dict[str, float] = {"import": time.perf_counter() - t0}
    seeds = Seeds.of(seed)
    cfg, state, step, weights, batches = build(config, traffic, seeds, device, phases)
    gate = Gate(traffic["texture_ratio"], seeds.gate)

    t = time.perf_counter()
    source, stepper, prog = warm_up(config, cfg, state, step, weights, batches, gate, device)
    phases["warm_up"] = time.perf_counter() - t

    tracer = tr.Tracer() if traced else None
    captured: Dict[str, object] = {}
    if traced:
        def start():
            _sync(device)
            tracer.start()

        def stop():
            _sync(device)
            captured["trace"] = tracer.stop()

        source.on_request = {STRETCH_AT: start, STRETCH_AT + STRETCH_STEPS: stop}
    first_window_step = stepper.i
    _sync(device)
    t_open = time.perf_counter()
    phases["total"] = t_open - t0
    source.open(deadline=t_open + seconds)
    records = _epoch(cfg, state, stepper, source, 2)
    _sync(device)
    t_close = time.perf_counter()
    if traced and "trace" not in captured:
        raise RuntimeError(f"the window ran {len(records)} steps, fewer than the traced "
                           f"stretch's {STRETCH_AT + STRETCH_STEPS}")

    n = len(records)
    stamps = source.stamps  # n + 1 requests, the last refused
    reads = [stamps[k + 2] for k in range(n - 1)] + [t_close]
    step_ms = [1e3 * (b - a) for a, b in zip([t_open] + reads[:-1], reads)]
    failed = sum(1 for r in records
                 if not all(math.isfinite(v) for k, v in r.items() if k.startswith("loss")))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    trace_info = None
    if traced:
        styled = [gate[first_window_step + STRETCH_AT + i] for i in range(STRETCH_STEPS)]
        skip = set(range(STRETCH_AT, STRETCH_AT + STRETCH_STEPS + 1))
        trace_info = {"trace": captured["trace"], "styled": styled,
                      "dispatch_ms": [r["ms"] for i, r in enumerate(records) if i not in skip]}

    del state, step, stepper, source, records, captured
    gc.collect()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(config, weights, batches, gate, cfg.seed, device)
    numbers = compare(prog, ref)
    # The cell's limits name the numbers it holds; the others are read only.
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    e2e = {"train_img_s": n * traffic["batch"] / (t_close - t_open),
           "train_step_ms_p95": float(np.percentile(step_ms, 95)),
           "setup_s": phases["total"]}
    return Outcome(phases, t_close - t_open, n, n * traffic["batch"], step_ms, failed, peak,
                   checks, e2e, trace_info,
                   {"numbers": numbers, "loss_gap_steps": loss_gaps(prog, ref)})
