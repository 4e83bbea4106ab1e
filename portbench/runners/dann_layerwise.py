"""DANN adaptation on resident batches, held to the float32 reference layer
by layer.

Set-up builds the program's state as its adapt CLI does (``RevGrad``
channels-last with weights the benchmark draws on the device from the
seed, RMSprop from ``build_optimizer``, float32 with TF32 off by
``config.full_f32``) and its step with ``make_dann_train_step``.
``engine.loops.train_epoch`` drives it with ``dann_loaders``, a source and
a target of ``distinct_batches`` batches each, held on the device in the
loader's format: the source's uint8 images and KRN's keypoints from the
data seed, the target's images from a seed of their own
(``train_resident.make_batches`` draws both). The gradient reversal's
alpha is the program's own ``adapt.grl_alpha`` at the configuration's
``alpha_epoch`` of ``max_epochs``. The traffic's ``batch`` is a stream's: a
step takes ``batch`` source and ``batch`` target images, and
``train_img_s`` counts both.

The window, its stamps and the end-to-end metrics are
``train_layerwise``'s: a step's time is the interval between two
successive readbacks, each step inside the harness's step span, and the
check runs inside the warm-up, so that ``setup_s`` leaves out its seconds
(the set-up phase ``reference_check``).

What ``correct`` compares. At the compared warm-up steps (``COMPARED``:
RMSprop's first and third) forward hooks on the program's convs,
BatchNorms and domain head, and a hook on each tensor they read or write,
keep both streams' passes (``StreamCapture``) and the gradient that reached
each tensor; a hook on the reversal's backward keeps the map's gradient as
it leaves the reversal. Nothing of the program is patched. Before the next
step the reference (``reference/dann.py``) recomputes in float32, from what
the program produced:

* each stream's stem input, from its batch, by the reference's
  augmentations with the program's draws (``input_gap``);
* each layer's output of each stream, from the program's inputs to it
  (``layer_gap``), the reversal and the domain head included;
* the gradient at each tensor of each stream, from the program's gradient
  at its readers' outputs, and the loss's gradients at the source's head
  and at both streams' logits (``dgrad_gap``); where one side has a
  gradient and the other none, the none reads as zeros;
* the map's gradient after the reversal, -alpha times the program's
  gradient at the reversal's output, alpha by the reference's own formula
  (``grl_gap``);
* the three losses, from the program's head output and logits
  (``loss_gap``, the largest of the three);
* every BatchNorm's running statistics after the source's and then the
  target's pass, from the program's statistics before the step and its
  BatchNorm inputs (``stats_gap``);
* each leaf's gradient, summed over the streams, then the clip by global
  norm (``wgrad_gap``);
* each leaf's update by RMSprop from the program's parameters, square
  averages and clipped gradients before the step (``update_gap``).

The gaps are ``train_layerwise.gaps``' relative norms, each the worse
step's; ``limits/<cell>.json`` names the ones held, the others are read
only.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from collections import Counter
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from .. import trace as tr
from ..reference import augment as ref_augment
from ..reference import dann as ref
from ..reference import photometric as ref_photometric
from ..reference.common import Precision
from .train_layerwise import Capture, _sq, _worst, gaps, rel_gap
from .train_resident import (STRETCH_AT, STRETCH_STEPS, WARMUP, Outcome, Seeds, Source, _sync,
                             context, make_batches, make_weights)

# ``context`` is train_resident's: run.py reads it from the runner.
__all__ = ["run", "context", "warm_up", "COMPARED"]

#: The warm-up steps compared with the reference.
COMPARED = (0, 2)
STREAMS = ("source", "target")
F32 = Precision("f32")


def target_seed(seed: int) -> int:
    """The seed of the target stream's images, apart from ``Seeds.of(seed)``."""
    s = np.random.SeedSequence(int(seed) & (2 ** 128 - 1), spawn_key=(1,))
    return int(s.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


class Stepper:
    """The program's DANN step as ``train_epoch`` calls it: runs
    ``hooks[i](state)`` before step i, each step inside a span of its own."""

    def __init__(self, step, hooks: Dict[int, object]):
        self.step, self.hooks, self.i = step, hooks, 0

    def __call__(self, state, source_batch, target_batch, alpha):
        i = self.i
        if i in self.hooks:
            self.hooks[i](state)
        self.i += 1
        with torch.profiler.record_function(tr.STEP_SPAN):
            return self.step(state, source_batch, target_batch, alpha)


class StreamCapture(Capture):
    """``Capture`` over a step's two passes of the model, the source's and
    then the target's: ``values[stream]`` and ``grads[stream]`` by port, and
    ``reversed[stream]``, the gradient the reversal hands the map."""

    def __init__(self, model: torch.nn.Module, ports):
        super().__init__(model, ports)
        self.stream = -1
        self.values = {s: {} for s in STREAMS}
        self.grads = {s: {} for s in STREAMS}
        self.reversed: Dict[str, torch.Tensor] = {}
        self.handles.append(model.register_forward_pre_hook(self._next))

    def _next(self, module, args):
        self.stream += 1

    def _keep(self, name, sides, module, args, output):
        s = STREAMS[self.stream]
        for side in sides:
            port, t = f"{name}:{side}", (args[0] if side == "in" else output)
            self.values[s][port] = t.detach()
            if t.requires_grad:
                t.register_hook(partial(self._grad, s, port))
            if port == ref.DOMAIN_IN and t.grad_fn is not None:
                t.grad_fn.register_hook(partial(self._reversed, s))

    def _grad(self, stream, port, g):
        self.grads[stream][port] = g

    def _reversed(self, stream, grad_inputs, grad_outputs):
        self.reversed[stream] = grad_inputs[0]


def program_cfg(config: dict, traffic: dict, seed: int):
    from speedplusbaseline_tpu_torch.config import default_cfg

    side = config["input_side"]
    return default_cfg(model_name=config["model_name"], dann=True, batch_size=traffic["batch"],
                       input_shape=(side, side), optimizer=config["optimizer"], lr=config["lr"],
                       weight_decay=config["weight_decay"], momentum=config["momentum"],
                       fp16=config["fp16"], seed=seed, num_keypoints=config["num_keypoints"],
                       max_epochs=config["max_epochs"])


def build(config: dict, traffic: dict, seeds: Seeds, target: int, device: torch.device,
          phases: dict):
    """The program's state, step and alpha, and the benchmark's weights and
    both streams' batches; ``phases`` gets each part's seconds."""
    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
    phases["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    from speedplusbaseline_tpu_torch import config as program_config
    from speedplusbaseline_tpu_torch.adapt import grl_alpha
    from speedplusbaseline_tpu_torch.engine.optim import build_optimizer
    from speedplusbaseline_tpu_torch.engine.state import TrainState
    from speedplusbaseline_tpu_torch.engine.steps import make_dann_train_step
    from speedplusbaseline_tpu_torch.models.build import get_model

    phases["program_import"] = time.perf_counter() - t
    program_config.full_f32()
    t = time.perf_counter()
    cfg = program_cfg(config, traffic, seeds.program)
    weights = make_weights(ref.param_spec(config), seeds.weights, device)
    _sync(device)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    source = make_batches(config, traffic, seeds.data, device)
    targets = [{"image": b["image"]} for b in make_batches(config, traffic, target, device)]
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
    step = make_dann_train_step(cfg, device)
    alpha = partial(grl_alpha, epoch=config["alpha_epoch"], max_epochs=config["max_epochs"])
    return cfg, state, step, alpha, source, targets


def _epoch(cfg, state, stepper, loaders, alpha, epoch: int):
    from speedplusbaseline_tpu_torch.engine.loops import train_epoch

    # The loop's progress bar goes to stderr, so that the result line stands alone.
    with contextlib.redirect_stdout(sys.stderr):
        records = train_epoch(epoch, cfg, state, stepper, None, None, dann_loaders=loaders,
                              dann_alpha_fn=alpha)
    sys.stderr.write("\n")
    return records


def reference_inputs(config: dict, source: dict, target: dict, seed: int, step: int):
    """Both streams' stem inputs and the source's remapped keypoints, from
    the batches and the step's draws."""
    out = []
    for batch, is_target in ((source, False), (target, True)):
        x = ref_augment.to_unit(batch["image"])
        gen = ref.stream_generator(x.device, seed, step, is_target)
        d = ref_photometric.draw(gen, x.shape[0], tuple(x.shape[1:]), config["augment_p"])
        kp = (torch.zeros((x.shape[0], 2, config["num_keypoints"]), device=x.device)
              if is_target else batch["keypts"].float())
        out.append(ref_photometric.apply(x, kp, d))
    (xs, kp), (xt, _) = out
    return xs, kp, xt


def _add(into: Dict[str, torch.Tensor], key: str, g: torch.Tensor) -> None:
    into[key] = g if key not in into else into[key] + g


def check_stream(net, values, grads, p, seeds, wgrad, rows) -> None:
    """One stream's layers recomputed alone from the program's inputs
    ``values`` and the program's gradients at their outputs ``grads`` (both
    by port; emptied as they are used), starting the gradients from the
    loss's at ``seeds``. Appends the squared-norm rows of each layer's
    output to ``rows["fwd"]`` and of the gradient at each tensor to
    ``rows["dgrad"]``, and adds each leaf's float32 gradient into ``wgrad``."""
    readers = Counter(s for layer in net.layers for s in layer.ins)
    acc = dict(seeds)
    leaves: Dict[str, torch.Tensor] = {}

    def leaf(port):
        if port not in leaves:
            leaves[port] = values[port].float().requires_grad_(port in grads)
        return leaves[port]

    def settle(port):
        g, r = grads.pop(port, None), acc.pop(port, None)
        if g is not None or r is not None:
            rows["dgrad"].append(_sq(torch.zeros_like(r) if g is None else g,
                                     torch.zeros_like(g, dtype=torch.float32)
                                     if r is None else r))
        leaves.pop(port, None)
        values.pop(port, None)

    for layer in net.layers:
        ins = [leaf(s) for s in layer.ins]
        wrt = [x for x in ins if x.requires_grad] + [p[n] for n in layer.params]
        out = layer.fn(p, F32, *ins)
        g_out = grads.get(layer.out)
        if g_out is not None and wrt:
            got = torch.autograd.grad(out, wrt, g_out.float())
            for s, g in zip([s for s, x in zip(layer.ins, ins) if x.requires_grad], got):
                _add(acc, s, g)
            for n, g in zip(layer.params, got[len(got) - len(layer.params):]):
                _add(wgrad, n, g)
        rows["fwd"].append(_sq(values[layer.out], out.detach()))
        del out, ins, wrt
        for s in layer.ins:
            readers[s] -= 1
            if not readers[s]:
                settle(s)
    for port in set(acc) | set(grads):  # the outputs no layer reads: the loss's
        settle(port)


def check_step(config: dict, cap: StreamCapture, source: dict, target: dict, seed: int,
               step: int, before: Dict[str, torch.Tensor], square_avg: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
               stats_after: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> dict:
    """The readings of one compared step (the module's docstring): the
    program's numbers under ``program``; ``loss_ref`` for the loss gap,
    which the program's losses complete (``finish``)."""
    alpha = ref.grl_alpha(ref.progress(step, WARMUP, config["alpha_epoch"],
                                       config["max_epochs"]))
    net = ref.network(alpha)
    nums: Dict[str, float] = {}
    with ref.float32():
        xs, kp, xt = reference_inputs(config, source, target, seed, step)
        nums["input_gap"] = max(rel_gap(cap.values["source"][ref.INPUT], xs),
                                rel_gap(cap.values["target"][ref.INPUT], xt))
        del xs, xt
        want = ref.running_stats(net.units, [cap.values[s] for s in STREAMS], stats)
        nums["stats_gap"] = max(gaps([_sq(stats_after[n], want[n]) for n in want]))
        nums["grl_gap"] = max(
            rel_gap(cap.reversed[s], -alpha * cap.grads[s][ref.DOMAIN_IN].float())
            if s in cap.reversed and ref.DOMAIN_IN in cap.grads[s] else 1.0
            for s in STREAMS)

        outs = {"head": cap.values["source"][ref.HEAD], "src": cap.values["source"][ref.LOGIT],
                "tgt": cap.values["target"][ref.LOGIT]}
        outs = {k: v.float().requires_grad_(True) for k, v in outs.items()}
        loss, terms = ref.loss(outs["head"], outs["src"], outs["tgt"], kp)
        g = dict(zip(outs, torch.autograd.grad(loss, list(outs.values()))))
        seeds = {"source": {ref.HEAD: g["head"], ref.LOGIT: g["src"]},
                 "target": {ref.LOGIT: g["tgt"]}}
        del outs, loss, g

        names = list(before)
        p = {n: before[n].detach().float().requires_grad_(True) for n in names}
        wgrad: Dict[str, torch.Tensor] = {}
        rows: Dict[str, List[torch.Tensor]] = {"fwd": [], "dgrad": []}
        for s in STREAMS:
            check_stream(net, cap.values[s], cap.grads[s], p, seeds[s], wgrad, rows)
        nums.update(_worst("layer_gap", gaps(rows["fwd"])))
        nums.update(_worst("dgrad_gap", gaps(rows["dgrad"])))
        ref.clip(wgrad, config["clip_norm"])
        nums.update(_worst("wgrad_gap", gaps([
            _sq(grads[n], wgrad.get(n, torch.zeros_like(grads[n], dtype=torch.float32)))
            for n in names])))
        del p, wgrad, rows

        opt = ref.RMSprop(before, config["lr"], config["momentum"], config["eps"],
                          config["weight_decay"])
        for n in names:
            opt.s[n].copy_(square_avg[n])
        stepped = {n: before[n].detach().float().clone() for n in names}
        opt.step(stepped, {n: grads[n].float() for n in names})
        nums["update_gap"] = max(gaps([_sq(after[n] - before[n], stepped[n] - before[n])
                                       for n in names]))
    return {"program": nums, "step": step, "alpha": alpha,
            "loss_ref": {k: float(v.detach()) for k, v in terms.items()}}


def finish(reading: dict, record: dict) -> dict:
    """Complete a step's readings with the program's losses."""
    ref_terms = reading["loss_ref"]
    reading["program"]["loss_gap"] = max(abs(record[k] - ref_terms[k]) / abs(ref_terms[k])
                                         for k in ref.TERMS)
    reading["loss_program"] = {k: record[k] for k in ref.TERMS}
    return reading


def worst(readings: List[dict]) -> Dict[str, float]:
    """Each number's largest reading over the compared steps."""
    rows = [r["program"] for r in readings]
    return {k: max(r[k] for r in rows) for k in rows[0]}


def warm_up(config: dict, cfg, state, step, alpha, source_batches, target_batches, device):
    """Run the first WARMUP steps through ``train_epoch``, checking the
    COMPARED ones layer by layer before the step after each; return the
    sources, the stepper and each compared step's readings, with the host
    seconds its check took (``check_s``)."""
    net = ref.network(1.0)
    ports = [ref.INPUT] + [layer.out for layer in net.layers]
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    pending: Dict[str, object] = {}
    readings: List[dict] = []

    def attach(st):
        t = time.perf_counter()
        pending["before"] = {n: q.detach().clone() for n, q in params.items()}
        pending["square_avg"] = {
            n: (st.optimizer.state[q]["square_avg"].clone() if "square_avg" in
                st.optimizer.state.get(q, {}) else torch.zeros_like(q))
            for n, q in params.items()}
        pending["stats"] = {n: b.detach().clone() for n, b in buffers.items()}
        pending["step"] = st.step
        pending["capture"] = StreamCapture(st.model, ports)
        pending["attach_s"] = time.perf_counter() - t

    def check(st):
        _sync(device)
        t = time.perf_counter()
        cap = pending.pop("capture")
        cap.close()
        i = pending.pop("step")
        grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q)).detach()
                 for n, q in params.items()}
        k = i % len(source_batches)
        readings.append(check_step(
            config, cap, source_batches[k], target_batches[k], cfg.seed, i,
            pending.pop("before"), pending.pop("square_avg"), pending.pop("stats"),
            {n: q.detach() for n, q in params.items()},
            {n: b.detach() for n, b in buffers.items()}, grads))
        del cap
        gc.collect()
        _sync(device)
        readings[-1]["check_s"] = pending.pop("attach_s") + time.perf_counter() - t

    hooks = {}
    for i in COMPARED:
        hooks[i], hooks[i + 1] = attach, check
    loaders = (Source(source_batches), Source(target_batches))
    stepper = Stepper(step, hooks)
    loaders[0].open(limit=WARMUP)
    loaders[1].open()
    records = _epoch(cfg, state, stepper, loaders, alpha, 1)
    _sync(device)
    for r in readings:
        finish(r, records[r["step"]])
    return loaders, stepper, readings


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float) -> Outcome:
    """One run of ``cell``; ``t0`` is the host clock when the process began
    its set-up."""
    config, traffic = cell.config, cell.traffic
    phases: Dict[str, float] = {"import": time.perf_counter() - t0}
    seeds = Seeds.of(seed)
    cfg, state, step, alpha, source_batches, target_batches = build(
        config, traffic, seeds, target_seed(seed), device, phases)

    t = time.perf_counter()
    loaders, stepper, readings = warm_up(config, cfg, state, step, alpha, source_batches,
                                         target_batches, device)
    phases["warm_up"] = time.perf_counter() - t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    source = loaders[0]
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
    _sync(device)
    t_open = time.perf_counter()
    phases["total"] = t_open - t0
    # The reference's seconds are the yardstick's, not the program's set-up.
    phases["reference_check"] = sum(r["check_s"] for r in readings)
    source.open(deadline=t_open + seconds)
    loaders[1].open()
    records = _epoch(cfg, state, stepper, loaders, alpha, 2)
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
        skip = set(range(STRETCH_AT, STRETCH_AT + STRETCH_STEPS + 1))
        trace_info = {"trace": captured["trace"], "styled": [False] * STRETCH_STEPS,
                      "dispatch_ms": [r["ms"] for i, r in enumerate(records) if i not in skip]}

    numbers = worst(readings)
    # The cell's limits name the numbers it holds; the others are read only.
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    images = n * 2 * traffic["batch"]
    e2e = {"train_img_s": images / (t_close - t_open),
           "train_step_ms_p95": float(np.percentile(step_ms, 95)),
           "setup_s": phases["total"] - phases["reference_check"]}
    return Outcome(phases, t_close - t_open, n, images, step_ms, failed, peak, checks, e2e,
                   trace_info,
                   {"numbers": numbers,
                    "steps": [{"step": r["step"], "alpha": r["alpha"], "check_s": r["check_s"],
                               **r["program"]} for r in readings]})
