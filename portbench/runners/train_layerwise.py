"""Training on resident batches, held to the float32 reference layer by
layer.

Set-up, the window, its stamps and the end-to-end metrics are
``train_resident``'s, line for line: the program's state, step, gate and
source built by ``build``, ``engine.loops.train_epoch`` over the resident
batches, a step's time the interval between two successive readbacks. One
difference: the check below runs inside the warm-up, so ``setup_s`` leaves
out its seconds (the set-up phase ``reference_check``), as
``train_resident``'s, whose reference runs after the window, never counts
them.

What ``correct`` compares differs, for a network whose reference lists its
layers (``network()``) and whose error compounds
through its depth (KRN at flax's random init, where bf16's rounding grows
about 10% a BatchNorm). At the compared warm-up steps (``COMPARED``: the
first, restyled, and the third, plain and AdamW's third step) forward hooks
on the program's convs and BatchNorms, and a hook on each tensor they read
or write, keep what the step computed: each layer's input and output and
the gradient that reached each of those tensors. Nothing of the program is
patched. Before the next step the reference recomputes in float32 (TF32
off), from what the program produced:

* the stem's input, from the batch, by the reference's augmentations and
  restyle with the program's draws (the (seed, step) generator: the
  augmentation draws, then the style normals);
* each layer's output, from the program's inputs to that layer: convs,
  BatchNorms and the junctions between them (activations, residual sums,
  the router's reorder and concatenation);
* the gradient at each tensor, summed over its readers, each from the
  program's gradient at that reader's output, and the loss's gradient at
  the head's output;
* each leaf's gradient, from the program's input to its layer and the
  program's gradient at the layer's output, then the clip by global norm;
* the loss, from the program's head output and the reference's remapped
  keypoints;
* each leaf's update, by AdamW from the program's parameters, moments and
  clipped gradients before the step.

Every layer then shows one layer's rounding, and a fault shows where it is
made. The gaps are relative norms (``gaps``); ``limits/<cell>.json`` names
the ones held, the others are read only.
"""
from __future__ import annotations

import gc
import math
import os
import time
from collections import Counter
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from .. import trace as tr
from ..reference import augment as ref_augment
from ..reference import ghiasi as ref_ghiasi
from ..reference import photometric as ref_photometric
from ..reference import train as ref_train
from ..reference.common import Precision, f32_only
from .train_resident import (ASSETS, STRETCH_AT, STRETCH_STEPS, WARMUP, Gate, Outcome, Seeds,
                             Source, Stepper, _epoch, _sync, build, context)

# ``context`` is train_resident's: run.py reads it from the runner.
__all__ = ["run", "context", "warm_up", "COMPARED"]

#: The warm-up steps compared with the reference.
COMPARED = (0, 2)
F32 = Precision("f32")


class Capture:
    """The program's tensors at ``ports`` (``<module>:in`` or
    ``<module>:out``) during one step, and the gradient that reaches each:
    a forward hook on each module keeps the tensors, a hook on each tensor
    that takes a gradient keeps it. ``close()`` removes the module hooks."""

    def __init__(self, model: torch.nn.Module, ports):
        self.values: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        sides: Dict[str, List[str]] = {}
        for port in ports:
            module, side = port.rsplit(":", 1)
            sides.setdefault(module, []).append(side)
        self.handles = [model.get_submodule(m).register_forward_hook(partial(self._keep, m, s))
                        for m, s in sides.items()]

    def _keep(self, name, sides, module, args, output):
        for side in sides:
            port, t = f"{name}:{side}", (args[0] if side == "in" else output)
            self.values[port] = t.detach()
            if t.requires_grad:
                t.register_hook(partial(self._grad, port))

    def _grad(self, port, g):
        self.grads[port] = g

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def _sq(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[|prog - ref|^2, |ref|^2, numel] of one tensor, on its device."""
    prog, ref = prog.float(), ref.float()
    return torch.stack([(prog - ref).square().sum(), ref.square().sum(),
                        torch.tensor(float(ref.numel()), device=ref.device)])


def gaps(rows: List[torch.Tensor]) -> List[float]:
    """Each tensor's relative gap: |prog - ref| over |ref|, or over the
    median tensor's root mean square times the square root of its size
    where that is larger (so that a tensor near zero, which round-off
    alone moves, reads no larger gap than a typical one)."""
    if not rows:
        return []
    d2, r2, n = torch.stack(rows).double().T.tolist()
    floor = float(np.median([math.sqrt(r / k) for r, k in zip(r2, n)]))
    return [math.sqrt(d) / max(math.sqrt(r), floor * math.sqrt(k), 1e-30)
            for d, r, k in zip(d2, r2, n)]


def _worst(name: str, values: List[float]) -> Dict[str, float]:
    return {name: max(values), f"{name}_median": float(np.median(values))}


def reference_input(config: dict, batch: dict, styled: bool, seed: int, step: int,
                    generator_params, style_stats, prec: Precision):
    """The stem's input and the remapped keypoints of a step, from the batch
    and the step's draws: the augmentations, then (restyled) the style
    normals."""
    x = ref_augment.to_unit(batch["image"])
    gen = ref_augment.step_generator(x.device, seed, step)
    d = ref_photometric.draw(gen, x.shape[0], tuple(x.shape[1:]), config["augment_p"])
    x, kp = ref_photometric.apply(x, batch["keypts"].float(), d)
    if styled:
        z = ref_augment.style_normals(gen, x.shape[0])
        x = ref_ghiasi.restyle(generator_params, style_stats, config["texture_alpha"], x, z,
                               prec)
    return x, kp


def check_layers(ref, values, grads, weights, keypts, control: bool) -> dict:
    """Every layer of ``ref.network()`` recomputed alone from the program's
    inputs ``values`` and the program's gradients at its output ``grads``
    (both keyed by port; emptied as they are used), with the parameters
    ``weights`` the step read. Returns the squared-norm rows of the forward
    (``fwd``) and of the gradient at each tensor (``dgrad``), the float32
    gradient of each leaf (``wgrad``), and the loss; with ``control`` also
    the same of the reference computed in float8 (``Precision("fp8")``) in
    the program's place, under ``control_*``."""
    net = ref.network()
    precs = {"ref": F32, **({"control": Precision("fp8")} if control else {})}
    p = {n: w.detach().float().requires_grad_(True) for n, w in weights.items()}
    readers = Counter(s for layer in net.layers for s in layer.ins)
    readers[ref.OUTPUT] += 1  # the loss
    leaves: Dict[str, torch.Tensor] = {}
    acc: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in precs}
    wgrad: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in precs}
    rows: Dict[str, List[torch.Tensor]] = {"fwd": [], "dgrad": [], "control_fwd": [],
                                           "control_dgrad": []}

    def leaf(port):
        if port not in leaves:
            leaves[port] = values[port].float().requires_grad_(port in grads)
        return leaves[port]

    def add(into, key, g):
        into[key] = g if key not in into else into[key] + g

    def read(port):
        readers[port] -= 1
        if readers[port]:
            return
        g = grads.pop(port, None)
        if g is not None and port in acc["ref"]:
            r = acc["ref"].pop(port)
            rows["dgrad"].append(_sq(g, r))
            if control:
                rows["control_dgrad"].append(_sq(acc["control"].pop(port), r))
        leaves.pop(port, None)
        values.pop(port, None)

    for layer in net.layers:
        ins = [leaf(s) for s in layer.ins]
        wrt = [x for x in ins if x.requires_grad] + [p[n] for n in layer.params]
        g_out = grads.get(layer.out)
        outs = {}
        for key, prec in precs.items():
            out = layer.fn(p, prec, *ins)
            if g_out is not None and wrt:
                got = torch.autograd.grad(out, wrt, g_out.float())
                for s, g in zip([s for s, x in zip(layer.ins, ins) if x.requires_grad], got):
                    add(acc[key], s, g)
                for n, g in zip(layer.params, got[len(got) - len(layer.params):]):
                    add(wgrad[key], n, g)
            outs[key] = out.detach()
        rows["fwd"].append(_sq(values[layer.out], outs["ref"]))
        if control:
            rows["control_fwd"].append(_sq(outs["control"], outs["ref"]))
        del outs, ins, wrt
        for s in layer.ins:
            read(s)

    head = leaf(ref.OUTPUT)
    loss, _terms = ref.loss(ref.outputs(head), {"keypts": keypts})
    (g_head,) = torch.autograd.grad(loss, [head])
    for key in precs:
        add(acc[key], ref.OUTPUT, g_head)
    read(ref.OUTPUT)
    return {"rows": rows, "wgrad": wgrad, "loss": float(loss.detach())}


def check_step(config: dict, cap: Capture, batch: dict, styled: bool, seed: int, step: int,
               before: Dict[str, torch.Tensor], moments: dict, after: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], generator_params, style_stats,
               control: bool = False) -> dict:
    """The readings of one compared step (the module's docstring): the
    program's numbers under ``program``, the control's under
    ``control_fp8`` where ``control``; ``loss_ref`` for the loss gap, which
    the program's loss completes (``finish``)."""
    f32_only()
    ref = ref_train.model(config)
    x_ref, kp = reference_input(config, batch, styled, seed, step, generator_params,
                                style_stats, F32)
    out = {"program": {"input_gap": rel_gap(cap.values[ref.INPUT], x_ref)},
           "step": step, "styled": styled}
    if control:
        x_c, _ = reference_input(config, batch, styled, seed, step, generator_params,
                                 style_stats, Precision("fp8"))
        out["control_fp8"] = {"input_gap": rel_gap(x_c, x_ref)}
        del x_c
    del x_ref
    got = check_layers(ref, cap.values, cap.grads, before, kp, control)
    rows = got["rows"]
    out["program"].update(_worst("layer_gap", gaps(rows["fwd"])))
    out["program"].update(_worst("dgrad_gap", gaps(rows["dgrad"])))

    names = list(got["wgrad"]["ref"])
    clipped = {k: {n: g.clone() for n, g in w.items()} for k, w in got["wgrad"].items()}
    for w in clipped.values():
        ref.clip(w, config["clip_norm"])
    wref = clipped["ref"]
    out["program"].update(_worst("wgrad_gap", gaps([_sq(grads[n], wref[n]) for n in names])))
    if control:
        c = out["control_fp8"]
        c.update(_worst("layer_gap", gaps(rows["control_fwd"])))
        c.update(_worst("dgrad_gap", gaps(rows["control_dgrad"])))
        c.update(_worst("wgrad_gap", gaps([_sq(clipped["control"][n], wref[n])
                                             for n in names])))

    opt = ref_train.AdamW({n: before[n] for n in names}, config["lr"], config["weight_decay"],
                          (config["momentum"], config["beta2"]))
    for n in names:
        m, v, t = moments[n]
        opt.m[n].copy_(m)
        opt.v[n].copy_(v)
        opt.t = t
    stepped = {n: before[n].detach().float().clone() for n in names}
    opt.step(stepped, {n: grads[n].float() for n in names})
    out["program"].update(update_gap=max(gaps([_sq(after[n] - before[n], stepped[n] - before[n])
                                                for n in names])))
    out["loss_ref"] = got["loss"]
    return out


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|prog - ref| / |ref| of one tensor."""
    d2, r2, _n = _sq(prog, ref).tolist()
    return math.sqrt(d2 / max(r2, 1e-30))


def finish(reading: dict, loss_program: float) -> dict:
    """Complete a step's readings with the program's loss."""
    reading["program"]["loss_gap"] = abs(loss_program - reading["loss_ref"]) / abs(
        reading["loss_ref"])
    reading["loss_program"] = loss_program
    return reading


def worst(readings: List[dict], key: str = "program") -> Dict[str, float]:
    """Each number's largest reading over the compared steps."""
    rows = [r[key] for r in readings]
    return {k: max(r[k] for r in rows) for k in rows[0]}


def warm_up(config: dict, cfg, state, step, batches, gate: Gate, device,
            control: bool = False):
    """Run the first WARMUP steps through ``train_epoch``, checking the
    COMPARED ones layer by layer before the step after each; return the
    source, the stepper and each compared step's readings, with the host
    seconds its check took (``check_s``: keeping the program's tensors,
    loading the reference's generator and recomputing, between device
    syncs)."""
    ref = ref_train.model(config)
    net = ref.network()
    ports = [ref.INPUT] + [layer.out for layer in net.layers]
    params = dict(state.model.named_parameters())
    assets: Dict[str, object] = {}
    pending: Dict[str, object] = {}
    readings: List[dict] = []

    def attach(st):
        t = time.perf_counter()
        pending["before"] = {n: p.detach().clone() for n, p in params.items()}
        moments = {}
        for n, p in params.items():
            s = st.optimizer.state.get(p, {})
            if "exp_avg" in s:
                moments[n] = (s["exp_avg"].clone(), s["exp_avg_sq"].clone(), int(s["step"]))
            else:
                moments[n] = (torch.zeros_like(p), torch.zeros_like(p), 0)
        pending["moments"] = moments
        pending["step"] = st.step
        pending["capture"] = Capture(st.model, ports)
        pending["attach_s"] = time.perf_counter() - t

    def check(st):
        _sync(device)
        t = time.perf_counter()
        if not assets:  # the reference's restyle, loaded by the first check
            assets["generator"] = (
                ref_ghiasi.load_params(os.path.join(ASSETS, config["generator"]), device)
                if any(gate[i] for i in COMPARED) else None)
            assets["style_stats"] = ref_ghiasi.load_style_stats(ASSETS, device)
        cap = pending.pop("capture")
        cap.close()
        i = pending.pop("step")
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                 for n, p in params.items()}
        after = {n: p.detach() for n, p in params.items()}
        readings.append(check_step(config, cap, batches[i % len(batches)], gate[i], cfg.seed, i,
                                   pending.pop("before"), pending.pop("moments"), after, grads,
                                   assets["generator"], assets["style_stats"], control))
        del cap
        gc.collect()
        _sync(device)
        readings[-1]["check_s"] = pending.pop("attach_s") + time.perf_counter() - t

    hooks = {}
    for i in COMPARED:
        hooks[i], hooks[i + 1] = attach, check
    source = Source(batches)
    stepper = Stepper(step, gate, hooks)
    source.open(limit=WARMUP)
    records = _epoch(cfg, state, stepper, source, 1)
    _sync(device)
    for r in readings:
        finish(r, ref.total(records[r["step"]]))
    return source, stepper, readings


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float) -> Outcome:
    """One run of ``cell``; ``t0`` is the host clock when the process began
    its set-up."""
    config, traffic = cell.config, cell.traffic
    phases: Dict[str, float] = {"import": time.perf_counter() - t0}
    seeds = Seeds.of(seed)
    cfg, state, step, _weights, batches = build(config, traffic, seeds, device, phases)
    gate = Gate(traffic["texture_ratio"], seeds.gate)

    t = time.perf_counter()
    source, stepper, readings = warm_up(config, cfg, state, step, batches, gate, device)
    phases["warm_up"] = time.perf_counter() - t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

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
    # The reference's seconds are the yardstick's, not the program's set-up.
    phases["reference_check"] = sum(r["check_s"] for r in readings)
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

    numbers = worst(readings)
    # The cell's limits name the numbers it holds; the others are read only.
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    e2e = {"train_img_s": n * traffic["batch"] / (t_close - t_open),
           "train_step_ms_p95": float(np.percentile(step_ms, 95)),
           "setup_s": phases["total"] - phases["reference_check"]}
    return Outcome(phases, t_close - t_open, n, n * traffic["batch"], step_ms, failed, peak,
                   checks, e2e, trace_info,
                   {"numbers": numbers,
                    "steps": [{"step": r["step"], "styled": r["styled"],
                               "check_s": r["check_s"], **r["program"]} for r in readings]})
