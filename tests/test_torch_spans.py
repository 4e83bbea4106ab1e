"""The program's own profiler spans (``io_utils/spans.py``): under
``torch.profiler`` on the CPU, ``train_epoch`` over tiny styled KRN, styled
SPN and DANN steps, and ``run_validation`` over KRN's eval step, export every
span of their path, once per step (twice for the augmentation), nested as
the module says; the profiler changes no record, loss or weight; with no
profiler running no span enters ``record_function``; a profiler started or
stopped while a span is open raises nothing."""
from __future__ import annotations

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor, random_style_stats
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer,
                                                make_dann_train_step, make_krn_eval_step,
                                                make_train_step, run_validation, train_epoch)
from speedplusbaseline_tpu_torch.io_utils import load_tango_3d_keypoints, spans
from speedplusbaseline_tpu_torch.models import get_model

torch.set_num_threads(2)

CPU = torch.device("cpu")
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "speedplusbaseline_tpu_torch")
STEPS = 3
#: Spans recorded inside each ``speedplus.step`` (or ``speedplus.eval_step``).
IN_STEP = ("speedplus.augment", "speedplus.restyle", "speedplus.forward",
           "speedplus.target", "speedplus.domain", "speedplus.backward",
           "speedplus.all_reduce", "speedplus.clip", "speedplus.optimizer")
#: Spans the loop records outside its step.
IN_LOOP = ("speedplus.loader_wait", "speedplus.readback", "speedplus.progress")
#: Each path's spans and their count a step; a loop makes one more fetch
#: than it has steps, the one that finds the loader spent.
PER_STEP = {
    "krn": {"speedplus.step": 1, "speedplus.augment": 2, "speedplus.restyle": 1,
            "speedplus.forward": 1, "speedplus.backward": 1, "speedplus.all_reduce": 1,
            "speedplus.clip": 1, "speedplus.optimizer": 1, "speedplus.readback": 1,
            "speedplus.progress": 1, "speedplus.loader_wait": 1},
    "spn": {"speedplus.step": 1, "speedplus.restyle": 1, "speedplus.forward": 1,
            "speedplus.backward": 1, "speedplus.all_reduce": 1, "speedplus.clip": 1,
            "speedplus.optimizer": 1, "speedplus.readback": 1, "speedplus.progress": 1,
            "speedplus.loader_wait": 1},
    "dann": {"speedplus.step": 1, "speedplus.augment": 2, "speedplus.forward": 1,
             "speedplus.target": 1, "speedplus.domain": 2, "speedplus.backward": 1, "speedplus.all_reduce": 1, "speedplus.clip": 1,
             "speedplus.optimizer": 1, "speedplus.readback": 1, "speedplus.progress": 1,
             "speedplus.loader_wait": 1},
    "validation": {"speedplus.eval_step": 1, "speedplus.readback": 1,
                   "speedplus.progress": 1, "speedplus.loader_wait": 1},
}
PATHS = tuple(PER_STEP)


class Loader(list):
    """Batches as ``train_epoch`` and ``run_validation`` take a loader."""

    def set_epoch(self, epoch):
        pass


def _batches(model: str, side: int, n: int, seed: int = 0) -> Loader:
    rs = np.random.RandomState(seed)
    out = Loader()
    for _ in range(n):
        b = {"image": torch.from_numpy(rs.randint(0, 256, (2, side, side, 3), dtype=np.uint8))}
        if model == "spn":
            for k in ("y_classes", "y_weights"):
                v = rs.rand(2, 50).astype(np.float32)
                b[k] = torch.from_numpy(v / v.sum(1, keepdims=True))
        elif model == "eval":
            b.update(bbox=torch.tensor([[4.0, 28.0, 4.0, 28.0]] * 2),
                     q_gt=torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
                     t_gt=torch.tensor([[0.0, 0.0, 10.0]] * 2))
        else:
            b["keypts"] = torch.from_numpy(rs.rand(2, 2, 11).astype(np.float32))
        out.append(b)
    return out


def _run(path: str, logdir: str):
    """One epoch of ``path`` from a fixed start: its records and the final
    weights."""
    torch.manual_seed(0)
    if path == "validation":
        cfg = default_cfg(model_name="krn", input_shape=(32, 32), logdir=logdir)
        model = get_model(cfg)
        K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], dtype=np.float32)
        step = make_krn_eval_step(load_tango_3d_keypoints(), K, np.zeros(5, np.float32), CPU)
        meters = run_validation(1, cfg, step, model, _batches("eval", 32, STEPS), None)
        return [{k: m.avg for k, m in meters.items()}], model.state_dict()
    model_name, side = ("spn", 67) if path == "spn" else ("krn", 32)
    optimizer = {"krn": "adamw", "spn": "sgd", "dann": "rmsprop"}[path]
    cfg = default_cfg(model_name=model_name, input_shape=(side, side), num_classes=50,
                      batch_size=2, optimizer=optimizer, texture_ratio=1.0,
                      dann=path == "dann")
    state = TrainState(get_model(cfg), None)
    state.optimizer = build_optimizer(cfg, state.model.parameters())
    if path == "dann":
        step = make_dann_train_step(cfg, CPU)
        loaders = (_batches("krn", side, STEPS, 1), _batches("krn", side, STEPS, 2))
        records = train_epoch(1, cfg, state, step, None, None, dann_loaders=loaders,
                              dann_alpha_fn=lambda i, n: 0.5)
    else:
        aug = StyleAugmentor(0.5, random_style_stats(0), device=CPU)
        step = make_train_step(cfg, CPU, aug)
        records = train_epoch(1, cfg, state, step, _batches(model_name, side, STEPS), None,
                              styled=True)
    return records, state.model.state_dict()


def _profiled(path: str, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        records, weights = _run(path, str(tmp_path / "on"))
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    return records, weights, _spans(events)


def _spans(events):
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("speedplus.")]


def _inside(span, outer):
    return any(o[3] == span[3] and o[1] <= span[1] and span[2] <= o[2] for o in outer)


@pytest.mark.parametrize("path", PATHS)
def test_each_span_of_the_path_once_a_step_and_nested(path, tmp_path):
    _, _, got = _profiled(path, tmp_path)
    counts = {}
    for name, *_ in got:
        counts[name] = counts.get(name, 0) + 1
    want = {name: n * STEPS for name, n in PER_STEP[path].items()}
    want["speedplus.loader_wait"] += 1
    assert counts == want
    assert len({s[3] for s in got}) == 1  # all on the loop's thread
    outer = [s for s in got if s[0] in ("speedplus.step", "speedplus.eval_step")]
    for s in got:
        if s[0] in IN_STEP:
            assert _inside(s, outer), s
        elif s[0] in IN_LOOP:
            assert not _inside(s, outer), s
    # The forward ends before the backward begins; the clip and the
    # optimizer follow, in that order.
    order = [s[0] for s in sorted(got, key=lambda s: s[1])
             if s[0] in ("speedplus.forward", "speedplus.backward", "speedplus.clip",
                         "speedplus.optimizer")]
    if order:
        assert order == ["speedplus.forward", "speedplus.backward", "speedplus.clip",
                         "speedplus.optimizer"] * STEPS


@pytest.mark.parametrize("path", PATHS)
def test_the_profiler_changes_no_record_loss_or_weight(path, tmp_path):
    on, w_on, _ = _profiled(path, tmp_path)
    off, w_off = _run(path, str(tmp_path / "off"))
    assert [{k: v for k, v in r.items() if k != "ms"} for r in on] == [
        {k: v for k, v in r.items() if k != "ms"} for r in off]
    assert w_on.keys() == w_off.keys()
    for k in w_on:
        assert torch.equal(w_on[k], w_off[k]), k


@pytest.mark.parametrize("path", PATHS)
def test_no_span_enters_record_function_without_a_profiler(path, tmp_path, monkeypatch):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(name, args=None):
        if name.startswith("speedplus."):
            entered.append(name)
        return enter(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    _run(path, str(tmp_path / "off"))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _run(path, str(tmp_path / "on"))
    assert sorted(set(entered)) == sorted(PER_STEP[path])


def test_a_profiler_started_and_stopped_inside_an_open_span(tmp_path):
    """A span entered before the profiler starts is not recorded; one open
    when it stops raises nothing on exit and is exported up to the stop."""
    prof = profile(activities=[ProfilerActivity.CPU])
    with spans.span("speedplus.step"):
        prof.start()
        with spans.span("speedplus.forward"):
            torch.ones(4).sum()
        with spans.span("speedplus.loader_wait"):
            torch.ones(4).sum()
            prof.stop()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        names = sorted(s[0] for s in _spans(json.load(f)["traceEvents"]))
    assert names == ["speedplus.forward", "speedplus.loader_wait"]
    assert spans.span("speedplus.step") is spans.span("speedplus.forward")


def _names_in_the_port():
    """Every name the port's sources pass to ``span``."""
    names = set()
    for path in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_spans_lists_every_span_the_port_records():
    assert _names_in_the_port() == set(spans.SPANS)
    assert set().union(*PER_STEP.values()) == set(spans.SPANS)
