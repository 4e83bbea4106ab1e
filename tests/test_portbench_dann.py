"""The benchmark's DANN cell on the CPU: the plain float32 reference
(``portbench/reference/dann.py``) against the port's DANN step in float64,
its FLOP counter against torch's, the layer-by-layer check of
``portbench/runners/dann_layerwise.py`` at a size the CPU holds (sound
reads under the cell's limits; the bf16 control and each DANN fault above
one of them; the TF32 control acts only on the card), the program's two
DANN spans, and the readers of the cell's three new per-layer metrics."""
from __future__ import annotations

import json
import math
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults_dann, run, spec, work
from portbench import trace as tr
from portbench.reference import dann, photometric
from portbench.reference.common import Precision
from portbench.runners import dann_layerwise
from portbench.runners.train_resident import Context, make_weights
from portbench.work import dann as dann_work
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer, dann_step,
                                                make_dann_train_step, train_epoch)
from speedplusbaseline_tpu_torch.models import RevGrad

CELL = "dann-b192x2"
CPU = torch.device("cpu")
SIDE, BATCH, K = 64, 4, 11
ALPHA = 0.9866


def _config(**overrides):
    with open(os.path.join(spec.HERE, "configs", "dann.json")) as f:
        conf = json.load(f)
    conf.update(overrides)
    return conf


def _relgap(a, b, floor=1e-300):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(floor))


def _leaf_gaps(prog, ref):
    """Each leaf's gap over its own norm or the median leaf's, whichever is
    larger (KRN's BatchNorm shifts that a conv and a BatchNorm cancel have
    a true gradient of 0)."""
    floor = float(torch.stack([r.detach().double().norm() for r in ref.values()]).median())
    return {n: _relgap(prog[n], ref[n], floor) for n in ref}


def test_reference_matches_the_port_in_float64():
    """The three losses, every leaf's gradient after the clip, one RMSprop
    step and the running statistics after both streams' passes, at float64
    (random-init KRN is chaotic: float32 round-off grows through its
    depth). The port hands its head's output and the domain logits out in
    float32 and reverses the map's gradient in float32, so the losses and
    the gradients agree to float32's rounding."""
    conf = _config(input_side=SIDE)
    weights = {n: w.double() for n, w in
               make_weights(dann.param_spec(conf), 2 ** 31 + 7, CPU).items()}
    gen = torch.Generator().manual_seed(9)
    src = torch.rand((BATCH, SIDE, SIDE, 3), generator=gen, dtype=torch.float64)
    tgt = torch.rand((BATCH, SIDE, SIDE, 3), generator=gen, dtype=torch.float64)
    kp = torch.rand((BATCH, 2, K), generator=gen, dtype=torch.float64)
    # Rotations and flips only, which are exact: at float64 the chaotic
    # network would carry the float32 brightness and noise draws' rounding
    # (applied in other orders by the two) to the last BatchNorms; the
    # augmentations are held to the program's in test_portbench_krn.
    draws = [{**d, "bc_on": torch.zeros_like(d["bc_on"]),
              "noise_on": torch.zeros_like(d["noise_on"])}
             for d in (photometric.draw(torch.Generator().manual_seed(s), BATCH,
                                        (3, SIDE, SIDE), 0.5) for s in (1, 2))]
    assert all(bool(d["rot_on"].any() and d["flip_on"].any()) for d in draws)

    model = RevGrad(K, (SIDE, SIDE)).double()
    model.load_state_dict(weights, strict=True)
    cfg = SimpleNamespace(optimizer="rmsprop", lr=conf["lr"], weight_decay=conf["weight_decay"],
                          momentum=conf["momentum"])
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    terms = dann_step(state, src, kp, draws[0], tgt, draws[1], ALPHA, False)
    prog = dict(model.named_parameters())
    bufs = dict(model.named_buffers())

    names = [n for n, _s, _i in dann.param_spec(conf) if ".running_" not in n]
    p = {n: weights[n].clone().requires_grad_(True) for n in names}
    (xs, kp_r), (xt, _) = (photometric.apply(x.permute(0, 3, 1, 2), k, d) for x, k, d in
                           ((src, kp, draws[0]), (tgt, torch.zeros_like(kp), draws[1])))
    envs = [dann.forward(p, x, ALPHA) for x in (xs, xt)]
    loss, ref_terms = dann.loss(envs[0][dann.HEAD], envs[0][dann.LOGIT], envs[1][dann.LOGIT],
                                kp_r)
    for k in dann.TERMS:
        assert float(terms[k]) == pytest.approx(float(ref_terms[k].detach()), rel=1e-6), k
    grads = dict(zip(names, torch.autograd.grad(loss, [p[n] for n in names])))
    dann.clip(grads, conf["clip_norm"])
    assert max(_leaf_gaps({n: prog[n].grad for n in names}, grads).values()) < 1e-5
    stats = dann.running_stats(dann.network(ALPHA).units, envs, weights)
    for n, v in stats.items():
        # Some running means are 0 in exact arithmetic: absolute, at the
        # statistics' scale.
        assert torch.allclose(bufs[n], v, rtol=1e-10, atol=1e-12), n
    opt = dann.RMSprop({n: p[n] for n in names}, conf["lr"], conf["momentum"], conf["eps"],
                       conf["weight_decay"])
    stepped = {n: weights[n].clone() for n in names}
    opt.step(stepped, grads)
    # RMSprop's first step is about g / |g| sqrt(10): a leaf whose gradient
    # is near eps (1e-8) carries its gradient's own round-off into its update.
    assert max(_leaf_gaps({n: prog[n] - weights[n] for n in names},
                          {n: stepped[n] - weights[n] for n in names}).values()) < 1e-4


def test_the_reference_is_the_programs_model():
    """Every state-dict name and shape at the published widths, and the
    parameter count the configuration states."""
    conf = _config()
    with torch.device("meta"):
        model = RevGrad(conf["num_keypoints"], (224, 224))
    sd = model.state_dict()
    spec_ = dann.param_spec(conf)
    assert {n: tuple(s) for n, s, _ in spec_} == {n: tuple(t.shape) for n, t in sd.items()}
    assert sum(math.prod(s) for n, s, _ in spec_ if ".running_" not in n) == \
        conf["parameters"] == sum(q.numel() for q in model.parameters())
    assert len(dann.network(ALPHA).units) == 58
    assert dann.FEATURE == "net.base.block17.project.bn:out"


@pytest.mark.parametrize("side", [224, 64])
def test_dann_flops_match_torchs_count(side):
    """KRN's forward, its part after the backbone's map and the domain head,
    each counted by torch on one stream's forward (torch's count of a
    depthwise conv's backward ignores its groups, so the step's count is
    checked from the forward's parts)."""
    conf = _config(input_side=side)
    params = {n: torch.empty(s, device="meta") for n, s, _ in dann.param_spec(conf)}
    env = {dann.INPUT: torch.empty((2, 3, side, side), device="meta")}
    counted = {"backbone": 0, "tail": 0, "domain": 0}
    for layer in dann.network(ALPHA).layers:
        part = ("domain" if layer.out.startswith("domain_classifier") else
                "backbone" if layer.out.startswith("net.base.") else "tail")
        with FlopCounterMode(display=False) as counter:
            env[layer.out] = layer.fn(params, Precision(), *(env[s] for s in layer.ins))
        counted[part] += counter.get_total_flops()
    whole, tail, domain = dann_work.parts(conf, side)
    assert 2 * whole == counted["backbone"] + counted["tail"] == 2 * work.forward_flops(
        _config(input_side=side, reference="krn"), side)
    assert (2 * tail, 2 * domain) == (counted["tail"], counted["domain"])
    step = work.step_flops(conf, 2, False)
    assert step == pytest.approx(2 * 3 * (counted["backbone"] + counted["tail"]
                                          + counted["domain"]) - 2 * counted["tail"], rel=1e-12)
    if side == 224:
        assert step / 2 == pytest.approx(4.675e9, rel=2e-3)


def _tiny_cell():
    bench = spec.benchmark()
    traffic = {"runner": "dann_layerwise", "batch": BATCH, "distinct_batches": 8}
    return spec.Cell("tiny-dann", 1, _config(input_side=SIDE), traffic, spec.cell(CELL).limits,
                     bench["end_to_end"], bench["per_layer"])


def _run():
    return run.measure(_tiny_cell(), 2 ** 31 + 21, 0.3, False, CPU, time.perf_counter())


def test_a_sound_run_is_correct_layer_by_layer():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    steps = line["read_not_held"]["steps"]
    assert [s["step"] for s in steps] == list(dann_layerwise.COMPARED)
    assert all(s["alpha"] == pytest.approx(0.9866, abs=1e-4) for s in steps)
    assert set(line["checks"]) == {"input_gap", "layer_gap", "dgrad_gap", "grl_gap",
                                   "loss_gap", "stats_gap", "wgrad_gap", "update_gap"}


@pytest.mark.parametrize("fault", ["bf16", *faults_dann.FAULTS])
def test_a_broken_dann_step_is_not_correct(fault):
    plant = {**faults_dann.CONTROLS, **faults_dann.FAULTS}[fault]
    with plant():
        line = _run()
    assert not line["correct"], line["checks"]


def test_a_profiled_dann_step_holds_the_target_and_domain_spans():
    """``speedplus.target`` once a step, inside ``speedplus.forward``;
    ``speedplus.domain`` twice a step, both inside ``speedplus.forward``
    and the second inside ``speedplus.target``."""
    torch.manual_seed(0)
    cfg = default_cfg(model_name="krn", dann=True, input_shape=(32, 32), batch_size=2,
                      optimizer="rmsprop")
    state = TrainState.for_config(cfg, CPU)
    gen = torch.Generator().manual_seed(3)
    batches = [Loader([{"image": torch.randint(0, 256, (2, 32, 32, 3), generator=gen,
                                        dtype=torch.uint8),
                 "keypts": torch.rand((2, 2, K), generator=gen)} for _ in range(2)])
               for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_epoch(1, cfg, state, make_dann_train_step(cfg, CPU), None, None,
                    dann_loaders=batches, dann_alpha_fn=lambda i, n: 0.5)
    spans = {}
    for e in prof.events():
        if e.name.startswith("speedplus."):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))

    def inside(s, outer):
        return any(a <= s[0] and s[1] <= b for a, b in spans[outer])

    assert (len(spans["speedplus.target"]), len(spans["speedplus.domain"])) == (2, 4)
    assert all(inside(s, "speedplus.forward") for name in ("speedplus.target",
                                                           "speedplus.domain")
               for s in spans[name])
    assert sum(inside(s, "speedplus.target") for s in spans["speedplus.domain"]) == 2


class Loader(list):
    """Batches as ``train_epoch`` takes a loader."""

    def set_epoch(self, epoch):
        pass


def _trace_events():
    ev = []

    def host(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
                   "tid": 1})

    def kernel(name, ts, dur, corr, tid=1):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr, "stream": 7}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts - 5,
                   "dur": 1, "tid": tid, "args": {"correlation": corr}})

    host(tr.STEP_SPAN, 0, 300)
    host("speedplus.forward", 10, 150)
    host("speedplus.domain", 40, 20)
    kernel("sm90_xmma_fprop_implicit_gemm_f32f32", 50, 5, 1)
    host("speedplus.target", 80, 70)
    kernel("void at::native::batch_norm_collect_statistics_channels_last_kernel", 90, 6, 2)
    host("speedplus.domain", 120, 25)
    kernel("sm90_xmma_fprop_implicit_gemm_f32f32", 130, 4, 3)
    host("Optimizer.step#RMSprop.step", 200, 50)
    kernel("void at::native::multi_tensor_apply_kernel<rmsprop>", 210, 3, 4)
    kernel("void at::native::multi_tensor_apply_kernel<rmsprop>", 220, 2, 5)
    return ev


def _context(events):
    t = tr.Trace(events)
    steps = t.launched_in(t.spans(tr.STEP_SPAN))
    cell = spec.cell(CELL)
    return Context(cell.config, cell.traffic, t, steps, [False], [1.0], None,
                   tr.union_us(steps), 300.0, 1)


def test_the_new_readers_read_their_spans():
    ctx = _context(_trace_events())
    assert spec.reader("target_forward_ms")(ctx) == pytest.approx((6 + 4) * 1e-3)
    assert spec.reader("domain_head_ms")(ctx) == pytest.approx((5 + 4) * 1e-3)
    assert spec.reader("rmsprop_ms")(ctx) == pytest.approx((3 + 2) * 1e-3)
    bare = [e for e in _trace_events() if e["name"] not in (
        "speedplus.target", "speedplus.domain", "Optimizer.step#RMSprop.step")]
    for name in ("target_forward_ms", "domain_head_ms", "rmsprop_ms"):
        assert spec.reader(name)(_context(bare)) is None


@pytest.mark.parametrize("name", ["target_forward_ms", "domain_head_ms", "rmsprop_ms"])
def test_each_new_metric_is_declared_for_the_dann_cell(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "train_img_s"


def test_the_dann_cell_reports_the_shared_metrics():
    """The eleven readers that read the cell unedited list it; those of
    AdamW and of the restyle do not, nor ``batchnorm_ms``, whose names do
    not hold cuDNN's float32 NHWC BatchNorm kernels (``batchnorm_fwtr_*``,
    ``batchnorm_bwtr_*``), which the cell runs."""
    got = {m["name"] for m in spec.cell(CELL).per_layer}
    assert got == {"dispatch_ms", "step_busy_ms", "device_idle_pct", "mfu_pct", "forward_ms",
                   "backward_ms", "clip_ms", "readback_wait_ms", "loader_wait_ms",
                   "idle_in_step_ms", "augment_ms", "target_forward_ms", "domain_head_ms",
                   "rmsprop_ms"}
