"""The benchmark's KRN cell on the CPU: the plain float32 reference
(``portbench/reference/krn.py``, ``photometric.py``) against the port, its
FLOP counter against torch's, the layer-by-layer check of
``portbench/runners/train_layerwise.py`` at a size the CPU holds (sound
reads under the cell's limits; the float8 control and each KRN fault above
one of them), and the readers of the cell's two new per-layer metrics."""
from __future__ import annotations

import json
import math
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults_krn, run, spec, work
from portbench import trace as tr
from portbench.reference import krn, photometric
from portbench.reference import train as ref_train
from portbench.reference.common import Precision
from portbench.runners import train_layerwise
from portbench.runners.train_resident import Context, make_weights
from speedplusbaseline_tpu_torch.augment import photometric as program_photometric
from speedplusbaseline_tpu_torch.engine.optim import build_optimizer, clip_gradients
from speedplusbaseline_tpu_torch.models.krn import KeypointRegressionNet, krn_loss

CELL = "krn-b192-styled50"
CPU = torch.device("cpu")
SIDE, BATCH, K = 64, 4, 11


def _config(**overrides):
    with open(os.path.join(spec.HERE, "configs", "krn.json")) as f:
        conf = json.load(f)
    conf.update(overrides)
    return conf


def _relgap(a, b, floor=1e-300):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(floor))


def _leaf_gaps(prog, ref):
    """Each leaf's gap over its own norm or the median leaf's, whichever is
    larger: several BatchNorm shifts feed a conv and a BatchNorm that
    cancels them, so their true gradient is 0 and round-off alone moves it."""
    floor = float(torch.stack([r.detach().double().norm() for r in ref.values()]).median())
    return {n: _relgap(prog[n], ref[n], floor) for n in ref}


def test_reference_matches_the_port_in_float64():
    """Outputs, loss, every leaf's gradient after the clip, the BatchNorm
    running statistics and one fused AdamW step, at float64 (random-init
    KRN is chaotic: float32 round-off grows through its depth). The port
    hands its head's output out in float32, so the outputs, the loss and
    what the backward starts from agree to float32's rounding."""
    conf = _config(input_side=SIDE)
    weights = {n: w.double() for n, w in
               make_weights(krn.param_spec(conf), 2 ** 31 + 5, CPU).items()}
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((BATCH, 3, SIDE, SIDE), generator=gen, dtype=torch.float64)
    kp = torch.rand((BATCH, 2, K), generator=gen, dtype=torch.float64)

    model = KeypointRegressionNet(K, (SIDE, SIDE)).double()
    model.load_state_dict(weights, strict=True)
    model.train()
    xc, yc = model(x)
    loss, _ = krn_loss(xc, yc, kp)
    loss.backward()
    clip_gradients("krn", model.parameters())
    cfg = SimpleNamespace(optimizer="adamw", lr=conf["lr"], weight_decay=conf["weight_decay"],
                          momentum=conf["momentum"])
    build_optimizer(cfg, model.parameters()).step()
    prog = dict(model.named_parameters())
    bufs = dict(model.named_buffers())

    names = ref_train.trainable(conf)
    p = {n: weights[n].clone().requires_grad_(True) for n in names}
    env = {krn.INPUT: x}
    for layer in krn.network().layers:
        env[layer.out] = layer.fn(p, Precision(), *(env[s] for s in layer.ins))
    xr, yr = krn.outputs(env[krn.OUTPUT])
    assert _relgap(xc, xr) < 1e-7 and _relgap(yc, yr) < 1e-7
    assert torch.equal(torch.stack(krn.forward(p, x, Precision())), torch.stack((xr, yr)))
    loss_r, _ = krn.loss((xr, yr), {"keypts": kp})
    assert float(loss.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-7)
    grads = dict(zip(names, torch.autograd.grad(loss_r, [p[n] for n in names])))
    krn.clip(grads, conf["clip_norm"])
    assert max(_leaf_gaps({n: prog[n].grad for n in names}, grads).values()) < 1e-6
    for u in krn.network().units:
        mean, var = krn.running_stats(env[f"{u.name}.conv:out"],
                                      weights[f"{u.name}.bn.running_mean"],
                                      weights[f"{u.name}.bn.running_var"])
        # Some running means are 0 in exact arithmetic (a 1x1 conv of a
        # BatchNorm's zero-mean output): absolute, at the statistics' scale.
        assert torch.allclose(bufs[f"{u.name}.bn.running_mean"], mean, rtol=1e-10, atol=1e-12)
        assert torch.allclose(bufs[f"{u.name}.bn.running_var"], var, rtol=1e-10, atol=1e-12)
    opt = ref_train.AdamW({n: p[n] for n in names}, conf["lr"], conf["weight_decay"],
                          (conf["momentum"], conf["beta2"]))
    stepped = {n: weights[n].clone() for n in names}
    opt.step(stepped, grads)
    # AdamW's first step is g / (|g| + eps): a leaf whose gradient is near
    # eps (1e-8) carries its gradient's own round-off into its update.
    assert max(_leaf_gaps({n: prog[n] - weights[n] for n in names},
                          {n: stepped[n] - weights[n] for n in names}).values()) < 1e-4


def test_the_reference_is_the_programs_model():
    """Every state-dict name and shape at the published widths, and the
    parameter count the configuration states."""
    conf = _config()
    with torch.device("meta"):
        model = KeypointRegressionNet(conf["num_keypoints"], (224, 224))
    sd = model.state_dict()
    spec_ = krn.param_spec(conf)
    assert {n: tuple(s) for n, s, _ in spec_} == {n: tuple(t.shape) for n, t in sd.items()}
    assert sum(math.prod(s) for n, s, _ in spec_ if n in ref_train.trainable(conf)) == \
        conf["parameters"] == sum(q.numel() for q in model.parameters())
    assert len(krn.network().units) == 58


def test_photometric_draws_and_applies_as_the_program():
    shape = (3, 16, 16)
    d_ref = photometric.draw(torch.Generator().manual_seed(11), 64, shape,
                             _config()["augment_p"])
    d_prog = program_photometric.draw_augment(torch.Generator().manual_seed(11), 64, shape)
    assert set(d_ref) == set(d_prog)
    for k in d_ref:
        assert torch.equal(d_ref[k], d_prog[k]), k
    gen = torch.Generator().manual_seed(3)
    images = torch.rand((64, *shape), generator=gen)
    kp = torch.rand((64, 2, K), generator=gen)
    img_r, kp_r = photometric.apply(images, kp, d_ref)
    img_p, kp_p = program_photometric.apply_augment(images, kp, d_prog)
    assert torch.allclose(img_r, img_p, rtol=0, atol=1e-6)
    assert torch.allclose(kp_r, kp_p, rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["rot1", "rot2", "rot3", "flip_h", "flip_v"])
def test_keypoints_follow_the_image(case):
    """A lit pixel at a keypoint lands where both remaps put the keypoint."""
    n, r, c = 8, 1, 5
    img = torch.zeros((1, 3, n, n))
    img[0, :, r, c] = 1.0
    kp = torch.tensor([[[(c + 0.5) / n], [(r + 0.5) / n]]])
    off, on = torch.zeros(1, dtype=torch.bool), torch.ones(1, dtype=torch.bool)
    d = {"rot_on": on if case.startswith("rot") else off,
         "rot_k": torch.tensor([int(case[-1]) if case.startswith("rot") else 1]),
         "flip_on": on if case.startswith("flip") else off,
         "flip_h": on if case == "flip_h" else off,
         "bc_on": off, "bc_a": torch.ones(1), "bc_b": torch.zeros(1), "noise_on": off,
         "noise": torch.zeros((1, 3, n, n))}
    for apply in (photometric.apply, program_photometric.apply_augment):
        out, moved = apply(img, kp, d)
        rr, cc = divmod(int(out[0, 0].argmax()), n)
        assert moved[0, :, 0].tolist() == pytest.approx([(cc + 0.5) / n, (rr + 0.5) / n])


@pytest.mark.parametrize("side", [224, 64])
def test_krn_flops_match_torchs_count(side):
    conf = _config(input_side=side)
    params = {n: torch.empty(s, device="meta") for n, s, _ in krn.param_spec(conf)}
    x = torch.empty((2, 3, side, side), device="meta")
    with FlopCounterMode(display=False) as counter:
        krn.forward(params, x, Precision())
    assert counter.get_total_flops() == 2 * work.forward_flops(conf, side)
    if side == 224:
        assert 3 * work.forward_flops(conf, side) == pytest.approx(2.49e9, rel=2e-3)


def _tiny_cell():
    bench = spec.benchmark()
    traffic = {"runner": "train_layerwise", "batch": BATCH, "texture_ratio": 0.5,
               "distinct_batches": 8}
    return spec.Cell("tiny-krn", 1, _config(input_side=SIDE), traffic, spec.cell(CELL).limits,
                     bench["end_to_end"], bench["per_layer"])


def _run():
    return run.measure(_tiny_cell(), 2 ** 31 + 21, 0.3, False, CPU, time.perf_counter())


def test_a_sound_run_is_correct_layer_by_layer():
    line = _run()
    assert line["correct"], line["checks"]
    assert [s["step"] for s in line["read_not_held"]["steps"]] == list(train_layerwise.COMPARED)


def test_the_fp8_control_is_not_correct_layer_by_layer(monkeypatch):
    """The reference in float8 in the program's place, layer by layer; the
    loss and the optimizer, which it does not stand in for, stay the
    program's."""
    warm_up = train_layerwise.warm_up

    def control(*args, **kwargs):
        source, stepper, readings = warm_up(*args, control=True)
        for r in readings:
            r["program"] = {**r["program"], **r["control_fp8"]}
        return source, stepper, readings

    monkeypatch.setattr(train_layerwise, "warm_up", control)
    line = _run()
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", list(faults_krn.ALL))
def test_a_broken_krn_step_is_not_correct(fault):
    with faults_krn.ALL[fault]():
        line = _run()
    assert not line["correct"], line["checks"]


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

    host(tr.STEP_SPAN, 0, 200)
    host("speedplus.augment", 5, 10)
    kernel("void at::native::vectorized_elementwise_kernel<4>(int)", 20, 4, 1)
    host(tr.RESTYLE_SPAN, 30, 30)
    kernel("void batch_norm_collect_statistics_kernel<float>(float*)", 40, 7, 2)  # restyle's
    host("speedplus.forward", 60, 40)
    kernel("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(float*)", 70, 6, 3)
    kernel("void at::native::batch_norm_transform_input_channels_last_kernel(float*)",
           80, 2, 4)
    kernel("sm90_xmma_fprop_implicit_gemm_bf16", 90, 9, 5)
    kernel("void at::native::batch_norm_backward_reduce_channels_last_kernel(float*)",
           120, 3, 6, tid=2)  # from autograd's thread
    return ev


def _context(events):
    t = tr.Trace(events)
    steps = t.launched_in(t.spans(tr.STEP_SPAN))
    cell = spec.cell(CELL)
    return Context(cell.config, cell.traffic, t, steps, [True], [1.0], None,
                   tr.union_us(steps), 200.0, 1)


def test_the_new_readers_read_their_kernels():
    ctx = _context(_trace_events())
    assert spec.reader("augment_ms")(ctx) == pytest.approx(4e-3)
    assert spec.reader("batchnorm_ms")(ctx) == pytest.approx((6 + 2 + 3) * 1e-3)
    plain = [e for e in _trace_events() if "norm" not in e["name"] and "bn_" not in e["name"]]
    assert spec.reader("batchnorm_ms")(_context(plain)) is None


@pytest.mark.parametrize("name", ["augment_ms", "batchnorm_ms"])
def test_each_new_metric_is_declared_for_the_krn_cell(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    assert entry["workloads"][0] == CELL and entry["moves"] == "train_img_s"
