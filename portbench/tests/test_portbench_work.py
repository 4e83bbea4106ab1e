"""The work counters against torch's own count of the same shapes
(``torch.utils.flop_counter``, on meta tensors at the configurations' full
sizes) and against the figures they were checked by."""
from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import spec, work
from portbench.runners.train_resident import make_weights
from portbench.reference import ghiasi, spn
from portbench.reference.common import TRUNC2_STD, Precision

META = torch.device("meta")


def _config(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _meta_params(mod, config):
    return {n: torch.empty(s, device=META) for n, s, _ in mod.param_spec(config)}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("side", [227, 228])
def test_forward_flops_match_torchs_count(side):
    config = _config("spn")
    params = _meta_params(spn, dict(config, input_side=side))
    x = torch.empty((2, 3, side, side), device=META)
    counted = _count(lambda: spn.forward(params, x, Precision(), torch.Generator()))
    assert counted == 2 * work.forward_flops(config, side)


def _ghiasi_params():
    shapes = {}
    for i, (cin, cout, k) in enumerate(((3, 32, 9), (32, 64, 3), (64, 128, 3))):
        shapes[f"layer{i}.conv"] = (cout, cin, k, k)
    for i in range(3, 8):
        shapes[f"layer{i}.conv1"] = shapes[f"layer{i}.conv2"] = (128, 128, 3, 3)
        for j in ("1", "2"):
            shapes[f"layer{i}.fc_gamma{j}"] = shapes[f"layer{i}.fc_beta{j}"] = (128, 100)
    for i, (cin, cout, k) in zip((8, 9, 10), ((128, 64, 3), (64, 32, 3), (32, 3, 9))):
        shapes[f"layer{i}.conv"] = (cout, cin, k, k)
        shapes[f"layer{i}.fc_gamma"] = shapes[f"layer{i}.fc_beta"] = (cout, 100)
    out = {}
    for name, s in shapes.items():
        out[f"{name}.weight"] = torch.empty(s, device=META)
        out[f"{name}.bias"] = torch.empty(s[0], device=META)
    return out


@pytest.mark.parametrize("side", [224, 227])
def test_generator_flops_match_torchs_count(side):
    p = _ghiasi_params()
    x, style = torch.empty((2, 3, side, side), device=META), torch.empty((2, 100), device=META)
    assert _count(lambda: ghiasi.forward(p, x, style, Precision())) == \
        2 * work.ghiasi_forward_flops(side)


@pytest.mark.parametrize("batch,side", [(48, 224), (192, 224), (48, 227)])
def test_b1_flops_are_two_convs(batch, side):
    q = work.generator_sides(side)[2]
    x = torch.empty((batch, 128, q + 2, q + 2), device=META)
    w = torch.empty((128, 128, 3, 3), device=META)
    counted = _count(lambda: [torch.nn.functional.conv2d(x, w) for _ in range(2)])
    assert counted == work.b1_flops(batch, side)


def test_b1_and_b2_figures():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    flops = work.b1_flops(48, 224)
    assert flops == pytest.approx(88.8e9, rel=1e-3)
    assert work.least_seconds(flops, work.b1_bytes(48, 224, 2), peak) == pytest.approx(
        0.0898e-3, rel=1e-3)
    b2 = sum(work.b2_bytes(48, h, w, c, 2, f) for h, w, c, f in work.generator_norm_sites(224))
    assert work.least_seconds(0.0, b2, peak) == pytest.approx(0.308e-3, rel=2e-3)
    assert [s[:3] for s in work.generator_norm_sites(227)] == [
        (227, 227, 32), (114, 114, 64), (57, 57, 128), (114, 114, 64), (228, 228, 32),
        (228, 228, 3)]


def test_step_flops_count_the_restyle_on_restyled_steps():
    config = _config("spn")
    plain = work.step_flops(config, 48, False)
    styled = work.step_flops(config, 48, True)
    assert plain == 3 * work.forward_flops(config, 227) * 48
    assert styled == (3 * work.forward_flops(config, 228) + work.ghiasi_forward_flops(227)) * 48


def test_weights_follow_the_spec_and_the_seed():
    config = _config("spn")
    config.update(input_side=67, num_classes=50)
    s = spn.param_spec(config)
    a = make_weights(s, 2 ** 31 + 7, torch.device("cpu"))
    b = make_weights(s, 2 ** 31 + 7, torch.device("cpu"))
    c = make_weights(s, 2 ** 31 + 8, torch.device("cpu"))
    assert set(a) == {n for n, _, _ in s}
    # The CPU's vectorised erfinv may round a lane differently from run to
    # run; on the card each element is its own thread.
    assert all(torch.allclose(a[n], b[n], rtol=1e-6, atol=0) for n in a)
    w = a["fc7.weight"]
    assert not torch.allclose(w, c["fc7.weight"])
    std = (1 / 4096) ** 0.5
    assert w.abs().max() <= 2 * std / TRUNC2_STD + 1e-6
    assert abs(float(w.std()) - std) < 0.02 * std
    assert torch.equal(a["fc7.bias"], torch.zeros(4096))
