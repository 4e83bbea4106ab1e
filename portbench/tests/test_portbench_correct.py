"""``correct`` against its control and the faults a training cell can have,
at a size a test run holds on the CPU, under the limits the cell holds on
the card: a sound run is correct; the reference computed in float8 in the
program's place is not; nor is a run with a fault of ``portbench.faults``
planted in its timed path (a step that leaves the state unchanged, half of
the batch left out of the loss, the restyle's answer altered where it is
made).

``test_control_and_faults_on_the_card`` reads them at the cell's own size
and skips where there is no card."""
from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import calibrate, faults, run, spec
from portbench.runners import train_resident as d
from portbench.tests import tiny

CELLS = {"spn-b48-styled50": 0.5}
CPU = torch.device("cpu")


def _cell(name):
    return tiny.cell("spn", ratio=CELLS[name], limits=spec.cell(name).limits)


def _run(cell):
    return run.measure(cell, 2 ** 31 + 21, 0.3, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = _run(_cell(name))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(monkeypatch, name):
    warm_up = d.warm_up

    def control(config, cfg, state, step, weights, batches, gate, device):
        source, stepper, _prog = warm_up(config, cfg, state, step, weights, batches, gate, device)
        return source, stepper, d.reference_readings(config, weights, batches, gate, cfg.seed,
                                                     device, "fp8")

    monkeypatch.setattr(d, "warm_up", control)
    line = _run(_cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n, r in CELLS.items()
                                        for f in faults.of({"texture_ratio": r})])
def test_a_broken_step_is_not_correct(name, fault):
    with faults.ALL[fault]():
        line = _run(_cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the readings at the cell's own size")
    cell = spec.cell(name)
    for seed in (1, 2, 3):
        row = calibrate.readings(cell, seed, torch.device("cuda", 0), True)
        assert all(row["program"][k] <= v for k, v in cell.limits.items()), json.dumps(row)
        for key in ("control_fp8", *faults.of(cell.traffic)):
            assert any(row[key][k] > v for k, v in cell.limits.items()), (key, json.dumps(row))
