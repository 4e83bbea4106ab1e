"""The harness on the CPU at tiny sizes: a run without a card gives no
result, the result line stands alone, the gate holds its share, step times
partition the window, the traced path reads what the CPU has, and neither
the harness nor the reference loads what it must not."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run, spec
from portbench.runners import train_resident as d
from portbench.tests import tiny


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "spn-b48-styled50", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA device" in out.err


def test_a_run_with_too_few_cards_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.card(spec.cell("spn-b48-styled50")) is None


def _cli(monkeypatch, capsys, cell, trace="0", seconds="1.5"):
    monkeypatch.setattr(run, "card", lambda c: torch.device("cpu"))
    monkeypatch.setattr(spec, "cell", lambda name: cell)
    rc = run.main(["--workload", cell.name, "--seed", str(2 ** 31 + 11), "--seconds", seconds,
                   "--trace", trace])
    return rc, capsys.readouterr()


def test_the_result_line_stands_alone_after_the_progress_bar(monkeypatch, capsys):
    rc, out = _cli(monkeypatch, capsys, tiny.cell())
    assert rc == 0
    lines = out.out.splitlines()
    assert len(lines) == 1 and "\r" not in out.out
    line = json.loads(lines[0])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert set(line["metrics"]) == {"train_img_s", "train_step_ms_p95", "setup_s"}
    assert "\rTraining" in out.err
    tail = out.err.rstrip("\n").splitlines()[-4:]
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in line["checks"]]


def test_a_traced_run_reads_what_the_cpu_has(monkeypatch, capsys):
    monkeypatch.setattr(d, "STRETCH_AT", 1)
    monkeypatch.setattr(d, "STRETCH_STEPS", 4)
    rc, out = _cli(monkeypatch, capsys, tiny.cell(), trace="1", seconds="8")
    assert rc == 0
    line = json.loads(out.out.splitlines()[-1])
    # No device ran, so no device metric is read, never a 0 in its place.
    assert set(line["metrics"]) == {"dispatch_ms"}
    assert line["device"]["busy_s"] == 0 and line["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("ratio,k", [(0.5, 2), (0.0, 0), (0.25, 1), (1.0, 4)])
def test_the_gate_holds_its_share_in_every_block(ratio, k):
    gate = d.Gate(ratio, 2 ** 31 + 3)
    plan = [gate[i] for i in range(400)]
    assert all(sum(plan[i:i + 4]) == k for i in range(0, 400, 4))
    again = d.Gate(ratio, 2 ** 31 + 3)
    assert [again[i] for i in range(400)] == plan
    if 0 < k < 4:
        assert [d.Gate(ratio, 5)[i] for i in range(400)] != plan


def test_the_gate_refuses_a_share_it_cannot_hold():
    with pytest.raises(ValueError):
        d.Gate(0.3, 1)


def test_step_times_partition_the_window():
    cell = tiny.cell("spn", ratio=0.0)
    out = d.run(cell, 4, 1.0, False, torch.device("cpu"), 0.0)
    assert len(out.step_ms) == out.steps and out.images == out.steps * cell.traffic["batch"]
    assert sum(out.step_ms) == pytest.approx(out.window_s * 1e3, rel=1e-9)
    assert out.end_to_end["train_img_s"] == pytest.approx(out.images / out.window_s)


def test_the_same_seed_makes_the_same_batches():
    cell = tiny.cell("spn")
    a = d.make_batches(cell.config, cell.traffic, 2 ** 31 + 9, torch.device("cpu"))
    b = d.make_batches(cell.config, cell.traffic, 2 ** 31 + 9, torch.device("cpu"))
    c = d.make_batches(cell.config, cell.traffic, 2 ** 31 + 10, torch.device("cpu"))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["image"], c[0]["image"])
    rows = torch.cat([x["image"].reshape(x["image"].shape[0], -1) for x in a])
    assert len({tuple(r[:64].tolist()) for r in rows}) == rows.shape[0]
    yc = a[0]["y_classes"]
    assert torch.equal((yc > 0).sum(1), torch.full((yc.shape[0],), 5))
    assert torch.allclose(a[0]["y_weights"].sum(1), torch.ones(yc.shape[0]))


@pytest.mark.parametrize("names,found", [
    (["speedplusbaseline_tpu_torch", "speedplusbaseline_tpu_torch.engine.loops"], []),
    (["jax.numpy", "os"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["speedplusbaseline_tpu.ops.pallas_resblock"], ["speedplusbaseline_tpu"]),
    (["jaxtyping", "flaxen"], []),
])
def test_forbidden_names_are_compared_whole(names, found):
    assert run.forbidden_loaded(names) == found


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    done = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=600, check=True)
    return done.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import time, torch\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "run.measure(tiny.cell(), 3, 0.5, False, torch.device('cpu'), time.perf_counter())\n"
            "print(run.forbidden_loaded())\n")
    assert _fresh(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.train, portbench.reference.spn, portbench.work.spn\n"
            "import portbench.reference.ghiasi, portbench.reference.augment, portbench.work\n"
            "bad = ('speedplusbaseline_tpu_torch', 'speedplusbaseline_tpu', 'jax', 'flax')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(bad)))\n")
    assert _fresh(code) == "[]"
