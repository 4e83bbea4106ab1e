"""The port's bench (``speedplusbaseline_tpu_torch/bench.py``) against the
root ``bench.py`` of the JAX package, on the CPU at small sizes.

* Keys: the line holds exactly the keys of the root bench.py's
  ``json.dumps({...})`` literals and of its host-loader dict (read with
  ``ast``; the root bench.py is never imported), plus the port's ``card``,
  ``lowering`` and four device-busy keys.
* Inputs: each measure's arrays equal the root bench.py's numpy draws at the
  same sizes, array for array and in its order of draws, and so does the
  KRN gate's sequence from ``RandomState(7)``.
* The DANN measure's step: its config's AdamW (lr 1e-3, weight decay 0.01)
  and alpha 0.5, one step against JAX's ``make_dann_train_step`` under the
  root bench.py's config (RevGrad at 64^2, batch 2), with
  tests/test_torch_dann.py's harness: JAX's own aug draws, a key whose draws
  are exact, and both sides pinned to float64 where the bench runs bf16 (at
  random init a bf16 or f32 rounding moves the KRN gradients by percents,
  which no tolerance separates from a fault). Tolerances are that harness's.
  The other measures' steps are held by existing parity tests of the same
  configuration: the styled KRN AdamW step by
  ``test_torch_train.py::test_styled_train_step_matches_jax``, the SPN
  AdamW steps by ``test_torch_spn.py::test_spn_train_steps_match_jax`` and
  ``test_spn_grads_match_jax``, the KRN eval step by
  ``test_torch_eval.py::test_eval_forward_matches_jax`` and
  ``test_pose_and_score_from_jax_keypoints``.
* Launch counts: the styled steps that the KRN and SPN measures run equal
  ``krn_styled_steps`` / ``spn_styled_steps``, from which the card's run is
  held at 5 B1 and 6 B2 launches a styled step (chip_smoke.py phase
  "bench"), with and without the profiled steps.
* Failures: without a GPU and without ``--no_cuda`` the bench raises; a
  child that exits nonzero, prints no JSON line or times out makes ``main``
  raise after one attempt, with the measures after it not run; a non-finite
  loss raises.
"""
import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
from speedplusbaseline_tpu.engine.steps import make_dann_train_step as jax_make_dann_train_step
from speedplusbaseline_tpu.models.revgrad import RevGrad as JaxRevGrad
from speedplusbaseline_tpu_torch import bench
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.engine import TrainState, build_optimizer, dann_step
from speedplusbaseline_tpu_torch.models import RevGrad
from speedplusbaseline_tpu_torch.perf import common
from test_torch_augment import jax_draws
from test_torch_dann import KEY, S, revgrad  # noqa: F401 -- revgrad is a fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# Each measure's sizes here; SPN's AlexNet trunk takes 67^2 at the least.
SMALL = {"krn": dict(batch=2, side=32, n=4), "eval": dict(batch=2, side=32, n=2),
         "dann": dict(batch=2, side=32, n=2), "spn": dict(batch=2, side=67, n=2)}
PORT_KEYS = {"card", "lowering", "krn_styled_device_busy_ms", "krn_plain_device_busy_ms",
             "spn_plain_device_busy_ms", "spn_styled_device_busy_ms"}


def root_bench_keys():
    """(the keys the root bench.py's line always holds, those it may hold):
    the keys of its ``json.dumps({...})`` literals and of the ``out = {...}``
    of ``_host_loader_rates``, and the keys it sets as ``out["k"] = ...``."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    always, maybe = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            always |= {k.value for k in node.args[0].keys}
    host = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "_host_loader_rates")
    for node in ast.walk(host):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "out" and isinstance(node.value,
                                                                              ast.Dict):
            always |= {k.value for k in node.value.keys}
        elif (isinstance(target, ast.Subscript) and getattr(target.value, "id", "") == "out"
              and isinstance(target.slice, ast.Constant)):
            maybe.add(target.slice.value)
    return always, maybe


@pytest.fixture(scope="module")
def cpu_run():
    """``bench.main(["--no_cuda"])`` with each measure run in this process at
    its SMALL sizes (in place of its child process) and the host rates on 16
    images, one pass each; the steps each measure took (styled or plain, or
    DANN's alpha) are recorded. Returns (the line, {measure: steps})."""
    steps = {}
    current = []

    def recording(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(state, *args):
                steps[current[0]].append(args[-1])
                return step(state, *args)

            return run
        return wrapped

    def in_process(name, flags):
        assert list(flags) == ["--no_cuda"]
        current[:] = [name]
        steps[name] = []
        return bench.MEASURES[name](CPU, **SMALL[name])

    host = bench.host_loader_rates
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "run_measure", in_process)
        mp.setattr(bench, "host_loader_rates", lambda: host(16, 1))
        mp.setattr(bench, "make_train_step", recording(bench.make_train_step))
        mp.setattr(bench, "make_dann_train_step", recording(bench.make_dann_train_step))
        line = bench.main(["--no_cuda"])
    return line, steps


def test_line_holds_the_root_bench_keys(cpu_run):
    line, _ = cpu_run
    always, maybe = root_bench_keys()
    assert {"metric", "eval_step_ms", "dann_step_ms", "spn_styled_step_ms",
            "host_cores"} <= always and maybe == {"host_native_lt_python"}
    native, python = line["host_native_img_s_per_worker"], line["host_python_img_s_per_worker"]
    want = always | PORT_KEYS | ({"host_native_lt_python"}
                                 if native is not None and native < python else set())
    assert set(line) == want
    assert line["metric"] == "krn_train_images_per_sec_per_chip" and line["unit"] == "img/s"
    assert line["card"] == "cpu" and line["lowering"] == "plain"
    assert line["baseline_is_estimate"] is True and line["baseline_img_per_sec"] == 450.0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 450.0)
    assert all(line[k] is None for k in PORT_KEYS if k.endswith("_device_busy_ms"))
    numbers = [k for k in want - PORT_KEYS - {"metric", "unit", "baseline_is_estimate",
                                              "host_rate_spread", "host_native_lt_python"}
               if line[k] is not None or k != "host_native_img_s_per_worker"]
    for k in numbers:
        assert isinstance(line[k], (int, float)) and math.isfinite(line[k]) and line[k] > 0, k
    B = SMALL["spn"]["batch"]
    assert line["spn_img_s_per_chip"] == pytest.approx(
        B * 1e3 / (0.5 * (line["spn_plain_step_ms"] + line["spn_styled_step_ms"])))
    assert line["dann_img_s_per_chip"] == pytest.approx(
        2 * SMALL["dann"]["batch"] * 1e3 / line["dann_step_ms"])
    for path, (lo, hi) in line["host_rate_spread"].items():
        assert 0 < lo <= line[f"host_{path}_img_s_per_worker"] <= hi


def bench_py_draws(measure, B, side):
    """The root bench.py's numpy draws for ``measure`` at batch ``B`` and
    ``side``, written out in its order."""
    f32 = np.float32
    if measure == "krn":  # bench.py:458-464
        rs = np.random.RandomState(0)
        return {"image": rs.rand(B, side, side, 3).astype(f32),
                "keypts": rs.rand(B, 2, 11).astype(f32)}
    if measure == "eval":  # bench.py:232-244
        rs = np.random.RandomState(7)
        pts = rs.uniform(-0.4, 0.4, size=(11, 3))
        return {"pts": pts, "image": rs.rand(B, side, side, 3).astype(f32),
                "bbox": np.tile([700.0, 1300, 400, 900], (B, 1)).astype(f32),
                "q_gt": np.tile([1.0, 0, 0, 0], (B, 1)).astype(f32),
                "t_gt": np.tile([0.0, 0, 8.0], (B, 1)).astype(f32)}
    if measure == "dann":  # bench.py:299-305
        rs = np.random.RandomState(0)
        return {"source/image": rs.rand(B, side, side, 3).astype(f32),
                "source/keypts": rs.rand(B, 2, 11).astype(f32),
                "target/image": rs.rand(B, side, side, 3).astype(f32)}
    rs = np.random.RandomState(0)  # spn, bench.py:370-377
    yc = rs.rand(B, 5000).astype(f32)
    yw = rs.rand(B, 5000).astype(f32)
    return {"image": rs.rand(B, side, side, 3).astype(f32),
            "y_classes": yc / yc.sum(1, keepdims=True),
            "y_weights": yw / yw.sum(1, keepdims=True)}


def port_draws(measure, B, side):
    if measure in ("krn", "spn"):
        return common.resident_batch(common.recipe_cfg(measure, B, side))
    if measure == "eval":
        pts, data = bench.eval_inputs(B, side)
        return {"pts": pts, **data}
    source, target = bench.dann_inputs(B, side)
    return {**{f"source/{k}": v for k, v in source.items()},
            **{f"target/{k}": v for k, v in target.items()}}


@pytest.mark.parametrize("measure", ["krn", "eval", "dann", "spn"])
def test_inputs_equal_the_root_bench_draws(measure):
    B, side = 3, 67
    ours, ref = port_draws(measure, B, side), bench_py_draws(measure, B, side)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_gate_is_the_root_bench_gate(cpu_run):
    """bench.py:469-470: one ``RandomState(7).rand() < 0.5`` per timed step;
    the KRN measure's steps are WARMUP_STEPS styled, one plain, then the
    gate's draws over the chain's n + 2 steps (on the CPU nothing is
    profiled)."""
    n = SMALL["krn"]["n"]
    ref = np.random.RandomState(7)
    draws = [ref.rand() < 0.5 for _ in range(n + 2)]
    assert list(bench.gate_draws(n + 2)) == draws and any(draws) and not all(draws)
    _, steps = cpu_run
    assert steps["krn"] == [True] * common.WARMUP_STEPS + [False] + draws


def test_styled_step_counts(cpu_run):
    _, steps = cpu_run
    n_krn, n_spn = SMALL["krn"]["n"], SMALL["spn"]["n"]
    assert sum(steps["krn"]) == bench.krn_styled_steps(n_krn, profiled=False)
    assert sum(steps["spn"]) == bench.spn_styled_steps(n_spn, profiled=False)
    plain = common.WARMUP_STEPS + n_spn + 2
    assert steps["spn"] == [False] * plain + [True] * plain


def test_styled_step_counts_with_profiling(monkeypatch):
    """Where the busy ms are profiled (the card), the profile's steps count
    too: ``profile_step.profile`` runs one step, then PROFILE_STEPS."""
    styled = []

    def profile_like(state, step, data, s, dev, label):
        for _ in range(common.PROFILE_STEPS + 1):
            step(state, data, s)
        return 1.0

    def recording(cfg, dev, aug):
        step = make(cfg, dev, aug)

        def run(state, batch, s):
            styled.append(s)
            return step(state, batch, s)

        return run

    make = bench.make_train_step
    monkeypatch.setattr(common, "busy_ms", profile_like)
    monkeypatch.setattr(bench, "make_train_step", recording)
    line = bench.measure_krn(CPU, **SMALL["krn"])
    assert line["krn_styled_device_busy_ms"] == line["krn_plain_device_busy_ms"] == 1.0
    assert sum(styled) == bench.krn_styled_steps(SMALL["krn"]["n"])
    assert len(styled) - sum(styled) == 1 + (SMALL["krn"]["n"] + 2 - int(
        bench.gate_draws(SMALL["krn"]["n"] + 2).sum())) + common.PROFILE_STEPS + 1


def test_dann_measure_runs_the_root_bench_recipe(cpu_run):
    _, steps = cpu_run
    assert steps["dann"] == [bench.DANN_ALPHA] * (common.WARMUP_STEPS + SMALL["dann"]["n"] + 2)
    cfg = bench.dann_cfg()
    assert (cfg.dann, cfg.batch_size, cfg.input_shape, cfg.fp16) == (True, 16, (224, 224), True)
    opt = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], bench.DANN_ALPHA) == (1e-3, 0.01, 0.5)


def test_dann_step_matches_jax_under_the_root_bench_config(revgrad):  # noqa: F811
    """One step of the bench's DANN recipe (its config's optimizer, alpha
    DANN_ALPHA) against JAX's make_dann_train_step under the root bench.py's
    config and alpha (bench.py:283-310), float64 on both sides."""
    _, params, stats = revgrad
    B = 2
    rs = np.random.RandomState(4)
    src, tgt = rs.rand(B, S, S, 3), rs.rand(B, S, S, 3)
    keypts = rs.rand(B, 2, 11).astype(np.float32)
    key = jax.random.PRNGKey(KEY)
    jcfg = jax_default_cfg(batch_size=B, input_shape=(S, S), optimizer="adamw", lr=1e-3,
                           weight_decay=0.01, fp16=True)
    with jax.enable_x64():
        src_key, tgt_key = jax.random.split(jax.random.fold_in(key, 0))
        draws = [jax_draws(k, B, S) for k in (src_key, tgt_key)]
        tx = jax_build_optimizer(jcfg, steps_per_epoch=100)
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64,
                               opt_state=tx.init(p64))
        step = jax_make_dann_train_step(JaxRevGrad(11, dtype=jnp.float64), tx, jcfg)
        new_state, aux = jax.device_get(step(
            jstate, {"image": jnp.asarray(src), "keypts": jnp.asarray(keypts)},
            {"image": jnp.asarray(tgt)}, key, np.float32(0.5)))

    cfg = bench.dann_cfg(B, S)
    model = RevGrad(11, (S, S))
    model.load_state_dict(flax_to_state_dict(params, stats))
    model = model.double()
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    sm = dann_step(state, torch.from_numpy(src), torch.from_numpy(keypts), draws[0],
                   torch.from_numpy(tgt), draws[1], bench.DANN_ALPHA, False)
    for k in ("loss_pose", "loss_source", "loss_target"):
        np.testing.assert_allclose(sm[k].item(), float(aux[k]), rtol=1e-5, err_msg=k)
    ours_p, ours_bs = state_dict_to_flax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_p))
    leaves = jax.tree_util.tree_leaves_with_path(new_state.params)
    assert len(flat) == len(leaves)
    for k, v in leaves:
        np.testing.assert_allclose(flat[k], v, atol=1e-7, err_msg=jax.tree_util.keystr(k))
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_bs))
    for k, v in jax.tree_util.tree_leaves_with_path(new_state.batch_stats):
        np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("argv", [[], ["--measure", "krn"]], ids=["main", "measure"])
def test_raises_without_a_gpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "run_measure", lambda *a: pytest.fail("a measure ran"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(argv)


# A child of the bench whose measures are stubs: each logs its name, then
# returns a one-key line, except the one named FAIL, which does BODY.
STUB_CHILD = """
import sys, time
from speedplusbaseline_tpu_torch import bench

def stub(name):
    def measure(dev):
        with open(LOG, "a") as f:
            f.write(name + "\\n")
        if name == FAIL:
            BODY
        return {"stub_" + name: 1.0, **({"lowering": "plain"} if name in ("krn", "spn") else {})}
    return measure

bench.MEASURES.update({name: stub(name) for name in bench.MEASURES})
bench.main(sys.argv[1:])
"""
FAILURES = {"nonzero": ("raise RuntimeError('stubbed failure')", "CalledProcessError"),
            "no_json": ("print('no line'); sys.exit(0)", "no JSON line"),
            "timeout": ("time.sleep(600)", "TimeoutExpired")}


def stub_child(monkeypatch, tmp_path, fail, body="pass"):
    log = tmp_path / "ran.txt"
    code = (STUB_CHILD.replace("LOG", repr(str(log))).replace("FAIL", repr(fail))
            .replace("BODY", body))
    monkeypatch.setattr(bench, "CHILD", [sys.executable, "-c", code])
    return log


def test_main_merges_the_children_lines(monkeypatch, tmp_path):
    log = stub_child(monkeypatch, tmp_path, fail=None)
    monkeypatch.setattr(bench, "host_loader_rates", lambda: {"host_cores": 1})
    line = bench.main(["--no_cuda"])
    assert line == {"stub_krn": 1.0, "stub_eval": 1.0, "stub_dann": 1.0, "stub_spn": 1.0,
                    "lowering": "plain", "host_cores": 1, "card": "cpu"}
    assert log.read_text().split() == ["krn", "eval", "dann", "spn"]


@pytest.mark.parametrize("failure", sorted(FAILURES))
def test_a_failed_measure_makes_main_raise_once(failure, monkeypatch, tmp_path):
    body, match = FAILURES[failure]
    log = stub_child(monkeypatch, tmp_path, fail="eval", body=body)
    monkeypatch.setattr(common, "CHILD_TIMEOUT_S", 30)
    monkeypatch.setattr(bench, "host_loader_rates", lambda: pytest.fail("the host rates ran"))
    with pytest.raises(Exception) as info:
        bench.main(["--no_cuda"])
    assert match in f"{type(info.value).__name__} {info.value}"
    assert log.read_text().split() == ["krn", "eval"]  # one attempt, nothing after it


def nan_steps(*a, **kw):
    """A step maker whose steps return a NaN loss."""
    return lambda *args: {"loss": torch.tensor(float("nan"))}


@pytest.mark.parametrize("measure", ["krn", "dann", "spn"])
def test_a_non_finite_loss_raises(measure, monkeypatch):
    name = "make_dann_train_step" if measure == "dann" else "make_train_step"
    monkeypatch.setattr(bench, name, nan_steps)
    with pytest.raises(RuntimeError, match="non-finite loss"):
        bench.MEASURES[measure](CPU, **SMALL[measure])
