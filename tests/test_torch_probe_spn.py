"""The port's SPN memorization probe and Run S seed-sweep tools against the
JAX package on the CPU: the probe's batches and its ``--no_clip`` optimizer
against the JAX probe's (``scripts/probe_spn_memorize.py``), its CLI
output, the missing-GPU error, a 32-step float64 SPN trajectory from one
init against JAX's step, and the sweep's stall test, Fisher test,
live-ReLU shares (against ``capture_intermediates``) and in-process run
(against the train CLI).

The data is a small generated root (8 frames of 320x200, 500 attitude bins,
the RoI cache) at 99^2, batch 4.
"""
import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.engine import make_spn_train_step as jax_make_spn_train_step
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
from speedplusbaseline_tpu.models.spn import SpacecraftPoseNet as JaxSPN
from speedplusbaseline_tpu_torch import train
from speedplusbaseline_tpu_torch.config import default_cfg, parse_cfg
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.engine import TrainState, build_optimizer, spn_step
from speedplusbaseline_tpu_torch.models.spn import SpacecraftPoseNet
from speedplusbaseline_tpu_torch.quality import convergence_run
from speedplusbaseline_tpu_torch.quality import probe_spn_memorize as probe
from speedplusbaseline_tpu_torch.quality import spn_seed_sweep as sweep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, NC = 99, 4, sweep.NUM_CLASSES


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("spn_probe"))
    convergence_run.prepare(r, 8, 320, 200, "spn", True, NC, torch.device("cpu"))
    return r


def probe_flags(root):
    return ["--dataroot", root, "--cache_dir", os.path.join(root, "cache"),
            "--num_classes", str(NC), "--attitude_class", convergence_run.attitude_path(root, NC),
            "--batch_size", str(B), "--input_shape", str(S), str(S), "--optimizer", "adamw",
            "--lr", "1e-3", "--weight_decay", "0.01", "--steps", "3", "--n_batches", "2"]


def numbers_as_n(lines):
    """Each line with its numbers replaced by N: the line's format."""
    return [re.sub(r"\d+(\.\d+)?", "N", x) for x in lines]


@pytest.fixture(scope="module")
def jax_probe(root):
    """The JAX probe's main with --no_clip, its step replaced by one that
    records the batches it is given: (batches, tx, cfg, stdout lines)."""
    mod = _load("jax_probe_spn_memorize", "scripts/probe_spn_memorize.py")
    seen = {"batches": []}

    def fake_make_step(model, tx, cfg):
        seen["tx"], seen["cfg"] = tx, cfg

        def step(state, batch, rng):
            seen["batches"].append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss_c": jnp.float32(0.0), "loss_r": jnp.float32(0.0)}
        return step

    mod.make_spn_train_step = fake_make_step
    argv = sys.argv
    sys.argv = ["probe_spn_memorize.py"] + probe_flags(root) + ["--no_clip"]
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    seen["lines"] = out.getvalue().splitlines()
    return seen


def port_probe(root, monkeypatch, extra=()):
    """The port probe's main, its step replaced as in jax_probe: (batches,
    optimizer, clip)."""
    seen = {"batches": []}

    def fake_make_step(cfg, device, clip=True):
        seen["clip"] = clip

        def step(state, batch, styled):
            seen["optimizer"] = state.optimizer
            seen["batches"].append({k: v.numpy() for k, v in batch.items()})
            return {"loss_c": torch.tensor(0.0), "loss_r": torch.tensor(0.0)}
        return step

    monkeypatch.setattr(probe, "make_spn_train_step", fake_make_step)
    probe.main(probe_flags(root) + ["--no_cuda", *extra])
    return seen


def test_probe_batches_match_jax_probe(root, jax_probe, monkeypatch):
    ours = port_probe(root, monkeypatch, ["--no_clip"])
    assert len(ours["batches"]) == len(jax_probe["batches"]) == 3
    for a, b in zip(ours["batches"], jax_probe["batches"]):
        assert set(a) == set(b) == {"image", "y_classes", "y_weights"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # two distinct batches, cycled: 0, 1, 0
    np.testing.assert_array_equal(ours["batches"][0]["image"], ours["batches"][2]["image"])
    assert not np.array_equal(ours["batches"][0]["image"], ours["batches"][1]["image"])
    assert ours["clip"] is False
    assert port_probe(root, monkeypatch)["clip"] is True


def test_no_clip_updates_match_jax_chain_in_float64(root, jax_probe, monkeypatch):
    """The first three updates of the port's --no_clip optimizer against the
    JAX probe's optax chain (the one its main built), in float64."""
    ours = port_probe(root, monkeypatch, ["--no_clip"])["optimizer"]
    cfg = parse_cfg(probe.DEFAULTS + probe_flags(root)[:-4] + ["--no_cuda"])
    ref = probe.no_clip_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])
    assert type(ours) is type(ref) is torch.optim.AdamW
    assert {k: v for k, v in ours.defaults.items()} == ref.defaults
    tx = jax_probe["tx"]
    rs = np.random.RandomState(3)
    p0 = {"w": rs.randn(6, 5), "b": rs.randn(7) * 0.1}
    grads = [{k: rs.randn(*v.shape) * 10.0 ** rs.randint(-9, 1) for k, v in p0.items()}
             for _ in range(3)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = probe.no_clip_optimizer(cfg, params.values())
    with jax.enable_x64():
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        for g in grads:
            before = {k: p.detach().clone() for k, p in params.items()}
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in params.items():
                got = (p.detach() - before[k]).numpy()
                want = np.asarray(upd[k])
                assert np.abs(want).max() > 1e-4  # each step moves the weights
                np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("clip", [True, False])
def test_spn_step_clips_by_value_unless_told_not_to(clip):
    """spn_step's ``clip`` (the probe's --no_clip): with images scaled 20x
    some gradients pass 1; the clip by value holds them at 1."""
    torch.manual_seed(0)
    model = SpacecraftPoseNet(37, 0.0, (S, S))
    rs = np.random.RandomState(5)
    yc = np.zeros((2, 37), np.float32)
    yc[:, :5] = 0.2
    state = TrainState(model, build_optimizer(default_cfg(model_name="spn", optimizer="adamw"),
                                              model.parameters()))
    spn_step(state, torch.from_numpy((rs.rand(2, S, S, 3) * 20).astype(np.float32)),
             torch.from_numpy(yc), torch.from_numpy(yc), False, clip=clip)
    largest = max(p.grad.abs().max().item() for p in model.parameters())
    assert largest == 1.0 if clip else largest > 1.0


def test_probe_cli_runs_on_cpu_with_jax_lines(root, jax_probe, capsys):
    recs = probe.main(probe_flags(root) + ["--no_cuda", "--no_clip"])
    lines = capsys.readouterr().out.splitlines()
    assert numbers_as_n(lines) == numbers_as_n(jax_probe["lines"])
    assert lines[0] == "loaded batch 0/2" and lines[-1] == "DONE"
    assert lines[1] == jax_probe["lines"][1]  # the batch's shapes and types, verbatim
    assert len(recs) == 1 and recs[0]["step"] == 2
    assert all(math.isfinite(recs[0][k]) for k in ("loss_c", "cyc_avg", "loss_r"))
    assert recs[0]["loss_c"] < math.log(NC) + 1.0


def test_probe_raises_without_gpu(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        probe.main(probe_flags(root))


def test_spn_32_steps_match_jax_in_float64():
    """32 AdamW steps (clip by value 1.0) of spn_step from a converted init
    against the JAX package's make_spn_train_step, dropout off, float64 on
    both sides (the logits and the loss in f32 on both, as both models cast
    their heads), 99^2, batch 2, four batches of images in [0, 1] in turn:
    test_torch_spn.py::test_spn_train_steps_match_jax, carried from 2 steps
    to 32. Bounds: the losses within 2e-6 relative at every step (f32
    rounding of the logits is 6e-8 a step; read: 5e-7 at worst); per tensor,
    the gap's L2 norm within 2e-3 of the L2 norm of the weights' move (read:
    4e-4 at worst, fc8) and at most 1e-4 of the weights more than 1e-4 apart
    (read: 1.3e-5, two of fc8's 151,552). Adam's update of a weight whose
    gradient is near eps follows that gradient's last bits, which the f32
    logits set, by up to lr a step, so a few weights drift by a few lr (read:
    3.3e-3 at most, in fc10) while the rest agree. A wrong clip, decay or
    gradient is off by order 1e-1 of the move. Images scaled 20x, as the
    two-step test feeds to force the clip, make the first step's loss 91 and
    the two trajectories part exponentially after 10 steps (1e-4 relative
    at step 12, 5e-3 at step 24, read on a CPU): chaos, in which neither
    side tracks itself under a change of rounding."""
    steps, n_batches, bb = 32, 4, 2
    torch.manual_seed(0)
    model = SpacecraftPoseNet(37, 0.0, (S, S))
    params = state_dict_to_flax(model.state_dict())[0]
    model.double()
    rs = np.random.RandomState(8)
    batches = []
    for _ in range(n_batches):
        yc = np.zeros((bb, 37), np.float32)
        yw = np.zeros((bb, 37), np.float32)
        for i in range(bb):
            idx = rs.choice(37, 5, replace=False)
            yc[i, idx] = 0.2
            yw[i, idx] = rs.dirichlet(np.ones(5))
        batches.append({"image": rs.rand(bb, S, S, 3).astype(np.float32),
                        "y_classes": yc, "y_weights": yw})
    kw = dict(model_name="spn", optimizer="adamw", lr=1e-3, weight_decay=0.01, num_classes=37)
    state = TrainState(model, build_optimizer(default_cfg(**kw), model.parameters()))
    ours = [spn_step(state, *(torch.from_numpy(batches[i % n_batches][k])
                              for k in ("image", "y_classes", "y_weights")), False)
            for i in range(steps)]
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = jax_build_optimizer(jax_default_cfg(**kw), 10 ** 6)
        step = jax_make_spn_train_step(JaxSPN(37, keep_prob=0.0, dtype=jnp.float64), tx,
                                       jax_default_cfg(**kw))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats={},
                               opt_state=tx.init(p64))
        ref = []
        for i in range(steps):
            jstate, sm = step(jstate, {k: jnp.asarray(v) for k, v in
                                       batches[i % n_batches].items()}, jax.random.PRNGKey(0))
            ref.append(jax.device_get(sm))
        new_p = jax.device_get(jstate.params)
    for o, r in zip(ours, ref):
        for k in ("loss_c", "loss_r"):
            np.testing.assert_allclose(o[k].item(), float(r[k]), rtol=2e-6)
    first, last = ours[0]["loss_c"].item(), np.mean([o["loss_c"].item() for o in ours[-4:]])
    assert last < first - 0.3  # it learned
    flat = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(model.state_dict())[0]))
    init = dict(jax.tree_util.tree_leaves_with_path(params))
    for k, v in jax.tree_util.tree_leaves_with_path(new_p):
        name = jax.tree_util.keystr(k)
        gap, moved = np.abs(flat[k] - v), np.abs(v - init[k])
        assert np.linalg.norm(gap) <= 2e-3 * np.linalg.norm(moved), name
        assert np.mean(gap > 1e-4) <= 1e-4, name
        assert moved.max() > 8e-3, name  # every tensor moved by several lr


def test_stall_criterion_and_loss_c_reader(tmp_path):
    (tmp_path / "scalars.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"tag": "train/loss_c", "value": 6.21, "step": 2},
        {"tag": "train/loss_r", "value": 6.0, "step": 1},
        {"tag": "train/loss_c", "value": 6.22, "step": 1}]))
    assert sweep.loss_c_by_epoch(str(tmp_path)) == [6.22, 6.21]
    floor = math.log(NC) - sweep.STALL_MARGIN
    # Run S's recorded 80-epoch runs: seed 2 held 6.19-6.23, seed 1 fell to 5.22 in epoch 2
    assert sweep.is_stalled([6.22, 6.20, 6.19, 6.19])
    assert not sweep.is_stalled([6.2, 5.22, 4.8, 4.5])
    assert sweep.is_stalled([floor]) and not sweep.is_stalled([floor - 1e-6])


@pytest.mark.parametrize("table", [(4, 8, 0, 6), (1, 11, 3, 3), (0, 12, 0, 6), (6, 6, 3, 3),
                                   (10, 2, 0, 6)])
def test_fisher_exact_matches_scipy(table):
    from scipy.stats import fisher_exact

    a, b, c, d = table
    want = fisher_exact([[a, b], [c, d]]).pvalue
    assert sweep.fisher_exact(a, b, c, d) == pytest.approx(want, rel=1e-9)


def test_live_shares_match_jax_capture_intermediates():
    """The port's forward hooks and the JAX side's capture_intermediates
    (tests/jax_spn_stall.py) count the same live units on one converted
    model; a dead unit (bias pushed far below) counts as dead."""
    stall = _load("jax_spn_stall", "tests/jax_spn_stall.py")
    torch.manual_seed(1)
    model = SpacecraftPoseNet(37, 0.5, (S, S))
    with torch.no_grad():
        model.fc7.bias[:1000] = -1e3
        model.conv3.bias[:100] = -1e3
    params = state_dict_to_flax(model.state_dict())[0]
    x = np.random.RandomState(2).rand(6, S, S, 3).astype(np.float32)
    model.train()
    ours = sweep.live_shares(model, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert model.training  # the mode is restored
    ref = stall.jax_live_shares(JaxSPN(37, keep_prob=0.5), params, jnp.asarray(x))
    assert set(ours) == set(ref) == set(sweep.LIVE_LAYERS)
    for n in sweep.LIVE_LAYERS:
        assert ours[n] == pytest.approx(ref[n], abs=2.0 / 4096), n
    assert ours["fc7"] <= 1 - 1000 / 4096 and ours["conv3"] <= 1 - 100 / 384
    assert ours["conv1"] > 0.5


def hidden_tensorflow(tmp_path):
    d = tmp_path / "no_tf"
    (d / "tensorflow").mkdir(parents=True)
    (d / "tensorflow" / "__init__.py").write_text('raise ImportError("hidden")\n')
    return str(d)


def test_live_run_trains_as_the_train_cli(root, tmp_path, monkeypatch):
    """live_run's epochs are the train CLI's: the same per-epoch mean loss_c
    from the same seed, data and flags; shares at the asked steps."""
    flags = sweep.run_s_flags(root, 3, 2, str(tmp_path / "cli"), S) + [
        "--no_cuda", "--batch_size", str(B), "--num_workers", "2"]
    records = train.main(flags)
    cli = [np.mean([r["loss_c"] for r in records if r["epoch"] == e]) for e in (1, 2)]
    assert sweep.loss_c_by_epoch(str(tmp_path / "cli" / "log")) == pytest.approx(cli, rel=1e-6)
    shares, epochs = sweep.live_run(parse_cfg(flags), (0, 1, 4))
    assert epochs == pytest.approx(cli, rel=1e-6)
    assert sorted(shares) == [0, 1, 4]
    assert all(0.0 <= v <= 1.0 for s in shares.values() for v in s.values())


def test_sweep_cli_runs_and_tabulates(root, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PYTHONPATH", hidden_tensorflow(tmp_path))
    seeds_dir = str(tmp_path / "seeds")
    out = sweep.main(["--root", root, "--seeds", "0", "5", "--epochs", "1", "--no_cuda",
                      "--input", str(S), "--seeds_dir", seeds_dir, "--batch_size", str(B),
                      "--num_workers", "2"])
    assert sorted(out["port"]) == [0, 5]
    for row in out["port"].values():
        assert len(row["loss_c"]) == 1 and math.isfinite(row["loss_c"][0])
        assert row["stalled"] == sweep.is_stalled(row["loss_c"])
    assert not os.path.exists(os.path.join(seeds_dir, "seed_0", "save"))
    again = sweep.main(["--root", root, "--tabulate", "--seeds_dir", seeds_dir,
                        "--compare", seeds_dir, "--epochs", "1"])
    assert again["port"] == again["compare"] == out["port"]
    assert again["fisher_p"] == 1.0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["fisher_p"] == 1.0
    # runs short of --epochs are left out
    assert sweep.main(["--root", root, "--tabulate", "--seeds_dir", seeds_dir])["port"] == {}
