"""The quality drivers (``speedplusbaseline_tpu_torch/quality/``) against the
JAX package's ``scripts/`` on the CPU: the regeneration rule, the generated
trees (byte for byte, JAX's own ``_generate`` / ``_GEN`` / ``_GEN_PHOTO`` run
in their CPU subprocesses), both exporters (bit for bit, and through the
port's converters back to the weights), the curve reader on the JAX runs'
recorded scalars, the assets mirror, each driver end to end with
``--no_cuda`` at 64^2, and each driver's refusal to run without a GPU.

The drivers run the port's CLIs as subprocesses. Where TensorFlow is
installed, ``torch.utils.tensorboard`` imports it (about 15 s a process);
the end-to-end tests hide it behind a ``tensorflow`` package that raises
``ImportError``, as on a machine without it, where TensorBoard runs on its
stub.
"""
import ast
import filecmp
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import (flax_to_state_dict, read_flax_msgpack,
                                                 state_dict_to_flax, write_flax_msgpack)
from speedplusbaseline_tpu_torch.models.build import get_model
from speedplusbaseline_tpu_torch.models.weight_convert import (convert_bvlc_alexnet,
                                                               convert_mobilenet_v2,
                                                               maybe_load_pretrained)
from speedplusbaseline_tpu_torch.quality import (common, convergence_run, dann_adaptation_run,
                                                 dump_krn_backbone, dump_spn_convs,
                                                 krn_transfer_run, styleaug_ab_run)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, W, H = 8, 320, 200  # frames a split, render size


def jax_script(name):
    """``scripts/<name>.py`` of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_json_keys(name):
    """The keys of the final ``json.dumps({...})`` in a JAX script's main."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    dicts = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps" and n.args
             and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dicts[-1].keys}


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ----- (a) the regeneration rule -------------------------------------------------

# (files in the root, gen_meta.json's text or None, requested bin file, --num_classes,
#  expected), the roots of tests/test_convergence.py.
_NEEDS = {
    "fresh root": ([], None, "", 0, True),
    "no stamp, default asset": (["train.csv"], None, "", 0, False),
    "no stamp, bins": (["train.csv", "b20"], None, "b20", 20, True),
    "stamped 20, asks 20": (["train.csv", "b20"], {"num_classes": 20}, "b20", 20, False),
    "stamped 20, asks 50": (["train.csv", "b20", "b50"], {"num_classes": 20}, "b50", 50, True),
    "stamped 50, reverts to 20": (["train.csv", "b20", "b50"], {"num_classes": 50}, "b20", 20,
                                  True),
    "missing bin file": (["train.csv"], {"num_classes": 7}, "absent", 7, True),
    "stamped 0, default asset": (["train.csv"], {"num_classes": 0}, "", 0, False),
    "unreadable stamp, bins": (["train.csv", "b20"], "not json", "b20", 20, True),
}


@pytest.mark.parametrize("case", sorted(_NEEDS))
def test_needs_generate_matches_jax(case, tmp_path):
    files, meta, npy, num_classes, expected = _NEEDS[case]
    sdir = tmp_path / "speedplus" / "synthetic" / "splits_spn"
    sdir.mkdir(parents=True)
    for f in files:
        (sdir / f if f == "train.csv" else tmp_path / f"{f}.npy").write_text("stub\n")
    if meta is not None:
        (sdir / "gen_meta.json").write_text(meta if isinstance(meta, str) else json.dumps(meta))
    npy = str(tmp_path / f"{npy}.npy") if npy else ""
    ref = jax_script("convergence_run")._needs_generate(str(tmp_path), "spn", npy, num_classes)
    assert common.needs_generate(str(tmp_path), "spn", npy, num_classes) == ref == expected


# ----- (b) the generated trees -----------------------------------------------------

def _jax_gen(script, gen, root, *args):
    subprocess.run([sys.executable, "-c", getattr(jax_script(script), gen), root,
                    *map(str, args)], check=True, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))


# driver -> (the JAX script's generation, the port's), each given (root, cache_dir).
_GENERATE = {
    "convergence krn": (
        lambda r, c: jax_script("convergence_run")._generate(r, N, W, H, "krn", "", 0),
        lambda r, c: convergence_run.generate(r, N, W, H, "krn", "", 0, CPU)),
    "convergence spn, 20 bins, cache": (
        lambda r, c: jax_script("convergence_run")._generate(r, N, W, H, "spn", c, 20),
        lambda r, c: convergence_run.generate(r, N, W, H, "spn", c, 20, CPU)),
    "dann": (
        lambda r, c: jax_script("dann_adaptation_run")._generate(r, N, N, W, H, c),
        lambda r, c: dann_adaptation_run.generate(r, N, N, W, H, c, CPU)),
    "styleaug sunlamp blobs_bright": (
        lambda r, c: _jax_gen("styleaug_ab_run", "_GEN_PHOTO", r, N, W, H, c),
        lambda r, c: styleaug_ab_run.photometric_generate(r, N, W, H, c, CPU)),
    "krn_transfer seed 7": (
        lambda r, c: _jax_gen("krn_transfer_run", "_GEN", r, N, W, H, c, 7),
        lambda r, c: krn_transfer_run.generate(r, N, W, H, c, 7, CPU)),
}


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """{driver: the root the JAX script generated}; the scripts' CPU
    subprocesses run side by side."""
    from concurrent.futures import ThreadPoolExecutor

    roots = {d: str(tmp_path_factory.mktemp("jax_tree")) for d in _GENERATE}
    with ThreadPoolExecutor(len(roots)) as pool:
        for f in [pool.submit(_GENERATE[d][0], r, os.path.join(r, "cache"))
                  for d, r in roots.items()]:
            f.result()
    return roots


@pytest.mark.parametrize("driver", sorted(_GENERATE))
def test_generated_tree_is_jax_byte_for_byte(driver, jax_trees, tmp_path):
    """Every file the driver writes (camera.json, the label JSONs, the
    images, the CSVs, gen_meta.json, the attitude bins, the cached JPEGs
    and the manifest) equals the JAX driver's byte for byte."""
    ref, root = jax_trees[driver], str(tmp_path)
    _GENERATE[driver][1](root, os.path.join(root, "cache"))
    files = tree_files(ref)
    assert files == tree_files(root)
    assert any(f.endswith(".csv") for f in files) and any(f.endswith(".jpg") for f in files)
    if driver != "convergence krn":
        assert any(f.endswith("cache_manifest.csv") for f in files)
    for f in files:
        assert filecmp.cmp(os.path.join(ref, f), os.path.join(root, f), shallow=False), f


# ----- (c), (d) the exporters ----------------------------------------------------

def _seeded(sd, seed):
    """``sd`` with every float tensor drawn from a seed (BatchNorm statistics
    included; variances positive)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        x = rs.standard_normal(tuple(v.shape)).astype(np.float32)
        out[k] = torch.from_numpy(np.abs(x) + 0.5 if k.endswith("running_var") else x)
    return out


@pytest.mark.parametrize("kind", ["krn model_best", "krn checkpoint", "dann model_best"])
def test_dump_krn_backbone_matches_jax_and_round_trips(kind, tmp_path):
    dann = kind.startswith("dann")
    sd = _seeded(get_model(default_cfg(dann=dann)).state_dict(), 3)
    ckpt = {"variables": sd, "epoch": 1} if "checkpoint" in kind else sd
    torch.save(ckpt, tmp_path / "port.pt")
    out = dump_krn_backbone.main([str(tmp_path / "port.pt"), str(tmp_path / "port.pth")])
    assert all(torch.equal(a, b) for a, b in zip(
        out.values(), torch.load(tmp_path / "port.pth", weights_only=True).values()))

    # JAX's exporter on the same weights, as a flax msgpack.
    params, stats = state_dict_to_flax(sd)
    write_flax_msgpack({"params": params, "batch_stats": stats}, str(tmp_path / "jax.msgpack"))
    jax_dump = jax_script("dump_krn_backbone")
    ref = jax_dump.dump(str(tmp_path / "jax.msgpack"), str(tmp_path / "jax.pth"))
    assert list(out) == list(ref)
    for k, v in ref.items():
        assert out[k].dtype == torch.float32 and out[k].is_contiguous()
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)

    # Back through the convert_weights CLI and maybe_load_pretrained's reader.
    from speedplusbaseline_tpu_torch import convert_weights

    convert_weights.main(["mobilenet_v2", "--src", str(tmp_path / "port.pth"), "--out",
                          str(tmp_path / "mobilenetv2_backbone.msgpack"), "--no_cuda"])
    raw = read_flax_msgpack(str(tmp_path / "mobilenetv2_backbone.msgpack"))
    back = flax_to_state_dict(raw["params"], raw["batch_stats"])
    base = dump_krn_backbone.base_state_dict(sd)
    assert set(back) == set(base) == set(convert_mobilenet_v2(out))
    assert all(torch.equal(back[k], base[k]) for k in base)
    model = get_model(default_cfg(dann=dann))
    assert maybe_load_pretrained(default_cfg(dann=dann), model, str(tmp_path))
    trunk = (model.net if dann else model).base.state_dict()
    assert all(torch.equal(trunk[k], base[k]) for k in base)


def test_dump_spn_convs_matches_jax_and_round_trips(tmp_path):
    cfg = default_cfg(model_name="spn", num_classes=20, input_shape=(99, 99))
    sd = _seeded(get_model(cfg).state_dict(), 4)
    torch.save(sd, tmp_path / "model_best.pt")
    out = dump_spn_convs.main([str(tmp_path / "model_best.pt"),
                               str(tmp_path / "assets" / "bvlc_alexnet.npy"),
                               "--mirror_assets"])
    params, _ = state_dict_to_flax(sd)
    write_flax_msgpack({"params": params}, str(tmp_path / "jax.msgpack"))
    ref = jax_script("dump_spn_convs").dump(str(tmp_path / "jax.msgpack"),
                                             str(tmp_path / "jax.npy"))
    ours = np.load(tmp_path / "assets" / "bvlc_alexnet.npy", allow_pickle=True).item()
    assert sorted(ours) == sorted(ref) == sorted(out)
    for name, (kernel, bias) in ref.items():
        for a, b in zip(ours[name], (kernel, bias)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=name)

    back = convert_bvlc_alexnet(ours)
    assert set(back) == {f"conv{i}.{leaf}" for i in range(1, 6) for leaf in ("weight", "bias")}
    assert all(torch.equal(back[k], sd[k]) for k in back)
    # The mirrored directory serves as SPEEDPLUS_ASSETS_DIR for the boot run.
    assert os.path.exists(tmp_path / "assets" / "tango_points.npy")
    model = get_model(cfg)
    assert maybe_load_pretrained(cfg, model, str(tmp_path / "assets"))
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in back)


# ----- (e) the curve reader, (f) the assets mirror ----------------------------------

@pytest.mark.parametrize("scalars", ["dann_ab_artifacts/src_scalars.jsonl",
                                     "dann_ab_artifacts/dann_scalars.jsonl",
                                     "krn_boot_artifacts/boot_scalars.jsonl"])
def test_curve_matches_jax(scalars, tmp_path):
    shutil.copy(os.path.join(REPO, "runs", scalars), tmp_path / "scalars.jsonl")
    ours = common.curve(str(tmp_path))
    assert ours and ours == jax_script("dann_adaptation_run")._curve(str(tmp_path))
    assert all(set(c) >= set(common.VALID_TAGS) for c in ours.values())


def test_mirror_assets_excludes_pretrained_backbone(tmp_path, monkeypatch):
    src = tmp_path / "assets"
    src.mkdir()
    (src / "tango_points.npy").write_bytes(b"pts")
    (src / "mobilenetv2_backbone.msgpack").write_bytes(b"bb")
    common.mirror_assets(str(tmp_path / "port"), src=str(src))
    ktr = jax_script("krn_transfer_run")
    monkeypatch.setattr(ktr, "REPO", str(tmp_path))
    ktr._mirror_assets(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "tango_points.npy"]
    common.mirror_assets(str(tmp_path / "repo"))
    assert sorted(os.listdir(tmp_path / "repo")) == sorted(
        f for f in os.listdir(common.ASSETS) if f != common.BACKBONE_ASSET)


# ----- (g) each driver end to end, (h) no GPU -----------------------------------------

@pytest.fixture(scope="module")
def no_tf(tmp_path_factory):
    """A PYTHONPATH whose ``tensorflow`` raises ImportError."""
    d = tmp_path_factory.mktemp("no_tf")
    (d / "tensorflow").mkdir()
    (d / "tensorflow" / "__init__.py").write_text('raise ImportError("hidden")\n')
    path = os.pathsep.join(p for p in (str(d), os.environ.get("PYTHONPATH")) if p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", path)
        yield


# Small CLI flags every arm takes: 64^2, 4 a batch.
SMALL = ["--input_shape", "64", "64", "--batch_size", "4", "--eval_batch_size", "8"]


def _check_summary(summary, capsys_out, script):
    last = capsys_out.strip().splitlines()[-1]
    assert json.loads(last) == summary
    assert set(summary) == jax_json_keys(script)
    for k, v in summary.items():
        if isinstance(v, (int, float)):
            assert math.isfinite(v) and v != -1, (k, v)  # -1: JAX's default for a missing metric
        else:
            assert v is None or isinstance(v, str), (k, v)


def test_convergence_run_end_to_end(no_tf, tmp_path, capfd):
    root = str(tmp_path / "conv")
    summary = convergence_run.main(["--root", root, "--n_train", str(N), "--epochs", "2",
                                    "--input", "64", "--test_every", "1", "--no_cuda",
                                    "--batch_size", "4", "--eval_batch_size", "16"])
    out = capfd.readouterr().out
    _check_summary(summary, out, "convergence_run")
    assert summary["model"] == "krn" and summary["input"] == 64
    assert sorted(common.curve(os.path.join(root, "log"))) == [1, 2]
    assert "err_q.txt: 48 images, median eR" in out
    assert "[train] arm finished in" in out


def test_dann_adaptation_run_end_to_end(no_tf, tmp_path, capfd):
    ab_root = str(tmp_path / "ab")
    summary = dann_adaptation_run.main([
        "--root", ab_root, "--n_src", str(N), "--n_tgt", str(N), "--epochs_src", "1",
        "--epochs_dann", "1", "--test_every", "1", "--render_w", str(W), "--render_h",
        str(H), "--no_cuda"] + SMALL)
    out = capfd.readouterr().out
    _check_summary(summary, out, "dann_adaptation_run")
    assert "[train] arm finished" in out and "[adapt] arm finished" in out
    ckpt = torch.load(os.path.join(ab_root, "save_dann", "model_best.pt"), weights_only=True)
    assert any(k.startswith("domain_classifier.") for k in ckpt)


def test_styleaug_ab_run_end_to_end(no_tf, tmp_path, capfd, monkeypatch):
    """On a root of its own the driver generates the A/B's data and trains
    arm A itself (on the DANN A/B's root it reuses that arm A)."""
    ab_root = str(tmp_path / "ab")
    monkeypatch.setattr(styleaug_ab_run, "N_PHOTO", N)
    summary = styleaug_ab_run.main([
        "--root", ab_root, "--n_src", str(N), "--n_tgt", str(N), "--epochs", "1",
        "--test_every", "1", "--render_w", str(W), "--render_h", str(H), "--no_cuda"] + SMALL)
    cap = capfd.readouterr()
    _check_summary(summary, cap.out, "styleaug_ab_run")
    assert cap.out.count("[train] arm finished") == 2  # arms A and C
    assert cap.out.count("[test] arm finished") == 2
    assert "Texture randomization enabled" in cap.err
    assert "Ghiasi transformer weights loaded from" in cap.err
    with open(os.path.join(ab_root, "save_style", "config.txt")) as f:
        assert json.load(f)["randomize_texture"] is True
    assert os.path.exists(os.path.join(ab_root, "log_photo_style", "err_q.txt"))


def test_krn_transfer_run_end_to_end(no_tf, tmp_path, capfd, monkeypatch):
    root = str(tmp_path / "xfer")
    monkeypatch.setattr(krn_transfer_run, "N_DONOR", N)
    monkeypatch.setattr(krn_transfer_run, "EPOCHS_DONOR", 1)
    summary = krn_transfer_run.main([
        "--root", root, "--donor", str(tmp_path / "absent.pt"), "--n_train", str(N),
        "--epochs", "2", "--test_every", "1", "--render_w", str(W), "--render_h", str(H), "--no_cuda"] + SMALL)
    cap = capfd.readouterr()
    _check_summary(summary, cap.out, "krn_transfer_run")
    assert "training one under" in cap.out
    loaded = (cap.out + cap.err).count("MobileNetV2 ImageNet backbone loaded from")
    assert loaded == 1, loaded  # the boot arm only
    assert f"loaded from {os.path.join(root, 'boot_assets')}" in cap.out + cap.err
    assert not os.path.exists(os.path.join(root, "scratch_assets", common.BACKBONE_ASSET))
    for arm in ("scratch", "boot"):
        assert os.path.exists(os.path.join(root, f"log_{arm}", "done"))


_DRIVERS = {"convergence_run": convergence_run.main,
            "dann_adaptation_run": dann_adaptation_run.main,
            "styleaug_ab_run": styleaug_ab_run.main,
            "krn_transfer_run": krn_transfer_run.main}


@pytest.mark.parametrize("driver", sorted(_DRIVERS))
def test_driver_raises_without_gpu(driver, tmp_path, monkeypatch):
    """Without a GPU and without --no_cuda a driver raises before it makes
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        _DRIVERS[driver](["--root", str(tmp_path / "root")])
    assert not os.path.exists(tmp_path / "root" / "speedplus")


def test_launch_log_records_a_subprocess(tmp_path):
    """SPEEDPLUS_LAUNCH_LOG: a process that loaded the kernel wrappers appends
    its launch counts at exit (zero here: the CPU runs the plain versions)."""
    log = tmp_path / "launches.jsonl"
    env = dict(os.environ, SPEEDPLUS_LAUNCH_LOG=str(log))
    log.write_text(json.dumps({"argv": ["earlier"], "launches": {}}) + "\n")
    subprocess.run([sys.executable, "-c", "import speedplusbaseline_tpu_torch.ops.resblock"],
                   check=True, cwd=REPO, env=env)
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["launches"] for r in lines] == [{}, {"instance_norm_film": 0,
                                                   "ghiasi_resblock": 0}]
