"""The PyTorch port imports no JAX, and its CLIs refuse what they do not
serve: a missing GPU without --no_cuda, an unknown model name and DANN in
the train CLI; they accept every flag of the JAX package's CLIs."""
import os
import subprocess
import sys

import pytest
import torch

from speedplusbaseline_tpu_torch import adapt, convert_weights, embedding, preprocess, train
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch.config import parse_cfg, resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import speedplusbaseline_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "speedplusbaseline_tpu"))
print(" ".join(mods))
assert not bad, bad
from speedplusbaseline_tpu_torch.native import load
lib = load()._name  # the port's own core, built from its csrc/
with open("/proc/self/maps") as f:
    maps = f.read()
assert "/build/native/" in lib and lib in maps, lib
assert "speedplusbaseline_tpu/native" not in maps
"""


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke, imports JAX or the JAX package,
    and the native decode core it loads is its own build, not the JAX
    package's libspeedloader.so."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 30  # every submodule was imported
    p = "speedplusbaseline_tpu_torch."
    assert {p + m for m in ("geometry.epnp", "geometry.quaternion", "geometry.projection",
                            "geometry._eigh", "geometry._precision", "metrics.pose_score",
                            "test", "io_utils.misc", "io_utils.visualize",
                            "geometry.spn_position", "models.spn", "models.build",
                            "models.revgrad", "adapt", "preprocess", "data.preprocess",
                            "data.synthetic", "models.weight_convert", "models.style_predictor",
                            "embedding", "convert_weights", "data.cache", "cache_dataset",
                            "native.loader", "parallel.mesh", "ops.phase_conv",
                            "quality.common", "quality.convergence_run",
                            "quality.dann_adaptation_run", "quality.styleaug_ab_run",
                            "quality.dump_krn_backbone", "quality.krn_transfer_run",
                            "quality.dump_spn_convs", "train_toy_ghiasi", "convert_assets",
                            "ops._vjp", "quality.probe_spn_memorize",
                            "quality.spn_seed_sweep")} <= mods


def test_train_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        train.main(["--savedir", str(tmp_path / "s"), "--logdir", str(tmp_path / "l")])
    assert resolve_device(parse_cfg(["--no_cuda"])).type == "cpu"


def test_test_cli_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        test_cli.main(["--logdir", str(tmp_path / "l")])


@pytest.mark.parametrize("flags", [
    ["--profile_dir", "prof"], ["--use_native_loader"], ["--cache_dir", "cache"],
    ["--num_devices", "2"],
])
def test_ported_flags_are_accepted(flags, tmp_path):
    """The three CLIs take each flag and go on to read their data, which is
    missing here (the flags' runs: test_torch_data_path.py and, for
    --num_devices, test_torch_parallel.py, whose ranks raise the error in
    the calling process)."""
    for main in (train.main, test_cli.main, adapt.main):
        with pytest.raises(FileNotFoundError, match=str(tmp_path / "none")):
            main(flags + ["--perform_dann"] * (main is adapt.main)
                 + ["--dataroot", str(tmp_path / "none"), "--no_cuda",
                    "--savedir", str(tmp_path / "s"), "--logdir", str(tmp_path / "l")])


def test_train_cli_sends_dann_to_adapt(tmp_path):
    """DANN trains through the adapt CLI; the train CLI says so."""
    with pytest.raises(ValueError, match="speedplusbaseline_tpu_torch.adapt"):
        train.main(["--perform_dann", "--no_cuda", "--savedir", str(tmp_path / "s"),
                    "--logdir", str(tmp_path / "l")])


def test_preprocess_cli_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        preprocess.main(["--dataroot", str(tmp_path)])


def test_embedding_and_convert_clis_raise_without_gpu(monkeypatch, tmp_path):
    """Both run on the card unless given --no_cuda; with it, on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "img").mkdir()
    from PIL import Image

    Image.new("RGB", (64, 48)).save(tmp_path / "img" / "a.png")
    args = ["--data_dir", str(tmp_path / "img"), "--batchsize", "1", "--input_size", "48",
            "64", "--allow_random_init", "--out_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="--no_cuda"):
        embedding.main(args)
    assert embedding.main(args + ["--no_cuda"]).shape == (1, 100)
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    torch.save({"state_dict_ghiasi": {k.replace("layer", "layers.", 1): v for k, v in
                                      Ghiasi().state_dict().items()}}, tmp_path / "g.pth")
    args = ["ghiasi", "--src", str(tmp_path / "g.pth"), "--out", str(tmp_path / "g.msgpack")]
    with pytest.raises(RuntimeError, match="--no_cuda"):
        convert_weights.main(args)
    assert convert_weights.main(args + ["--no_cuda"]) == str(tmp_path / "g.msgpack")


def test_toy_ghiasi_cli_raises_without_gpu(monkeypatch, tmp_path):
    """The toy trainer runs on the card unless given --no_cuda; with it, a
    few steps on the CPU write the file (never the default --out)."""
    from speedplusbaseline_tpu_torch import train_toy_ghiasi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--steps", "2", "--batch", "1", "--size", "16", "--out", str(tmp_path / "g.msgpack")]
    with pytest.raises(RuntimeError, match="--no_cuda"):
        train_toy_ghiasi.main(args)
    assert not (tmp_path / "g.msgpack").exists()
    assert train_toy_ghiasi.main(args + ["--no_cuda"])["out"] == str(tmp_path / "g.msgpack")
    assert (tmp_path / "g.msgpack").stat().st_size > 1_000_000


def test_unknown_model_name_raises(tmp_path):
    for main in (train.main, test_cli.main):
        with pytest.raises(ValueError, match="krn or spn"):
            main(["--model_name", "foo", "--no_cuda", "--savedir", str(tmp_path / "s"),
                  "--logdir", str(tmp_path / "l")])
