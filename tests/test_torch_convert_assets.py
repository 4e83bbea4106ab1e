"""The port's asset converter (``python -m speedplusbaseline_tpu_torch.convert_assets``)
against ``scripts/convert_assets.py`` on synthetic inputs: the reference's
``.mat`` files (``scipy.io.savemat``), its ``checkpoint_embeddings.pth``
(``torch.save``) and its ``embedding_mean_speedplus.npy``, laid out as in a
speedplusbaseline checkout under ``tmp_path``. Both write the same ``.npy``
files, byte for byte, with and without the optional inputs."""
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

from scripts.convert_assets import main as jax_main
from speedplusbaseline_tpu_torch import convert_assets

OPTIONAL = {"pth": ("style_embedding_pbn_mean.npy", "style_embedding_pbn_cov.npy"),
            "npy": ("style_embedding_speedplus_mean.npy",)}
ALWAYS = ("tango_points.npy", "attitude_classes.npy")


def write_checkout(root, optional, seed: int = 0) -> None:
    """The reference's asset files, with its names, keys and layouts: the
    keypoints as (3, 11) float64, the classes (5000, 4), the embedding
    mean as (1, 100) tensors (reshaped by both converters)."""
    rs = np.random.RandomState(seed)
    utils = root / "src" / "utils"
    ckpts = root / "src" / "styleaug" / "checkpoints"
    utils.mkdir(parents=True)
    ckpts.mkdir(parents=True)
    savemat(utils / "tangoPoints.mat", {"tango3Dpoints": rs.uniform(-0.4, 0.4, (3, 11))})
    q = rs.randn(5000, 4)
    savemat(utils / "attitudeClasses.mat", {"qClass": q / np.linalg.norm(q, axis=1,
                                                                         keepdims=True)})
    if "pth" in optional:
        a = rs.randn(100, 100)
        torch.save({"pbn_embedding_mean": torch.from_numpy(rs.randn(1, 100)),
                    "pbn_embedding_covariance": torch.from_numpy(a @ a.T / 100)},
                   ckpts / "checkpoint_embeddings.pth")
    if "npy" in optional:
        np.save(ckpts / "embedding_mean_speedplus.npy", rs.randn(1, 100))


@pytest.mark.parametrize("optional", [(), ("pth",), ("npy",), ("pth", "npy")])
def test_outputs_equal_the_script_byte_for_byte(optional, tmp_path, monkeypatch, capsys):
    src = tmp_path / "speedplusbaseline"
    write_checkout(src, optional)
    monkeypatch.setattr(sys, "argv", ["convert_assets.py", "--src", str(src), "--out",
                                      str(tmp_path / "jax")])
    jax_main()
    jax_log = capsys.readouterr().out
    convert_assets.main(["--src", str(src), "--out", str(tmp_path / "port")])
    assert capsys.readouterr().out == jax_log

    names = ALWAYS + sum((OPTIONAL[k] for k in optional), ())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == sorted(names)
    for name in names:
        ours = (tmp_path / "port" / name).read_bytes()
        assert ours == (tmp_path / "jax" / name).read_bytes(), name
    shapes = {"tango_points.npy": (11, 3), "attitude_classes.npy": (5000, 4),
              "style_embedding_pbn_mean.npy": (100,), "style_embedding_pbn_cov.npy": (100, 100),
              "style_embedding_speedplus_mean.npy": (100,)}
    for name in names:
        a = np.load(tmp_path / "port" / name)
        assert a.shape == shapes[name] and a.dtype == np.float32


def test_missing_mat_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        convert_assets.main(["--src", str(tmp_path), "--out", str(tmp_path / "out")])
