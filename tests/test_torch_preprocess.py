"""Port label preprocessing and the fake SPEED+ generator against the JAX
package on the CPU: ``get_quat_bins``, ``json2csv`` and the preprocess CLI
(byte for byte), ``generate_fake_speedplus`` (labels and camera.json byte
for byte, images within one level), ``_render`` and
``generate_attitude_classes`` (identical).

The CSVs. JAX never enables x64, so its projection runs in f32, and XLA's
CPU code sums its dot and its norm by fused multiply-adds in index order;
the port's projection does the same (``geometry/_precision.py::fma``) and
reads bit for bit what JAX reads. The columns are then written alike. The
comparison still allows one f32 ulp in a box or keypoint field (the columns
the projection sets), counts such fields and prints the count; every other
column is byte-identical.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from speedplusbaseline_tpu.data import generate_attitude_classes as jax_generate_attitude_classes
from speedplusbaseline_tpu.data import generate_fake_speedplus as jax_generate_fake_speedplus
from speedplusbaseline_tpu.data import synthetic as jax_synthetic
from speedplusbaseline_tpu.data.preprocess import get_quat_bins as jax_get_quat_bins
from speedplusbaseline_tpu.data.preprocess import json2csv as jax_json2csv
from speedplusbaseline_tpu_torch import preprocess as preprocess_cli
from speedplusbaseline_tpu_torch.data import (generate_attitude_classes, generate_fake_speedplus,
                                              get_quat_bins, json2csv)
from speedplusbaseline_tpu_torch.data import synthetic
from speedplusbaseline_tpu_torch.io_utils import load_attitude_classes

torch.set_num_threads(1)

CPU = torch.device("cpu")
NUM_TRAIN, NUM_TEST = 24, 8
# (domain, JSON) of the README's preprocessing steps
SPLITS = (("synthetic", "train.json"), ("lightbox", "test.json"))


def test_get_quat_bins_matches_jax():
    q_class = load_attitude_classes().astype(np.float64)
    rs = np.random.RandomState(0)
    for _ in range(20):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        for n in (1, 5):
            classes, weights = get_quat_bins(q, q_class, n)
            ref_classes, ref_weights = jax_get_quat_bins(q, q_class, n)
            np.testing.assert_array_equal(classes, ref_classes)
            np.testing.assert_array_equal(weights, ref_weights)
    # a quaternion on a class: distance 0, that class first
    classes, weights = get_quat_bins(q_class[17], q_class, 5)
    assert classes[0] == 17 and weights[0] == weights.max()


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_fake"))
    jax_generate_fake_speedplus(root, num_train=NUM_TRAIN, num_test=NUM_TEST)
    return root


def same_csv(path, ref_path, model_name, num_keypoints=11):
    """Byte for byte, but for box and keypoint fields one f32 ulp apart;
    returns the count of those."""
    with open(path) as f:
        rows = f.read().splitlines()
    with open(ref_path) as f:
        ref_rows = f.read().splitlines()
    assert len(rows) == len(ref_rows) > 0
    projected = set(range(1, 5))
    if model_name == "krn":
        projected |= set(range(12, 12 + 2 * num_keypoints))
    ulp_fields = 0
    for row, ref in zip(rows, ref_rows):
        if row == ref:
            continue
        fields, ref_fields = row.split(", "), ref.split(", ")
        assert len(fields) == len(ref_fields)
        for i, (a, b) in enumerate(zip(fields, ref_fields)):
            if a == b:
                continue
            assert i in projected, f"column {i}: {a} != {b}"
            a32, b32 = np.float32(a), np.float32(b)
            assert a32 in (np.nextafter(b32, np.float32(np.inf)),
                           np.nextafter(b32, np.float32(-np.inf))), f"column {i}: {a} != {b}"
            ulp_fields += 1
    print(f"{os.path.basename(path)}: {ulp_fields} box/keypoint fields one f32 ulp apart")
    return ulp_fields


@pytest.mark.parametrize("model_name", ["krn", "spn"])
@pytest.mark.parametrize("domain,jsonfile", SPLITS)
def test_json2csv_matches_jax(jax_root, model_name, domain, jsonfile):
    csv = f"splits_{model_name}/{os.path.splitext(jsonfile)[0]}"
    ref = jax_json2csv(jax_root, "speedplus", domain, jsonfile, csv + "_jax.csv",
                       model_name=model_name)
    out = json2csv(jax_root, "speedplus", domain, jsonfile, csv + "_port.csv",
                   model_name=model_name, device=CPU)
    same_csv(out, ref, model_name)


@pytest.mark.parametrize("model_name", ["krn", "spn"])
def test_preprocess_cli_writes_the_root_clis_file(jax_root, model_name, capsys):
    import preprocess as jax_preprocess_cli

    common = ["--dataroot", jax_root, "--domain", "lightbox", "--jsonfile", "test.json",
              "--model_name", model_name]
    jax_preprocess_cli.main(common + ["--csvfile", f"splits_{model_name}/cli_jax.csv"])
    out = preprocess_cli.main(common + ["--csvfile", f"splits_{model_name}/cli_port.csv",
                                        "--no_cuda"])
    assert f"Wrote {out}" in capsys.readouterr().out
    same_csv(out, out.replace("cli_port", "cli_jax"), model_name)


def test_generator_writes_jax_labels_and_images(jax_root, tmp_path):
    root = generate_fake_speedplus(str(tmp_path), num_train=NUM_TRAIN, num_test=NUM_TEST,
                                   device=CPU)
    ref = os.path.join(jax_root, "speedplus")
    assert filecmp.cmp(os.path.join(root, "camera.json"), os.path.join(ref, "camera.json"),
                       shallow=False)
    from PIL import Image

    for domain, _ in SPLITS:
        for split in ("train", "test"):
            assert filecmp.cmp(os.path.join(root, domain, f"{split}.json"),
                               os.path.join(ref, domain, f"{split}.json"), shallow=False)
        names = sorted(os.listdir(os.path.join(ref, domain, "images")))
        assert names == sorted(os.listdir(os.path.join(root, domain, "images")))
        assert len(names) == NUM_TRAIN + NUM_TEST
        for name in names:
            a, b = (np.asarray(Image.open(os.path.join(r, domain, "images", name)), np.int16)
                    for r in (root, ref))
            assert a.shape == (200, 320, 3)
            assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("style", ["blobs", "rings", "blobs_bright"])
def test_render_matches_jax(style):
    uv = np.random.RandomState(1).uniform(10, 90, (2, 11)).astype(np.float32)
    ours = synthetic._render(120, 100, uv, np.random.RandomState(2), style=style)
    ref = jax_synthetic._render(120, 100, uv, np.random.RandomState(2), style=style)
    assert ours.dtype == np.uint8 and ours.shape == (100, 120, 3)
    np.testing.assert_array_equal(ours, ref)
    assert synthetic.DOMAIN_STYLES == jax_synthetic.DOMAIN_STYLES
    assert synthetic._default_camera(640, 400) == jax_synthetic._default_camera(640, 400)


def test_generate_attitude_classes_matches_jax():
    ours = generate_attitude_classes(40, seed=3, pool=5000)
    ref = jax_generate_attitude_classes(40, seed=3, pool=5000)
    assert ours.dtype == np.float32 and ours.shape == (40, 4)
    np.testing.assert_array_equal(ours, ref)
