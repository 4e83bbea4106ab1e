"""The port's from-disk data path against the JAX package on the CPU: the RoI
cache (``data/cache.py`` and the ``cache_dataset`` CLI), the native decode
core (``csrc/speedloader.cpp`` through ``native/loader.py``) and the dataset
branches that use them.

A small dataset is made by the port's generator and labelled by its
preprocess CLI; each package's cache CLI caches it at ``cache_size`` 128. All
comparisons are exact: both caches come from the same cv2 calls in one
process, and both cores from one source built with the same flags on this
machine, so the manifests, the cached JPEGs, the cores' pixels and every
dataset sample are equal bit for bit.
"""
import filecmp
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.data import KRNDataset as JaxKRNDataset
from speedplusbaseline_tpu.data import SPNDataset as JaxSPNDataset
from speedplusbaseline_tpu.data import cache as jax_cache
from speedplusbaseline_tpu.native import loader as jax_native
from speedplusbaseline_tpu_torch import cache_dataset, train
from speedplusbaseline_tpu_torch import preprocess as preprocess_cli
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.data import KRNDataset, SPNDataset, cache, generate_fake_speedplus
from speedplusbaseline_tpu_torch.native import loader as native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_TRAIN, NUM_TEST, CACHE_SIZE, SIDE = 8, 4, 128, 48
# (domain, JSON, CSV name) of the README's preprocessing steps
SPLITS = (("synthetic", "train.json", "train.csv"), ("lightbox", "test.json", "lightbox.csv"))
MODES = {"cache": dict(cache=True, native=False), "native": dict(cache=False, native=True),
         "cache+native": dict(cache=True, native=True)}


def _jax_cache_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_cache_dataset", os.path.join(REPO, "scripts", "cache_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def cache_args(root, domain, cache_dir):
    """Cache flags for both models' CSVs of ``domain``."""
    csv = {d: c for d, _, c in SPLITS}[domain]
    return ["--dataroot", root, "--domain", domain, "--csv", f"splits_krn/{csv}",
            "--csv", f"splits_spn/{csv}", "--cache_dir", cache_dir,
            "--cache_size", str(CACHE_SIZE)]


@pytest.fixture(scope="module", autouse=True)
def jax_core(tmp_path_factory):
    """The JAX binding on its core built by its own Makefile and source, in
    a directory of this module's: another test process may be running
    ``make`` in the JAX package's directory, which writes its library in
    place, so that file can be half-written while this process loads it."""
    import shutil

    src = os.path.join(REPO, "speedplusbaseline_tpu", "native")
    out = tmp_path_factory.mktemp("jax_native")
    for f in ("Makefile", "speedloader.cpp"):
        shutil.copy(os.path.join(src, f), out / f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(out / "libspeedloader.so"))
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.native_available()
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{root, port cache dir, JAX cache dir}: the port's dataset, its KRN and
    SPN CSVs, and each package's cache of both domains."""
    root = str(tmp_path_factory.mktemp("torch_data_path"))
    generate_fake_speedplus(root, num_train=NUM_TRAIN, num_test=NUM_TEST,
                            device=torch.device("cpu"))
    for model in ("krn", "spn"):
        for domain, jsonfile, csv in SPLITS:
            preprocess_cli.main(["--dataroot", root, "--domain", domain, "--jsonfile", jsonfile,
                                 "--csvfile", f"splits_{model}/{csv}", "--model_name", model,
                                 "--no_cuda"])
    ours, ref = os.path.join(root, "cache_port"), os.path.join(root, "cache_jax")
    jax_cli = _jax_cache_cli()
    for domain, _, _ in SPLITS:
        cache_dataset.main(cache_args(root, domain, ours))
        jax_cli(cache_args(root, domain, ref))
    return {"root": root, "cache": ours, "jax_cache": ref}


def cfgs(data, model_name="krn", cache=False, native=False, **kw):
    """(port cfg, JAX cfg) over ``data``, each with its own package's cache."""
    base = dict(dataroot=data["root"], model_name=model_name, input_shape=(SIDE, SIDE),
                use_native_loader=native, **kw)
    return (default_cfg(cache_dir=data["cache"] if cache else "", **base),
            jax_default_cfg(cache_dir=data["jax_cache"] if cache else "", **base))


def assert_same_sample(got, ref, what):
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")


def test_cache_cli_files_are_jax_byte_for_byte(data):
    """Each domain's manifest and every cached JPEG; the cache both keeps and
    downscales crops at this size."""
    scales = []
    for domain, _, _ in SPLITS:
        ours = os.path.join(data["cache"], "speedplus", domain)
        ref = os.path.join(data["jax_cache"], "speedplus", domain)
        assert filecmp.cmp(os.path.join(ours, cache.MANIFEST),
                           os.path.join(ref, cache.MANIFEST), shallow=False)
        names = sorted(os.listdir(os.path.join(ref, "images_cache")))
        assert names == sorted(os.listdir(os.path.join(ours, "images_cache")))
        assert len(names) == (NUM_TRAIN if domain == "synthetic" else NUM_TEST)
        for n in names:
            assert filecmp.cmp(os.path.join(ours, "images_cache", n),
                               os.path.join(ref, "images_cache", n), shallow=False), n
        scales += [e[3] for e in cache.load_manifest(data["cache"], "speedplus",
                                                     domain).values()]
    assert min(scales) < 1.0 and max(scales) == 1.0


def test_cache_cli_prints_its_manifest(data, tmp_path, capsys):
    out = cache_dataset.main(cache_args(data["root"], "lightbox", str(tmp_path)))
    assert capsys.readouterr().out.strip() == f"manifest: {out}"
    assert filecmp.cmp(out, os.path.join(data["cache"], "speedplus", "lightbox",
                                         cache.MANIFEST), shallow=False)


def test_cache_coordinates_match_jax():
    """union_box, to_cache_coords (with keypoints) and to_original_coords
    on random boxes, some reaching past the frame."""
    rs = np.random.RandomState(0)
    for _ in range(200):
        x0, y0 = rs.uniform(-50, 1900), rs.uniform(-50, 1180)
        bbox = np.array([x0, x0 + rs.uniform(1, 600), y0, y0 + rs.uniform(1, 600)], np.float32)
        got = cache.union_box(bbox, 1920, 1200)
        assert got == jax_cache.union_box(bbox, 1920, 1200)
        entry = ("x.jpg", float(got[0]), float(got[2]), rs.uniform(0.1, 1), rs.uniform(0.1, 1))
        kp = rs.uniform(0, 1920, (2, 11)).astype(np.float32)
        b, k = cache.to_cache_coords(entry, bbox, kp)
        rb, rk = jax_cache.to_cache_coords(entry, bbox, kp)
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(k, rk)
        np.testing.assert_array_equal(cache.to_cache_coords(entry, bbox)[0], rb)
        np.testing.assert_array_equal(cache.to_original_coords(entry, b),
                                      jax_cache.to_original_coords(entry, b))


@pytest.mark.parametrize("mode", list(MODES))
def test_krn_samples_match_jax(data, mode):
    """Train (two epochs), eval and the unlabelled DANN target stream."""
    cfg, jcfg = cfgs(data, **MODES[mode])
    for is_train, is_source, labels, epochs in ((True, True, True, (0, 3)),
                                                (False, False, True, (0,)),
                                                (True, False, False, (0, 3))):
        ours = KRNDataset(cfg, is_train, is_source, labels)
        ref = JaxKRNDataset(jcfg, is_train, is_source, labels)
        assert ref.use_native == MODES[mode]["native"] == ours.use_native
        assert (ref.cache is not None) == MODES[mode]["cache"] == (ours.cache is not None)
        for epoch in epochs:
            for i in range(len(ref)):
                assert_same_sample(ours.__getitem__(i, epoch=epoch),
                                   ref.__getitem__(i, epoch=epoch),
                                   f"{mode} train={is_train} source={is_source} {epoch}/{i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_spn_samples_match_jax(data, mode):
    cfg, jcfg = cfgs(data, "spn", **MODES[mode])
    for is_train in (True, False):
        ours, ref = SPNDataset(cfg, is_train, is_train), JaxSPNDataset(jcfg, is_train, is_train)
        assert ref.use_native == MODES[mode]["native"] == ours.use_native
        assert (ref.cache is not None) == MODES[mode]["cache"] == (ours.cache is not None)
        for i in range(len(ref)):
            assert_same_sample(ours[i], ref[i], f"{mode} train={is_train} {i}")


def test_cached_eval_box_is_in_original_pixels(data):
    """The cached eval sample's crop box is the full-frame one within 2 px
    (original pixels), its crop within 0.02 of full scale on average, and
    SPN's box is the CSV's own."""
    for native in (False, True):
        full = KRNDataset(cfgs(data, native=native)[0], False, False)
        cached = KRNDataset(cfgs(data, cache=True, native=native)[0], False, False)
        for i in range(len(full)):
            a, b = full[i], cached[i]
            assert np.abs(a["bbox"] - b["bbox"]).max() <= 2.0, (a["bbox"], b["bbox"])
            diff = np.abs(a["image"].astype(np.float32) - b["image"].astype(np.float32))
            assert diff.mean() / 255 < 0.02
            np.testing.assert_array_equal(a["q_gt"], b["q_gt"])
    spn = SPNDataset(cfgs(data, "spn", cache=True)[0], False, False)
    np.testing.assert_array_equal(spn[0]["bbox"], np.array(spn.csv.iloc[0][1:5], np.float32))


def test_missing_manifest_warns_and_decodes_full_frames(data, tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        ds = KRNDataset(default_cfg(dataroot=data["root"], input_shape=(SIDE, SIDE),
                                    cache_dir=str(tmp_path)))
    assert ds.cache is None and "no manifest" in caplog.text
    full = KRNDataset(default_cfg(dataroot=data["root"], input_shape=(SIDE, SIDE)))
    assert_same_sample(ds.__getitem__(1, epoch=2), full.__getitem__(1, epoch=2), "fallback")


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """One 1920x1200 q90 JPEG, the SPEED+ frame size."""
    import cv2

    path = str(tmp_path_factory.mktemp("frame") / "frame.jpg")
    small = np.random.RandomState(3).randint(0, 256, (30, 48, 3), dtype=np.uint8)
    cv2.imwrite(path, cv2.resize(small, (1920, 1200), interpolation=cv2.INTER_CUBIC),
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    return path


# (crop box, out (h, w)): the full frame at full size; a small crop (libjpeg
# at scale 1); a crop large enough that libjpeg decodes at scale 1/4.
CROPS = {"full_frame": (None, (1200, 1920)), "small_crop": ((700.5, 400.25, 150, 90), (224, 224)),
         "dct_downscaled": ((100, 50, 1700, 1100), (224, 224))}


@pytest.mark.parametrize("crop", list(CROPS))
def test_native_core_matches_the_jax_binding(frame, crop):
    box, out_hw = CROPS[crop]
    assert native.image_size(frame) == jax_native.image_size(frame) == (1920, 1200)
    got = native.decode_crop_resize(frame, box, out_hw)
    assert got.shape == (*out_hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_native.decode_crop_resize(frame, box, out_hw))
    assert native.load()._name != jax_native._lib._name


def test_native_core_build_failure_raises(data, tmp_path, monkeypatch):
    """--use_native_loader with a compiler that is missing, then with one
    that fails: RuntimeError with the compiler's message (the JAX package
    would fall back to cv2)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    cfg = default_cfg(dataroot=data["root"], use_native_loader=True)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        KRNDataset(cfg)
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\n[ \"$1\" = --version ] && { echo fake 1.0; exit 0; }\n"
                    "echo 'speedloader.cpp:1: error: the fake compiler refuses' >&2; exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="the fake compiler refuses"):
        KRNDataset(cfg)
    assert not native.native_available() and native._lib is None


def test_train_and_test_clis_from_the_cache_through_the_native_core(data, tmp_path):
    """Two KRN steps and a validation from the cache through the core; the
    test CLI with the same flags gives the validation's numbers."""
    common = ["--dataroot", data["root"], "--input_shape", "32", "32", "--no_cuda",
              "--num_workers", "2", "--eval_batch_size", "4", "--cache_dir", data["cache"],
              "--use_native_loader"]
    records = train.main(common + ["--savedir", str(tmp_path / "s"), "--logdir",
                                   str(tmp_path / "l"), "--batch_size", "4",
                                   "--max_epochs", "1", "--test_epoch", "1"])
    assert len(records) == 2 and all(np.isfinite(r["loss_x"] + r["loss_y"]) for r in records)
    meters = test_cli.main(common + ["--logdir", str(tmp_path / "t"), "--pretrained",
                                     str(tmp_path / "s" / "model_best.pt")])
    for name in ("err_q.txt", "err_t.txt", "speed_raw.txt"):
        with open(tmp_path / "l" / name) as f, open(tmp_path / "t" / name) as g:
            assert f.read() == g.read() and len(meters) == 4
