"""Host input-path throughput on SPEED+-sized JPEGs (the counterpart of the
JAX package's ``scripts/bench_host_loader.py``).

Writes ``num_images`` synthetic 1920x1200 JPEGs (default 96), then times
images a second at the KRN training crop (224x224) through

  * the native fused decode + crop + resize core (``native/``), where this
    host can build it (null otherwise);
  * cv2 decode + ``random_crop``, the dataset's path without the core;
  * the same over the pre-decoded RoI cache (``data/cache.py``), whose
    one-time build is left out of the rate;
  * the whole DataLoader (``data/loader.py``: threads, batch assembly,
    pinned memory, the copy to the device), batch 16, max(2, cores) workers.

The first three are one worker's rate; the DataLoader's is the whole pool's.

    python -m speedplusbaseline_tpu_torch.perf.bench_host_loader [num_images] [--no_cuda]

Prints one JSON line with the JAX keys (``native_img_s_per_worker``,
``python_img_s_per_worker``, ``cached_img_s_per_worker``,
``dataloader_img_s``, ``host_cores``) and ``card``. Without ``--no_cuda``
the DataLoader copies to the card (and raises with no GPU).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import common
from ..config import default_cfg
from ..data.cache import build_cache, load_manifest, to_cache_coords
from ..data.csv_dataset import _imread
from ..data.loader import make_dataloader
from ..data.transforms import random_crop
from ..native import decode_crop_resize, native_available

W, H = 1920, 1200
CROP = (224, 224)


def make_jpegs(root: str, n: int):
    """``n`` JPEGs (quality 90) of one seeded noise frame, each rolled
    sideways by 17 px more than the last; their paths."""
    from PIL import Image

    rs = np.random.RandomState(0)
    paths = []
    base = rs.randint(0, 255, size=(H, W, 3), dtype=np.uint8)
    for i in range(n):
        img = np.roll(base, i * 17, axis=1)
        p = osp.join(root, f"img{i:04d}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def rand_boxes(rs: np.random.RandomState, n: int):
    """``n`` square boxes (x, y, size, size) of 300-899 px inside the frame."""
    boxes = []
    for _ in range(n):
        size = rs.randint(300, 900)
        x = rs.randint(0, W - size)
        y = rs.randint(0, H - size)
        boxes.append((float(x), float(y), float(size), float(size)))
    return boxes


def bench_native(paths, boxes) -> Optional[float]:
    if not native_available():
        return None
    for p, b in zip(paths[:4], boxes[:4]):  # warmup
        decode_crop_resize(p, b, CROP)
    t0 = time.perf_counter()
    for p, b in zip(paths, boxes):
        out = decode_crop_resize(p, b, CROP)
    dt = time.perf_counter() - t0
    if out.shape != (*CROP, 3):
        raise RuntimeError(f"the native core returned {out.shape}")
    return len(paths) / dt


def bench_python(paths, boxes) -> float:
    rng = np.random.Generator(np.random.Philox(7))
    kp = np.zeros((2, 11), np.float32)
    for p in paths[:4]:
        _imread(p)
    t0 = time.perf_counter()
    for p, (x, y, s, _) in zip(paths, boxes):
        img = _imread(p)
        bbox = np.array([x, x + s, y, y + s], np.float32)
        random_crop(rng, img, bbox, kp, CROP, True)
    dt = time.perf_counter() - t0
    return len(paths) / dt


def bench_python_cached(tmp: str, paths, boxes) -> float:
    """One worker's rate through the RoI cache: the cache is built first
    (left out of the rate), then each cached image is decoded and cropped as
    the dataset does."""
    dataroot = osp.join(tmp, "speedplus")
    rels, rows = [], []
    for p, (x, y, s, _) in zip(paths, boxes):
        rel = osp.relpath(p, dataroot)
        rels.append(rel)
        rows.append(",".join(str(v) for v in [rel, x, x + s, y, y + s] + [0.0] * 29))
    csv_path = osp.join(tmp, "cache_bench.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows))
    cache_dir = osp.join(tmp, "roi_cache")
    build_cache(tmp, "speedplus", "synthetic", [csv_path], cache_dir)
    manifest = load_manifest(cache_dir, "speedplus", "synthetic")

    rng = np.random.Generator(np.random.Philox(7))
    kp = np.zeros((2, 11), np.float32)
    for rel in rels[:4]:  # warmup
        _imread(manifest[rel][0])
    t0 = time.perf_counter()
    for rel, (x, y, s, _) in zip(rels, boxes):
        entry = manifest[rel]
        img = _imread(entry[0])
        bbox = np.array([x, x + s, y, y + s], np.float32)
        b, k = to_cache_coords(entry, bbox, kp)
        random_crop(rng, img, b, k, CROP, True)
    dt = time.perf_counter() - t0
    return len(paths) / dt


def bench_dataloader(tmp: str, paths, boxes, use_native: bool, dev: torch.device) -> float:
    """The whole DataLoader over a generated KRN CSV, one epoch, each batch
    copied to ``dev`` (synchronized at the end)."""
    dataroot = osp.join(tmp, "speedplus")
    domain = osp.join(dataroot, "synthetic")
    os.makedirs(osp.join(domain, "splits_krn"), exist_ok=True)
    rows = []
    rs = np.random.RandomState(1)
    for p, (x, y, s, _) in zip(paths, boxes):
        rel = osp.relpath(p, dataroot)
        vals = [rel, x, x + s, y, y + s] + list(rs.rand(7)) + list(rs.rand(22) * s)
        rows.append(",".join(str(v) for v in vals))
    with open(osp.join(domain, "splits_krn", "train.csv"), "w") as f:
        f.write("\n".join(rows))

    cfg = default_cfg(dataroot=tmp, input_shape=CROP, batch_size=16,
                      num_workers=common.workers(), use_native_loader=use_native)
    loader = make_dataloader(cfg, dev, is_train=True, is_source=True)
    n = 0
    t0 = time.perf_counter()
    for batch in loader:
        n += batch["image"].shape[0]
    common.sync(dev)
    dt = time.perf_counter() - t0
    return n / dt


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("num_images", type=int, nargs="?", default=96)
    ap.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = common.device(args.no_cuda)
    rs = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = osp.join(tmp, "speedplus", "synthetic", "images")
        os.makedirs(img_dir, exist_ok=True)
        paths = make_jpegs(img_dir, args.num_images)
        boxes = rand_boxes(rs, args.num_images)

        native = bench_native(paths, boxes)
        python = bench_python(paths, boxes)
        cached = bench_python_cached(tmp, paths, boxes)
        dl = bench_dataloader(tmp, paths, boxes, native is not None, dev)

    return common.emit({"native_img_s_per_worker": native,
                        "python_img_s_per_worker": python,
                        "cached_img_s_per_worker": cached,
                        "dataloader_img_s": dl,
                        "host_cores": os.cpu_count()}, dev)


if __name__ == "__main__":
    main()
