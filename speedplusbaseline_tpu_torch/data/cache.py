"""Pre-decoded RoI cache (a copy of ``speedplusbaseline_tpu/data/cache.py``).

The SPEED+ frames are 1920x1200 JPEGs, but every training and eval crop lies
in a bounded neighbourhood of the target box (reference transforms.py:112-190:
RandomCrop enlarges the RoI by U[1, 1.5] and shifts it by up to 0.2 * roi, so
every possible crop is inside centre +- 1.05 * max(w, h); the eval crop uses
1.2 / 2 = 0.6, and SPN clamps the box itself). ``build_cache`` decodes each
frame once, offline, crops that union box, downscales it to at most
``cache_size`` px and re-encodes it, so the loader decodes about 10x fewer
pixels an image. The datasets (data/csv_dataset.py) map the box and the
keypoints into cache coordinates, crop from the small cached image, and map
the eval crop box back to original pixels for the pose solver.

The cv2 calls and their order are the JAX package's, so the cached JPEGs and
the manifest are its files byte for byte under one cv2 build. Pixels are
resampled twice and JPEG re-encoded, so a crop is close to, not equal to, the
full-frame path's. The cache never upsamples: scale = min(1, cache_size /
box side).

Layout: <cache_dir>/<dataname>/<domain>/images_cache/*.jpg and
``cache_manifest.csv`` with rows [relpath, cache_relpath, x0, y0, sx, sy].
"""
from __future__ import annotations

import csv
import logging
import math
import os
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

CACHE_MARGIN = 1.05  # covers U[1, 1.5] / 2 + 0.2 * 1.5 = 0.75 + 0.3 (transforms.py)
MANIFEST = "cache_manifest.csv"

# (cache_abspath, x0, y0, sx, sy)
CacheEntry = Tuple[str, float, float, float, float]


def union_box(bbox, img_w: int, img_h: int):
    """The union of every crop box RandomCrop / ResizeCrop can draw for
    ``bbox``, clamped to the frame: (x0, x1, y0, y1) ints."""
    xmin, xmax, ymin, ymax = [float(v) for v in bbox]
    w, h = xmax - xmin, ymax - ymin
    cx, cy = xmin + w / 2.0, ymin + h / 2.0
    half = CACHE_MARGIN * max(w, h)
    x0 = max(0, int(math.floor(cx - half)))
    x1 = min(img_w, int(math.ceil(cx + half)))
    y0 = max(0, int(math.floor(cy - half)))
    y1 = min(img_h, int(math.ceil(cy + half)))
    return x0, x1, y0, y1


def build_cache(dataroot: str, dataname: str, domain: str, csv_files,
                cache_dir: str, cache_size: int = 512, quality: int = 95) -> str:
    """Cache every image that ``csv_files`` name (preprocess CSVs: imagepath,
    xmin, xmax, ymin, ymax, ...), with the box of its first row. Returns the
    manifest's path."""
    import cv2
    import pandas as pd

    root = osp.join(dataroot, dataname)
    out_root = osp.join(cache_dir, dataname, domain)
    os.makedirs(osp.join(out_root, "images_cache"), exist_ok=True)

    seen = {}
    for f in csv_files:
        for _, row in pd.read_csv(f, header=None).iterrows():
            rel = str(row[0]).strip()
            if rel not in seen:
                seen[rel] = np.array(row[1:5], dtype=np.float32)

    rows = []
    for i, (rel, bbox) in enumerate(sorted(seen.items())):
        src = osp.join(root, rel)
        img = cv2.imread(src, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to decode {src}")
        ih, iw = img.shape[:2]
        x0, x1, y0, y1 = union_box(bbox, iw, ih)
        crop = img[y0:y1, x0:x1]
        bh, bw = crop.shape[:2]
        scale = min(1.0, cache_size / max(bw, bh))
        ow = max(1, int(round(bw * scale)))
        oh = max(1, int(round(bh * scale)))
        if scale < 1.0:
            crop = cv2.resize(crop, (ow, oh), interpolation=cv2.INTER_AREA)
        cache_rel = osp.join("images_cache", osp.splitext(osp.basename(rel))[0] + ".jpg")
        # BGR as cv2 decoded it: the loaders' imread turns it into RGB.
        cv2.imwrite(osp.join(out_root, cache_rel), crop, [cv2.IMWRITE_JPEG_QUALITY, quality])
        rows.append([rel, cache_rel, x0, y0, ow / bw, oh / bh])
        if (i + 1) % 500 == 0:
            logger.info("cached %d/%d images", i + 1, len(seen))

    manifest = osp.join(out_root, MANIFEST)
    with open(manifest, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    logger.info("cache built: %d images -> %s", len(rows), out_root)
    return manifest


def load_manifest(cache_dir: str, dataname: str,
                  domain: str) -> Optional[Dict[str, CacheEntry]]:
    """relpath -> (cache_abspath, x0, y0, sx, sy), or None without a manifest."""
    out_root = osp.join(cache_dir, dataname, domain)
    manifest = osp.join(out_root, MANIFEST)
    if not osp.exists(manifest):
        return None
    table: Dict[str, CacheEntry] = {}
    with open(manifest, newline="") as f:
        for rel, cache_rel, x0, y0, sx, sy in csv.reader(f):
            table[rel] = (osp.join(out_root, cache_rel),
                          float(x0), float(y0), float(sx), float(sy))
    return table


def to_cache_coords(entry: CacheEntry, bbox, keypts=None):
    """Map an original-pixel box [xmin, xmax, ymin, ymax] (and optional (2, K)
    keypoints) into the cached image's coordinates."""
    _, x0, y0, sx, sy = entry
    b = np.array([(bbox[0] - x0) * sx, (bbox[1] - x0) * sx,
                  (bbox[2] - y0) * sy, (bbox[3] - y0) * sy], dtype=np.float32)
    if keypts is None:
        return b, None
    k = np.asarray(keypts, dtype=np.float32).copy()
    k[0] = (k[0] - x0) * sx
    k[1] = (k[1] - y0) * sy
    return b, k


def to_original_coords(entry: CacheEntry, bbox):
    """The inverse of ``to_cache_coords`` for a crop box: the pose solver
    needs it in original camera pixels."""
    _, x0, y0, sx, sy = entry
    return np.array([x0 + bbox[0] / sx, x0 + bbox[1] / sx,
                     y0 + bbox[2] / sy, y0 + bbox[3] / sy], dtype=np.float32)
