"""Synthetic SPEED+-format dataset generator (a copy of
``speedplusbaseline_tpu/data/synthetic.py`` on the port's projection), for
tests, chip checks and benchmarks.

Writes a miniature dataset with the on-disk layout the reference consumes:

  root/
    camera.json                      (cameraMatrix, distCoeffs)
    {domain}/images/imgNNNNNN.jpg
    {domain}/{split}.json            (q_vbs2tango_true, r_Vo2To_vbs_true)

Images hold a marker of its own hue at each projected keypoint, so KRN
training on them is learnable. The domains carry a domain gap
(``DOMAIN_STYLES``): synthetic renders gaussian blobs on dim noise,
lightbox/sunlamp ring markers on a bright striped background with optical
blur, the substrate for DANN adaptation. The preprocess CLI turns the JSONs
into CSVs. Every random number comes from one ``np.random.RandomState(seed)``
in the JAX package's order, and the projection runs in f32 as JAX's does,
so both write the same labels.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from ..io_utils.assets import load_tango_3d_keypoints
from .preprocess import project_f32


def _default_camera(width: int, height: int):
    f = 0.6 * width  # short focal so a ~1m target at 3-6m fits the tiny frame
    camera_matrix = [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]]
    dist = [-0.1, 0.03, -5e-4, -5e-4, 0.0]
    return camera_matrix, dist


def _render(width, height, uv, rs, style="blobs"):
    """A frame of uint8 (height, width, 3) with one marker of a hue of its
    own per keypoint ``uv`` (2, K), on a background of ``style``:

    - ``"blobs"`` (synthetic, the source domain): gaussian blobs on dim
      uniform noise;
    - ``"rings"`` (lightbox/sunlamp, the target domains): rings of the same
      hues on a brighter striped background, with a mild optical blur; the
      pose-to-pixel mapping is unchanged, the low-level statistics are not,
      a gap the photometric augs do not cover;
    - ``"blobs_bright"``: the source's blobs in the rings' photometric
      environment, a purely photometric gap.

    Unique hues make each keypoint identifiable, as the real target's
    asymmetric texture does. Draws its noise from ``rs``.
    """
    import colorsys

    bright_bg = style in ("rings", "blobs_bright")
    ring_markers = style == "rings"
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    if bright_bg:
        stripes = 0.5 + 0.5 * np.sin(
            2.0 * np.pi * (3.0 * xx / width + 2.0 * yy / height))
        img = (35.0 + 45.0 * stripes)[..., None] + (
            rs.rand(height, width, 3) * 25).astype(np.float32)
        img = img.astype(np.float32)
    else:
        img = (rs.rand(height, width, 3) * 40).astype(np.float32)
    k = uv.shape[1]
    for i in range(k):
        u, v = uv[0, i], uv[1, i]
        color = np.array(colorsys.hsv_to_rgb(i / max(k, 1), 1.0, 1.0),
                         dtype=np.float32)
        if ring_markers:
            r = np.sqrt((xx - u) ** 2 + (yy - v) ** 2)
            marker = np.exp(-((r - 4.0) ** 2) / (2.0 * 1.2**2))
        else:
            marker = np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2.0 * 2.5**2))
        img += marker[..., None] * (0.35 + 0.65 * color[None, None]) * 255.0
    img = np.clip(img, 0, 255)
    if bright_bg:
        from scipy.ndimage import gaussian_filter

        img = gaussian_filter(img, sigma=(1.0, 1.0, 0.0))
    return img.astype(np.uint8)


#: Default per-domain render styles: synthetic is the clean source domain,
#: the HIL test domains (lightbox/sunlamp) carry the domain gap.
DOMAIN_STYLES = {"synthetic": "blobs", "lightbox": "rings", "sunlamp": "rings"}


def generate_fake_speedplus(
    root: str,
    num_train: int = 24,
    num_test: int = 8,
    width: int = 320,
    height: int = 200,
    domains: Sequence[str] = ("synthetic", "lightbox"),
    seed: int = 0,
    domain_styles=None,
    *,
    device: torch.device,
) -> str:
    """Create the dataset under ``root``/speedplus and return that path;
    the keypoints are projected on ``device``."""
    from PIL import Image

    dataroot = os.path.join(root, "speedplus")
    os.makedirs(dataroot, exist_ok=True)
    camera_matrix, dist = _default_camera(width, height)
    with open(os.path.join(dataroot, "camera.json"), "w") as f:
        json.dump({"cameraMatrix": camera_matrix, "distCoeffs": dist}, f)

    kpts3d = load_tango_3d_keypoints()
    K = np.array(camera_matrix, dtype=np.float64)
    D = np.array(dist, dtype=np.float64)

    styles = dict(DOMAIN_STYLES)
    if domain_styles:
        styles.update(domain_styles)

    rs = np.random.RandomState(seed)
    for domain in domains:
        style = styles.get(domain, "blobs")
        img_dir = os.path.join(dataroot, domain, "images")
        os.makedirs(img_dir, exist_ok=True)
        for split, n in (("train", num_train), ("test", num_test)):
            labels = []
            for i in range(n):
                # Resample until the whole target is inside the frame: a
                # truncated view leaves some keypoint markers unrendered,
                # which is unlearnable label noise.
                for _ in range(100):
                    q = rs.randn(4)
                    q /= np.linalg.norm(q)
                    if q[0] < 0:
                        q = -q
                    t = np.array([rs.uniform(-0.3, 0.3), rs.uniform(-0.2, 0.2),
                                  rs.uniform(3.0, 6.0)])
                    uv = project_f32(q, t, K, D, kpts3d, device)
                    if (uv[0].min() >= 8 and uv[0].max() <= width - 8
                            and uv[1].min() >= 8 and uv[1].max() <= height - 8):
                        break
                else:
                    t[2] += 4.0  # pathological camera geometry: back way off
                    uv = project_f32(q, t, K, D, kpts3d, device)
                fname = f"{domain}_{split}_img{i:06d}.jpg"
                img = _render(width, height, uv, rs, style=style)
                Image.fromarray(img).save(
                    os.path.join(img_dir, fname), quality=92)
                labels.append({
                    "filename": fname,
                    "q_vbs2tango_true": [float(v) for v in q],
                    "r_Vo2To_vbs_true": [float(v) for v in t],
                })
            with open(os.path.join(dataroot, domain, f"{split}.json"), "w") as f:
                json.dump(labels, f)
    return dataroot


def generate_attitude_classes(num_classes: int, seed: int = 0,
                              pool: int = 100_000) -> np.ndarray:
    """Farthest-point-sampled unit-quaternion attitude bins, scalar-first,
    with q and -q identified (SO(3), not S^3): a uniform stand-in for the
    reference's 5000-bin attitudeClasses.mat at class counts a small fake
    dataset can cover. FPS over a seeded uniform pool gives a near-optimal
    covering radius."""
    rs = np.random.RandomState(seed)
    q = rs.randn(pool, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1.0
    picked = np.empty((num_classes, 4), np.float64)
    picked[0] = q[0]
    # 1 - |q·p| is monotone in geodesic distance and identifies q with -q.
    mind = 1.0 - np.abs(q @ picked[0])
    for i in range(1, num_classes):
        picked[i] = q[int(np.argmax(mind))]
        np.minimum(mind, 1.0 - np.abs(q @ picked[i]), out=mind)
    return picked.astype(np.float32)
