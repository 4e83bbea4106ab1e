"""Host-side crop/resize — reference transforms.py:112-190 semantics (a copy
of ``speedplusbaseline_tpu/data/transforms.py``: the KRN and SPN crops).

Only the data-dependent RoI crop stays on the host (the crop box depends on
the per-sample bbox, so shapes are dynamic); photometric/geometric
augmentations run on-device (augment/photometric.py). Randomness uses a
numpy Generator passed in per sample — the worker-safety concern the
reference solves with torch RNG (transforms.py:31-36) is solved here by
seeding each sample from (seed, epoch, index).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
    from PIL import Image


def _resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize uint8/float HWC image to (H, W)."""
    h, w = out_hw
    if _HAS_CV2:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def crop_params(rng: np.random.Generator, bbox, img_w: int, img_h: int,
                is_train: bool):
    """Compute the square RoI crop box (RandomCrop semantics,
    transforms.py:112-164) without touching pixels.

    Returns (cxmin, cxmax, cymin, cymax) ints clamped to the frame.
    """
    xmin, xmax, ymin, ymax = [float(v) for v in bbox]
    w, h = xmax - xmin, ymax - ymin
    x, y = xmin + w / 2.0, ymin + h / 2.0

    roi_size = max(w, h)
    if is_train:
        roi_size = (1.0 + 0.5 * rng.random()) * roi_size
        fx = 0.2 * (rng.random() * 2.0 - 1.0) * roi_size
        fy = 0.2 * (rng.random() * 2.0 - 1.0) * roi_size
    else:
        roi_size = 1.2 * roi_size
        fx = fy = 0.0

    cxmin = max(0, int(x - roi_size / 2.0 + fx))
    cxmax = min(img_w, int(x + roi_size / 2.0 + fx))
    cymin = max(0, int(y - roi_size / 2.0 + fy))
    cymax = min(img_h, int(y + roi_size / 2.0 + fy))
    return cxmin, cxmax, cymin, cymax


def random_crop(rng: np.random.Generator, image: np.ndarray, bbox, keypts,
                out_shape: Tuple[int, int], is_train: bool):
    """Square RoI crop around the bbox (reference RandomCrop, transforms.py:112-164).

    Train: enlarge the tight RoI by U[1, 1.5] and shift by ±0.2*size.
    Test: fixed 1.2x enlargement, no shift. Keypoints are renormalized to
    [0, 1] w.r.t. the crop box; the (clamped) crop box is returned as the new
    bbox, exactly like the reference.

    Args:
        image: (H, W, 3) uint8. bbox: [xmin, xmax, ymin, ymax] pixels.
        keypts: (2, K) pixel coords (zeros when unlabeled).
    Returns:
        (crop uint8 (h, w, 3), bbox float32 (4,), keypts float32 (2, K))
    Crops stay uint8 so the H2D copy ships 4x fewer bytes; the [0,1]
    normalization (reference ToTensor, transforms.py:192-196) runs on the
    device in the train step (engine/steps.py images_to_float).
    """
    org_h, org_w = image.shape[:2]
    cxmin, cxmax, cymin, cymax = crop_params(rng, bbox, org_w, org_h, is_train)
    new_bbox = np.array([cxmin, cxmax, cymin, cymax], dtype=np.float32)

    keypts = np.asarray(keypts, dtype=np.float32).copy()
    keypts[0] = (keypts[0] - cxmin) / max(cxmax - cxmin, 1)
    keypts[1] = (keypts[1] - cymin) / max(cymax - cymin, 1)

    crop = image[cymin:cymax, cxmin:cxmax]
    crop = _resize(crop, out_shape)
    return np.ascontiguousarray(crop, dtype=np.uint8), new_bbox, keypts


def resize_crop(image: np.ndarray, bbox, out_shape: Tuple[int, int]):
    """SPN crop (reference ResizeCrop, transforms.py:166-190): clamp the bbox
    to the frame, crop and resize, and return the ORIGINAL (unclamped) bbox,
    which the SPN position solver takes. The crop stays uint8."""
    org_h, org_w = image.shape[:2]
    xmin, xmax, ymin, ymax = [float(v) for v in bbox]
    cxmin, cxmax = max(0, int(xmin)), min(org_w, int(xmax))
    cymin, cymax = max(0, int(ymin)), min(org_h, int(ymax))
    crop = _resize(image[cymin:cymax, cxmin:cxmax], out_shape)
    return (np.ascontiguousarray(crop, dtype=np.uint8),
            np.asarray(bbox, dtype=np.float32))
