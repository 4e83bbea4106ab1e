"""Label preprocessing: SPEED+ JSON -> per-model CSV (a copy of
``speedplusbaseline_tpu/data/preprocess.py`` on the port's projection;
reference preprocess.py).

Projects the 11 Tango keypoints through the true pose and the camera's
distortion, takes their tight box, and writes the CSV schema of
preprocess.py:104-114. For SPN, the ``num_neighbors`` nearest attitude
classes and their normalized weights 1 - theta/pi^2 (preprocess.py:124-157).

The numbers are the JAX package's: the projection runs in f32 on q and t
cast to f32 (JAX never enables x64), all labels of the file in one batched
call on ``device``; the box is written as ``str(np.float32)``, the keypoints
as Python floats of f32 values, q and t as the JSON's float64, the classes
and weights of ``get_quat_bins`` in float64.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..geometry.projection import project_keypoints
from ..io_utils.assets import load_attitude_classes, load_camera_intrinsics, load_tango_3d_keypoints


def get_quat_bins(q_pose: np.ndarray, q_class: np.ndarray, num_neighbors: int):
    """Nearest attitude classes and their weights for one quaternion
    (preprocess.py:124-157): angular distance 2 acos(|<q, q_c>|), weights
    1 - theta/pi^2, normalized."""
    dots = np.abs(q_class @ np.asarray(q_pose, dtype=np.float64))
    dots = np.minimum(dots, 1.0)
    angles = 2.0 * np.arccos(dots)
    order = np.argsort(angles, kind="stable")
    n_classes = order[:num_neighbors]
    n_angles = angles[n_classes]
    weights = 1.0 - n_angles / np.pi**2
    weights = weights / np.sum(weights)
    return n_classes, weights


def project_f32(q, t, camera_matrix, dist_coeffs, keypoints, device: torch.device) -> np.ndarray:
    """Pixel keypoints (..., 2, K) of poses q (..., 4), t (..., 3) in f32 on
    ``device``, as numpy f32."""
    args = [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in (q, t, camera_matrix, dist_coeffs, keypoints)]
    return project_keypoints(*args).cpu().numpy()


def json2csv(dataroot: str, dataname: str, domain: str, jsonfile: str, csvfile: str,
             model_name: str = "krn", num_keypoints: int = 11, num_neighbors: int = 5,
             keypts_3d_model: str = "", attitude_class: str = "", *,
             device: torch.device) -> str:
    """Write the CSV of a SPEED+ JSON label file; returns the CSV path."""
    if model_name not in ("krn", "spn"):
        raise ValueError("Model must be either krn or spn")

    root = os.path.join(dataroot, dataname)
    with open(os.path.join(root, domain, jsonfile)) as f:
        labels = json.load(f)

    camera_matrix, dist_coeffs = load_camera_intrinsics(os.path.join(root, "camera.json"))
    kpts3d = load_tango_3d_keypoints(keypts_3d_model)
    if model_name == "spn":
        att_classes = load_attitude_classes(attitude_class).astype(np.float64)

    qs = np.array([label["q_vbs2tango_true"] for label in labels], np.float64).reshape(-1, 4)
    ts = np.array([label["r_Vo2To_vbs_true"] for label in labels], np.float64).reshape(-1, 3)
    uvs = project_f32(qs, ts, camera_matrix, dist_coeffs, kpts3d, device)  # (N, 2, K)

    out = os.path.join(root, domain, csvfile)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as csv:
        for label, q, t, uv in zip(labels, qs, ts, uvs):
            filename = os.path.join(domain, "images", label["filename"])
            bbox = [uv[0].min(), uv[0].max(), uv[1].min(), uv[1].max()]
            row = [filename] + list(bbox) + q.tolist() + t.tolist()
            if model_name == "krn":
                row += uv.T.reshape(2 * num_keypoints).tolist()
            else:
                classes, weights = get_quat_bins(q, att_classes, num_neighbors)
                row += classes.tolist() + weights.tolist()
            csv.write(", ".join(str(e) for e in row) + "\n")
    return out
