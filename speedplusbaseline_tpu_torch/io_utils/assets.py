"""Asset locations and loaders (counterpart of ``speedplusbaseline_tpu/
io_utils/assets.py``; reference src/utils/utils.py:273-285): the repo's
``assets/`` directory, overridable through ``SPEEDPLUS_ASSETS_DIR``, and the
eval assets. Each loader takes the reference's ``.mat`` file (through
scipy, so ``--keypts_3d_model`` / ``--attitude_class`` keep their meaning)
and falls back to the native ``.npy`` in ``assets/`` when the configured
path is missing. The style-embedding and Ghiasi loaders live in
``augment/styleaug.py``."""
from __future__ import annotations

import json
import os

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_assets_dir() -> str:
    return os.environ.get("SPEEDPLUS_ASSETS_DIR") or os.path.join(_REPO_ROOT, "assets")


def _resolve(path: str, native_name: str) -> str:
    """``path`` if it exists, else the native asset."""
    if os.path.exists(path):
        return path
    native = os.path.join(default_assets_dir(), native_name)
    if os.path.exists(native):
        return native
    raise FileNotFoundError(f"asset not found: {path} (no fallback {native})")


def read_tango_mat(path: str) -> np.ndarray:
    """The reference's ``tangoPoints.mat``: (3, 11) ``tango3Dpoints`` as an
    (11, 3) float32 view (its transpose, not a copy)."""
    from scipy.io import loadmat

    return np.asarray(loadmat(path)["tango3Dpoints"], dtype=np.float32).T


def read_attitude_mat(path: str) -> np.ndarray:
    """The reference's ``attitudeClasses.mat``: ``qClass`` as float32."""
    from scipy.io import loadmat

    return np.asarray(loadmat(path)["qClass"], dtype=np.float32)


def load_tango_3d_keypoints(path: str = "") -> np.ndarray:
    """(11, 3) float32 Tango keypoints (utils.py:273-277)."""
    path = _resolve(path, "tango_points.npy")
    if path.endswith(".mat"):
        return read_tango_mat(path)
    return np.load(path).astype(np.float32)


def load_attitude_classes(path: str = "") -> np.ndarray:
    """(num_classes, 4) scalar-first unit quaternion bins (train.py:119)."""
    path = _resolve(path, "attitude_classes.npy")
    if path.endswith(".mat"):
        return read_attitude_mat(path)
    return np.load(path).astype(np.float32)


def load_camera_intrinsics(camera_json: str):
    """(cameraMatrix (3, 3), distCoeffs (5,)) float32 from camera.json
    (utils.py:279-285)."""
    with open(camera_json) as f:
        cam = json.load(f)
    return (np.array(cam["cameraMatrix"], dtype=np.float32),
            np.array(cam["distCoeffs"], dtype=np.float32).reshape(-1))
