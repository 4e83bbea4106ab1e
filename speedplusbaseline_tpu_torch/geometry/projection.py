"""Pinhole projection with the OpenCV 5-coefficient distortion model
(counterpart of ``speedplusbaseline_tpu/geometry/projection.py``; reference
src/utils/utils.py:201-235 and the undistortion inside cv2.solvePnP).
Batched on leading dimensions."""
from __future__ import annotations

import torch

from ._precision import f32_math, fma
from .quaternion import quat2dcm


@f32_math()
def distort_normalized(x0, y0, dist_coeffs):
    """Apply the OpenCV (k1, k2, p1, p2, k3) distortion to normalized
    coordinates (reference utils.py:225-229)."""
    k1, k2, p1, p2, k3 = (dist_coeffs[..., i] for i in range(5))
    r2 = x0 * x0 + y0 * y0
    cdist = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x = x0 * cdist + p1 * 2.0 * x0 * y0 + p2 * (r2 + 2.0 * x0 * x0)
    y = y0 * cdist + p1 * (r2 + 2.0 * y0 * y0) + p2 * 2.0 * x0 * y0
    return x, y


@f32_math()
def undistort_points(points_2d, camera_matrix, dist_coeffs, num_iters: int = 10):
    """Pixel coordinates (..., 2) -> undistorted normalized coordinates
    (..., 2): the fixed-point iteration of cv2.undistortPoints, with a fixed
    iteration count."""
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    xd = (points_2d[..., 0] - cx) / fx
    yd = (points_2d[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = (dist_coeffs[..., i] for i in range(5))
    x, y = xd, yd
    for _ in range(num_iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return torch.stack([x, y], -1)


def _pixels(xyz, camera_matrix, dist_coeffs):
    """Camera-frame points (..., N, 3) -> distorted pixel (u, v), each (..., N)."""
    x, y = distort_normalized(xyz[..., 0] / xyz[..., 2], xyz[..., 1] / xyz[..., 2],
                              dist_coeffs)
    return (camera_matrix[0, 0] * x + camera_matrix[0, 2],
            camera_matrix[1, 1] * y + camera_matrix[1, 2])


@f32_math()
def project_keypoints(q_vbs2tango, r_Vo2To_vbs, camera_matrix, dist_coeffs, keypoints):
    """Project 3D keypoints to pixels (reference utils.py:201-235): the pose
    ``[quat2dcm(q).T | t]``, the distortion polynomial, the camera matrix.

    Args:
        q_vbs2tango: (..., 4) scalar-first unit quaternion(s).
        r_Vo2To_vbs: (..., 3) position(s) (m).
        camera_matrix: (3, 3). dist_coeffs: (5,).
        keypoints: (N, 3) 3D points (m).
    Returns:
        (..., 2, N) pixel coordinates, the reference's layout.
    """
    R = quat2dcm(q_vbs2tango).mT  # standard rotation matrix
    # keypoints @ R.mT, summed over j in order by fused multiply-adds, as
    # XLA's CPU dot does.
    xyz = keypoints[:, 0:1] * R[..., None, :, 0]
    for j in (1, 2):
        xyz = fma(keypoints[:, j:j + 1], R[..., None, :, j], xyz)
    xyz = xyz + r_Vo2To_vbs[..., None, :]
    return torch.stack(_pixels(xyz, camera_matrix, dist_coeffs), -2)
