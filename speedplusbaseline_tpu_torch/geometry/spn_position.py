"""SPN position from a predicted attitude and the detected bounding box, by
Gauss-Newton (counterpart of ``speedplusbaseline_tpu/geometry/
spn_position.py::compute_position_spn_batched``; reference
src/utils/computePositionSPN.py:33-175).

Initial range by similar triangles along the ray through the bbox centre,
then Gauss-Newton fitting the four extremal model points (extremal in their
undistorted reprojection) to the bbox edges: distorted residuals, the
distortion-free Jacobian, (J^T J + 1e-12 I) dt = J^T r. The reference loops
until dx <= 5e-10 or 50 iterations; like the JAX package, every sample here
takes exactly 51 iterations and freezes once the PREVIOUS iteration's step
was <= 5e-10, so the shapes are static and nothing is read back.

Batch-first, with no host sync: argmin/argmax and a gather pick the points,
``solve_ex(check_errors=False)`` solves, ``torch.where`` freezes.
"""
from __future__ import annotations

import torch

from ._precision import f32_math
from .projection import distort_normalized
from .quaternion import quat2dcm

MAX_MODEL_LENGTH = 1.246  # [m] Tango model diagonal (computePositionSPN.py:42)
_MAX_ITERS = 50
_TOL = 5e-10


def _initial_guess(bbox, camera_matrix):
    """(B, 3) range by similar triangles along the bbox-centre ray.

    The JAX package's deliberate deviation from the reference: the direction
    is R_y(+az) R_x(-el) e_z, where computePositionSPN.py:55 takes R_y(-az),
    which points the initial x to the mirrored side of the optical axis and
    lets Gauss-Newton converge to a reflected position for some lateral
    poses. R_y(az) R_x(-el) e_z = (sin az cos el, sin el, cos az cos el)."""
    xmin, xmax, ymin, ymax = bbox.unbind(-1)
    width, height = xmax - xmin, ymax - ymin
    box_size = torch.sqrt(width ** 2 + height ** 2)
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    az = torch.arctan((xmin + width / 2.0 - camera_matrix[0, 2]) / fx)
    el = torch.arctan((ymin + height / 2.0 - camera_matrix[1, 2]) / fy)
    rng = fx * MAX_MODEL_LENGTH / box_size
    ce, se = torch.cos(-el), torch.sin(-el)
    return torch.stack([torch.sin(az) * ce, -se, torch.cos(az) * ce], -1) * rng[:, None]


def _pixels_undistorted(xyz, camera_matrix):
    return (camera_matrix[0, 0] * (xyz[..., 0] / xyz[..., 2]) + camera_matrix[0, 2],
            camera_matrix[1, 1] * (xyz[..., 1] / xyz[..., 2]) + camera_matrix[1, 2])


def _step(corners_vbs, t, bbox, camera_matrix, dist_coeffs):
    """One Gauss-Newton update of t (B, 3); corners_vbs (B, N, 3)."""
    u, v = _pixels_undistorted(corners_vbs + t[:, None], camera_matrix)
    # left, right, top, bottom: fitted to xmin, xmax, ymin, ymax
    idx = torch.stack([u.argmin(1), u.argmax(1), v.argmin(1), v.argmax(1)], 1)
    r_vbs = torch.gather(corners_vbs, 1, idx[..., None].expand(-1, -1, 3))  # (B, 4, 3)
    xyz = r_vbs + t[:, None]
    x, y = distort_normalized(xyz[..., 0] / xyz[..., 2], xyz[..., 1] / xyz[..., 2],
                              dist_coeffs)
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    u = fx * x + camera_matrix[0, 2]
    v = fy * y + camera_matrix[1, 2]
    r = torch.stack([u[:, 0], u[:, 1], v[:, 2], v[:, 3]], 1) - bbox  # (B, 4)
    z = xyz[..., 2]
    zero = torch.zeros_like(z[:, 0])
    rows = [torch.stack([fx / z[:, i], zero, -fx * xyz[:, i, 0] / z[:, i] ** 2], -1)
            for i in (0, 1)]
    rows += [torch.stack([zero, fy / z[:, i], -fy * xyz[:, i, 1] / z[:, i] ** 2], -1)
             for i in (2, 3)]
    J = torch.stack(rows, 1)  # (B, 4, 3), distortion-free (computePositionSPN.py:139-175)
    JtJ = J.mT @ J + 1e-12 * torch.eye(3, dtype=J.dtype, device=J.device)
    delta, _ = torch.linalg.solve_ex(JtJ, J.mT @ r[..., None], check_errors=False)
    return t - delta[..., 0]


@f32_math()
def compute_position_spn_batched(q_batch, bbox_batch, corners3d, camera_matrix, dist_coeffs):
    """Positions (B, 3) in metres from (B, 4) scalar-first attitudes and
    (B, 4) [xmin, xmax, ymin, ymax] pixel boxes; corners3d (N, 3),
    camera_matrix (3, 3), dist_coeffs (5,)."""
    q = torch.as_tensor(q_batch, dtype=torch.float32)
    dev = q.device
    bbox = torch.as_tensor(bbox_batch, dtype=torch.float32, device=dev)
    corners3d, camera_matrix, dist_coeffs = (
        torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in (corners3d, camera_matrix, dist_coeffs))
    dist_coeffs = dist_coeffs.reshape(-1)[:5]
    # Body points in the camera's axes: rows of R(q) P^T, i.e. P quat2dcm(q).
    corners_vbs = corners3d @ quat2dcm(q)  # (B, N, 3)
    t = _initial_guess(bbox, camera_matrix)
    dx = torch.ones_like(t[:, 0])
    for _ in range(_MAX_ITERS + 1):
        t_new = _step(corners_vbs, t, bbox, camera_matrix, dist_coeffs)
        conv = dx <= _TOL  # the previous iteration's step
        dx = torch.where(conv, dx, torch.linalg.vector_norm(t_new - t, dim=-1))
        t = torch.where(conv[:, None], t, t_new)
    return t
