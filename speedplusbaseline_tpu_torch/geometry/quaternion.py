"""Quaternion algebra in PyTorch, scalar-first (counterpart of
``speedplusbaseline_tpu/geometry/quaternion.py``; reference
src/utils/utils.py:139-199).

Conventions match the JAX package exactly:
  * quaternions are scalar-first: q = [q0, q1, q2, q3] = [w, x, y, z];
  * ``quat2dcm`` returns the TRANSPOSE of the standard rotation matrix R(q),
    as the reference composes poses as ``[quat2dcm(q).T | t]``.

Every function takes leading batch dimensions (``rodrigues`` too, where the
JAX one takes one (3,) vector). Nothing here reads a value back to the host
or branches on one, so the functions run on the card without a sync.
"""
from __future__ import annotations

import torch

from ._eigh import eigh
from ._precision import f32_math, fma


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]_x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


@f32_math()
def quat_normalize(q):
    """Normalize quaternion(s) along the last axis. The squares are summed
    in index order by fused multiply-adds, as XLA's CPU reduction does."""
    s = q[..., 0:1] * q[..., 0:1]
    for i in range(1, 4):
        s = fma(q[..., i:i + 1], q[..., i:i + 1], s)
    return q / torch.sqrt(s)


@f32_math()
def quat2dcm(q):
    """Direction cosine matrix from a scalar-first quaternion: R(q)^T, the
    semantics of reference utils.py:168-199."""
    q = quat_normalize(q)
    q0, q1, q2, q3 = q.unbind(-1)
    r00 = 2 * q0 * q0 - 1 + 2 * q1 * q1
    r11 = 2 * q0 * q0 - 1 + 2 * q2 * q2
    r22 = 2 * q0 * q0 - 1 + 2 * q3 * q3
    r01 = 2 * q1 * q2 + 2 * q0 * q3
    r02 = 2 * q1 * q3 - 2 * q0 * q2
    r10 = 2 * q1 * q2 - 2 * q0 * q3
    r12 = 2 * q2 * q3 + 2 * q0 * q1
    r20 = 2 * q1 * q3 + 2 * q0 * q2
    r21 = 2 * q2 * q3 - 2 * q0 * q1
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


@f32_math()
def dcm2quat(R):
    """STANDARD rotation matrix (``quat2dcm(q).mT``) -> scalar-first unit
    quaternion. All four Shepperd candidates are computed and the best
    conditioned one is picked with ``torch.gather``: no branch."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    eps = 1e-12
    sw = torch.sqrt(torch.clamp(qw2, min=eps))
    sx = torch.sqrt(torch.clamp(qx2, min=eps))
    sy = torch.sqrt(torch.clamp(qy2, min=eps))
    sz = torch.sqrt(torch.clamp(qz2, min=eps))
    cands = torch.stack([
        torch.stack([sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy, (m12 + m21) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz], -1),
    ], -2)  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return quat_normalize(torch.gather(cands, -2, idx).squeeze(-2))


@f32_math()
def quat_mul(q, p):
    """Hamilton product of scalar-first quaternions."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = p.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


@f32_math()
def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


@f32_math()
def quat_angular_distance(q, p):
    """Angular distance(s) in radians: 2*acos(|q . p|)."""
    d = torch.clamp(torch.abs(torch.sum(q * p, -1)), max=1.0)
    return 2.0 * torch.arccos(d)


@f32_math()
def rodrigues(w):
    """Axis-angle vectors (..., 3) -> standard rotation matrices (..., 3, 3),
    with the JAX package's first-order form below theta^2 = 1e-12."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + 1e-24)[..., None, None]
    K = _skew(w / theta[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R_full = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    W = _skew(w)
    R_small = eye + W + 0.5 * (W @ W)
    return torch.where((theta2 > 1e-12)[..., None, None], R_full, R_small)


@f32_math()
def weighted_mean_quaternion(qs, weights=None):
    """Weighted chordal-L2 mean of unit quaternions (Markley et al. 2007;
    scipy ``Rotation.mean`` in the reference): the eigenvector of
    M = sum_i w_i q_i q_i^T with the largest eigenvalue, polished by three
    steps of shifted inverse iteration, with a nonnegative scalar part.

    Args:
        qs: (..., N, 4) scalar-first unit quaternions.
        weights: (..., N) nonnegative weights, or None for uniform.
    Returns:
        (..., 4).
    """
    if weights is None:
        weights = torch.ones(qs.shape[:-1], dtype=qs.dtype, device=qs.device)
    M = torch.einsum("...n,...ni,...nj->...ij", weights, qs, qs)
    q = eigh(M)[1][..., -1]
    eye = torch.eye(4, dtype=M.dtype, device=M.device)
    for _ in range(3):
        mu = torch.einsum("...i,...ij,...j->...", q, M, q)[..., None, None]
        v = torch.linalg.solve_ex(M - (mu + 1e-6) * eye, q[..., None],
                                  check_errors=False)[0][..., 0]
        q = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)
