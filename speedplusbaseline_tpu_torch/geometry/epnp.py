"""Batched EPnP in PyTorch (counterpart of ``speedplusbaseline_tpu/geometry/
epnp.py``; the reference calls cv2.solvePnP(SOLVEPNP_EPNP) per image on the
host, src/utils/utils.py:237-269).

Lepetit, Moreno-Noguer & Fua, "EPnP: An Accurate O(n) Solution to the PnP
Problem" (IJCV 2009): control points, barycentric coordinates, the (2N, 12)
M matrix and the null space of M^T M, the three beta approximations each
refined by 8 Gauss-Newton steps, Horn alignment, best reprojection, then 5
Gauss-Newton steps on the pose and ``dcm2quat``: the JAX package's
pipeline, written batch-first on (B, ...) tensors rather than per sample.

On the card the whole call is a fixed chain of batched ops with no host
sync: no ``.item()``, no branch on a value (candidate selection is
``torch.where``), solves by ``solve_ex``/``inv_ex`` with
``check_errors=False`` and eigendecompositions by ``_eigh.eigh`` (the
``torch.linalg`` eigh and svd check their result on the host). The three
beta candidates are stacked along the batch, so each step runs once on 3B
problems; the control points depend only on the shared 3-D model and are
made once a call. Horn's rotation comes from the eigenvectors of H^T H (see
``_kabsch``), which is U diag(1, 1, det(U V^T)) V^T of the JAX package's
SVD.
"""
from __future__ import annotations

import functools

import torch

from ._eigh import eigh
from ._precision import f32_math
from .projection import _pixels, undistort_points
from .quaternion import _skew, dcm2quat, rodrigues

_GN_ITERS = 8
_REFINE_ITERS = 5
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# beta10 = [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44] as (i, j).
_BETA10 = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Index and coefficient tensors on ``device``, made once."""
    idx10 = torch.tensor([i * 4 + j for i, j in _BETA10], device=device)
    # d beta10 / d beta = sum_k beta_k C[k]: row (i, j) is b_j e_i + b_i e_j.
    C = torch.zeros(4, 10, 4)
    for r, (i, j) in enumerate(_BETA10):
        C[j, r, i] += 1.0
        C[i, r, j] += 1.0
    cols4 = torch.tensor([0, 1, 3, 6], device=device)
    return idx10, C.reshape(4, 40).to(device), cols4


def _solve_lstsq(A, b):
    """Least squares of (..., m, k) A x = (..., m) b by the normal equations
    with a 1e-10 ridge, as the JAX package's ``_solve_lstsq``."""
    AtA = A.mT @ A + 1e-10 * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    x, _ = torch.linalg.solve_ex(AtA, A.mT @ b[..., None], check_errors=False)
    return x[..., 0]


def _control_points(pws):
    """World control points (4, 3): centroid + principal axes scaled by
    sqrt(lambda / N), as OpenCV."""
    n = pws.shape[0]
    cw0 = pws.mean(0)
    centered = pws - cw0
    eigval, eigvec = eigh(centered.mT @ centered)  # ascending
    scale = torch.sqrt(torch.clamp(eigval.flip(0), min=1e-12) / n)
    axes = eigvec.flip(1).mT  # rows: principal directions, descending
    return torch.cat([cw0[None], cw0[None] + scale[:, None] * axes], 0)


def _barycentric(pws, cws):
    CC = (cws[1:] - cws[0]).mT
    CC_inv, _ = torch.linalg.inv_ex(CC + 1e-12 * torch.eye(3, dtype=CC.dtype, device=CC.device),
                                    check_errors=False)
    a123 = (pws - cws[0]) @ CC_inv.mT
    return torch.cat([1.0 - a123.sum(1, keepdim=True), a123], 1)  # (N, 4)


def _build_M(alphas, uv_norm):
    """(B, 2N, 12) design matrix in normalized coordinates (f = 1, c = 0):
    rows [a_j, 0, -a_j u] and [0, a_j, -a_j v] per point."""
    B, N = uv_norm.shape[:2]
    a = alphas.expand(B, N, 4)
    zeros = torch.zeros_like(a)
    row_u = torch.stack([a, zeros, -a * uv_norm[..., 0:1]], 3)  # (B, N, 4, 3)
    row_v = torch.stack([zeros, a, -a * uv_norm[..., 1:2]], 3)
    return torch.stack([row_u, row_v], 2).reshape(B, 2 * N, 12)


def _build_L_rho(vs, cws):
    """L (B, 6, 10) distance constraints and rho (6,) squared control-point
    distances; ``vs`` (B, 4, 4, 3) holds the four null-space vectors (the
    smallest eigenvalue first), each as 4 control points x 3."""
    dv = torch.stack([vs[:, :, i] - vs[:, :, j] for i, j in _PAIRS], 1)  # (B, 6, 4, 3)
    G = torch.einsum("bpak,bpck->bpac", dv, dv)
    L = torch.stack([G[..., i, j] * (1.0 if i == j else 2.0) for i, j in _BETA10], -1)
    rho = torch.stack([torch.sum((cws[i] - cws[j]) ** 2) for i, j in _PAIRS])
    return L, rho


def _nonzero(x):
    return torch.where(x == 0, 1.0, x)


def _betas_approx(L, rho, cols4):
    """The three initial betas, stacked candidate-major: (3B, 4)."""
    rho = rho.expand(L.shape[0], 6)
    zero = torch.zeros_like(rho[:, 0])
    # 1: columns [b11, b12, b13, b14].
    b = _solve_lstsq(L.index_select(2, cols4), rho)
    b1 = torch.sqrt(torch.abs(b[:, 0]))
    sign = torch.where(b[:, 0] < 0, -1.0, 1.0)
    beta_1 = torch.cat([b1[:, None], b[:, 1:] / _nonzero(b1)[:, None] * sign[:, None]], 1)
    # 2: columns [b11, b12, b22].
    b = _solve_lstsq(L[..., 0:3], rho)
    b1 = torch.sqrt(torch.abs(b[:, 0]))
    b2 = torch.where(b[:, 0] * b[:, 2] > 0, torch.sqrt(torch.abs(b[:, 2])), 0.0)
    b1 = torch.where(b[:, 1] < 0, -b1, b1)
    beta_2 = torch.stack([b1, b2, zero, zero], 1)
    # 3: columns [b11, b12, b22, b13, b23].
    b = _solve_lstsq(L[..., 0:5], rho)
    b1 = torch.sqrt(torch.abs(b[:, 0]))
    b2 = torch.where(b[:, 0] * b[:, 2] > 0, torch.sqrt(torch.abs(b[:, 2])), 0.0)
    b1 = torch.where(b[:, 1] < 0, -b1, b1)
    beta_3 = torch.stack([b1, b2, b[:, 3] / _nonzero(b1), zero], 1)
    return torch.cat([beta_1, beta_2, beta_3], 0)


def _gauss_newton(L, rho, beta, idx10, C):
    """Refine betas (K, 4) minimizing ||L beta10(beta) - rho||^2, fixed
    iterations."""
    K = beta.shape[0]
    for _ in range(_GN_ITERS):
        beta10 = (beta[:, :, None] * beta[:, None, :]).reshape(K, 16).index_select(1, idx10)
        J = L @ (beta @ C).reshape(K, 10, 4)
        r = rho - (L @ beta10[..., None])[..., 0]
        beta = beta + _solve_lstsq(J, r)
    return beta


def _kabsch(H):
    """The rotation R maximizing tr(R^T H), H = sum (camera)(world)^T:
    U diag(1, 1, det(U V^T)) V^T for H = U S V^T. With v1, v2 the leading
    eigenvectors of H^T H and u_i = H v_i normalized (u2 made orthogonal to
    u1), R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T: the third term is
    det(U) det(V) u3 v3^T, which is the SVD's sign fix."""
    _, V = eigh(H.mT @ H)
    v1, v2 = V[..., 2], V[..., 1]
    a1 = (H @ v1[..., None])[..., 0]
    a2 = (H @ v2[..., None])[..., 0]
    u1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=1e-30)
    a2 = a2 - torch.sum(u1 * a2, -1, keepdim=True) * u1
    u2 = a2 / torch.clamp(torch.linalg.vector_norm(a2, dim=-1, keepdim=True), min=1e-30)
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], -1)
    Vr = torch.stack([v1, v2, torch.linalg.cross(v1, v2)], -1)
    return U @ Vr.mT


def _pose_from_betas(beta, vs, alphas, pws):
    """Camera-frame control points -> (R, t) by Horn's alignment."""
    ccs = torch.einsum("bk,bkij->bij", beta, vs)  # (K, 4, 3)
    pcs = alphas @ ccs  # (K, N, 3)
    pcs = pcs * torch.where(pcs[..., 2].mean(1) < 0, -1.0, 1.0)[:, None, None]
    pc0 = pcs.mean(1)
    pw0 = pws.mean(0)
    R = _kabsch((pcs - pc0[:, None]).mT @ (pws - pw0))
    return R, pc0 - (R @ pw0[:, None])[..., 0]


def _refine_residual_jacobian(R0, t0, pws, uv_norm):
    """Reprojection residual r (B, 2N) of the pose (R0, t0) and its Jacobian
    (B, 2N, 6) in p = (w, dt) at p = 0, for the update R = rodrigues(w) R0,
    t = t0 + dt: d xyz / dw = -[R0 P]_x, d xyz / d dt = I (the analytic form
    of the JAX package's ``jax.jacfwd``)."""
    y = pws @ R0.mT  # (B, N, 3)
    xyz = y + t0[:, None]
    iz = 1.0 / xyz[..., 2]
    B, N = y.shape[:2]
    r = (xyz[..., :2] * iz[..., None] - uv_norm).reshape(B, 2 * N)
    zero = torch.zeros_like(iz)
    dproj = torch.stack([torch.stack([iz, zero, -xyz[..., 0] * iz * iz], -1),
                         torch.stack([zero, iz, -xyz[..., 1] * iz * iz], -1)], -2)
    dxyz = torch.cat([-_skew(y), torch.eye(3, dtype=y.dtype, device=y.device).expand(B, N, 3, 3)],
                     -1)
    return r, (dproj @ dxyz).reshape(B, 2 * N, 6)


def _refine_pose(R, t, pws, uv_norm):
    """Gauss-Newton on the reprojection residuals in normalized undistorted
    coordinates, left-multiplicative axis-angle update, fixed steps."""
    for _ in range(_REFINE_ITERS):
        r, J = _refine_residual_jacobian(R, t, pws, uv_norm)
        delta = _solve_lstsq(J, -r)
        R = rodrigues(delta[:, :3]) @ R
        t = t + delta[:, 3:]
    return R, t


def _reproj_error(R, t, pws, uv_pix, camera_matrix, dist_coeffs):
    u, v = _pixels(pws @ R.mT + t[:, None], camera_matrix, dist_coeffs)
    return torch.mean(torch.sqrt((u - uv_pix[..., 0]) ** 2 + (v - uv_pix[..., 1]) ** 2), -1)


def _epnp(pws, uv_pix, camera_matrix, dist_coeffs):
    """(N, 3) model, (B, N, 2) pixels -> q (B, 4), t (B, 3)."""
    B, N = uv_pix.shape[:2]
    idx10, C, cols4 = _consts(uv_pix.device)
    uv_norm = undistort_points(uv_pix, camera_matrix, dist_coeffs)
    cws = _control_points(pws)
    alphas = _barycentric(pws, cws)
    M = _build_M(alphas, uv_norm)
    _, V = eigh(M.mT @ M)  # ascending
    vs = V[..., :4].mT.reshape(B, 4, 4, 3)
    L, rho = _build_L_rho(vs, cws)

    beta = _gauss_newton(L.repeat(3, 1, 1), rho, _betas_approx(L, rho, cols4), idx10, C)
    R, t = _pose_from_betas(beta, vs.repeat(3, 1, 1, 1), alphas, pws)
    err = _reproj_error(R, t, pws, uv_pix.repeat(3, 1, 1), camera_matrix,
                        dist_coeffs).reshape(3, B)
    R, t = R.reshape(3, B, 3, 3), t.reshape(3, B, 3)

    # The first strictly better reprojection wins, a NaN error counting as
    # infinite. As OpenCV's EPnP, candidate 0 stands when no error is finite
    # (its distortion polynomial overflows where a candidate puts a point at
    # z ~ 0): the JAX package starts from R = I, t = 0 there, which the
    # refinement's 1/z turns into NaN. Otherwise the choice is the JAX one.
    err = torch.where(torch.isnan(err), float("inf"), err)
    best_err, best_R, best_t = err[0], R[0], t[0]
    for k in (1, 2):
        take = err[k] < best_err
        best_err = torch.where(take, err[k], best_err)
        best_R = torch.where(take[:, None, None], R[k], best_R)
        best_t = torch.where(take[:, None], t[k], best_t)

    R, t = _refine_pose(best_R, best_t, pws, uv_norm)
    return dcm2quat(R), t


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _inputs(points_3d, points_2d, camera_matrix, dist_coeffs):
    points_2d = torch.as_tensor(points_2d, dtype=torch.float32)
    dev = points_2d.device
    if dist_coeffs is None:
        dist_coeffs = torch.zeros(5, device=dev)
    return (_f32(points_3d, dev), points_2d, _f32(camera_matrix, dev),
            _f32(dist_coeffs, dev).reshape(-1)[:5])


@f32_math()
def epnp_batched(points_3d, points_2d_batch, camera_matrix, dist_coeffs=None):
    """EPnP over a batch of 2D observations of one 3D model.

    Args:
        points_3d: (N, 3) model points.
        points_2d_batch: (B, N, 2) pixel observations (distorted, as measured).
        camera_matrix: (3, 3). dist_coeffs: (5,) or None.
    Returns:
        q (B, 4) scalar-first unit quaternions (scipy's ``from_matrix`` of
        the camera rotation, as the reference), t (B, 3) in metres.
    """
    return _epnp(*_inputs(points_3d, points_2d_batch, camera_matrix, dist_coeffs))


@f32_math()
def epnp(points_3d, points_2d, camera_matrix, dist_coeffs=None):
    """EPnP of one (N, 2) observation: q (4,), t (3,) (reference
    utils.py:237-269)."""
    p3, p2, K, d = _inputs(points_3d, points_2d, camera_matrix, dist_coeffs)
    q, t = _epnp(p3, p2[None], K, d)
    return q[0], t[0]


@f32_math()
def keypoints_to_pose(x_pr, y_pr, bbox, corners3d, camera_matrix, dist_coeffs):
    """Normalized RoI keypoints -> pose, batched (reference
    inference.py:227-248).

    Args:
        x_pr, y_pr: (B, K) keypoint coordinates in [0, 1] within the RoI.
        bbox: (B, 4) RoI [xmin, xmax, ymin, ymax] in pixels.
        corners3d: (K, 3) model points.
    Returns:
        q (B, 4), t (B, 3).
    """
    x_pr, y_pr, bbox = x_pr.float(), y_pr.float(), bbox.float()
    xmin, xmax = bbox[:, 0:1], bbox[:, 1:2]
    ymin, ymax = bbox[:, 2:3], bbox[:, 3:4]
    uv = torch.stack([x_pr * (xmax - xmin) + xmin, y_pr * (ymax - ymin) + ymin], -1)
    return epnp_batched(corners3d, uv, camera_matrix, dist_coeffs)
