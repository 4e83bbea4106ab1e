"""Port geometry against the JAX package on the same numpy inputs: the
quaternion algebra, projection and undistortion (also against
cv2.undistortPoints), batched EPnP and ``keypoints_to_pose`` (also against
ground truth), the refinement Jacobian against ``jax.jacfwd``, the sync-free
eigensolver against float64, and the autocast guard of every entry point.

Tolerances (f32 on both sides):
  * elementwise quaternion/projection maps: 2e-6 absolute (a few f32 ulps
    of values of order 1), pixels 2e-3 px (f32 ulp at 1e3 px is 6e-5);
  * the quaternion mean: 1e-5 (eigenvector + three inverse-iteration solves);
  * EPnP against JAX: |dq|inf <= 2e-5 after sign alignment and |dt|inf <=
    2e-4 m on noise-free keypoints; on 2-px noise 1e-4 and 1e-3 m (the two
    f32 Gauss-Newton refinements stop at the same minimum, a few f32 ulps of
    a 9 m depth apart, amplified by the noisy problem's conditioning);
  * against ground truth, test_epnp.py's acceptance: 0.08 deg and 1 mm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu import geometry as jg
from speedplusbaseline_tpu.geometry.quaternion import rodrigues as jax_rodrigues
from speedplusbaseline_tpu.metrics import error_orientation as jax_error_orientation
from speedplusbaseline_tpu_torch import geometry as tg
from speedplusbaseline_tpu_torch.geometry import _eigh
from speedplusbaseline_tpu_torch.geometry.epnp import _refine_residual_jacobian
from speedplusbaseline_tpu_torch.metrics import error_orientation, error_translation
from tests.conftest import random_pose

torch.set_num_threads(1)


def t32(x):
    return torch.from_numpy(np.array(x, np.float32))


def j32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def unit_quats(rs, n):
    q = rs.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def close(ours, ref, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0, atol=atol)


def test_quaternion_maps_match_jax():
    rs = np.random.RandomState(0)
    q, p = unit_quats(rs, 16), unit_quats(rs, 16)
    close(tg.quat_normalize(t32(q * 3.0)), jg.quat_normalize(j32(q * 3.0)), 2e-6)
    close(tg.quat2dcm(t32(q)), jg.quat2dcm(j32(q)), 2e-6)
    close(tg.quat_mul(t32(q), t32(p)), jg.quat_mul(j32(q), j32(p)), 2e-6)
    close(tg.quat_conj(t32(q)), jg.quat_conj(j32(q)), 0)
    close(tg.quat_angular_distance(t32(q), t32(p)), jg.quat_angular_distance(j32(q), j32(p)),
          2e-6)


# One quaternion per Shepperd branch: w, x, y and z dominant.
SHEPPERD = [[0.9, 0.3, -0.2, 0.25], [0.1, -0.95, 0.2, 0.2], [0.2, 0.1, 0.9, -0.37],
            [-0.15, 0.3, -0.1, -0.94]]


@pytest.mark.parametrize("branch", range(4))
def test_dcm2quat_shepperd_branches_match_jax(branch):
    q = np.asarray(SHEPPERD[branch], np.float32)
    q /= np.linalg.norm(q)
    R = np.asarray(jg.quat2dcm(j32(q))).T
    mags = [1 + np.trace(R), 1 + R[0, 0] - R[1, 1] - R[2, 2], 1 - R[0, 0] + R[1, 1] - R[2, 2],
            1 - R[0, 0] - R[1, 1] + R[2, 2]]
    assert int(np.argmax(mags)) == branch
    ours = tg.dcm2quat(t32(R)).numpy()
    close(ours, jg.dcm2quat(j32(R)), 2e-6)
    close(ours * np.sign(ours @ q), q, 2e-6)
    # batched: all four branches in one call
    Rs = np.stack([np.asarray(jg.quat2dcm(j32(np.asarray(s) / np.linalg.norm(s)))).T
                   for s in SHEPPERD])
    close(tg.dcm2quat(t32(Rs)), jax.vmap(jg.dcm2quat)(j32(Rs)), 2e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 1.0, 3.0])
def test_rodrigues_matches_jax(scale):
    """theta = 0 and 1e-7 take the first-order branch, the rest the full
    formula; the port is batched where the JAX function takes one (3,)."""
    w = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * scale
    ours = tg.rodrigues(t32(w))
    close(ours, jax.vmap(jax_rodrigues)(j32(w)), 2e-6)
    close(ours[0], jax_rodrigues(j32(w[0])), 2e-6)


def test_weighted_mean_quaternion_matches_jax():
    rs = np.random.RandomState(2)
    base = unit_quats(rs, 3)
    qs = base[:, None, :] + 0.05 * rs.randn(3, 5, 4).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    qs[:, 1] *= -1.0  # q and -q are one rotation
    w = rs.rand(3, 5).astype(np.float32)
    close(tg.weighted_mean_quaternion(t32(qs), t32(w)),
          jax.vmap(jg.weighted_mean_quaternion)(j32(qs), j32(w)), 1e-5)
    close(tg.weighted_mean_quaternion(t32(qs[0])), jg.weighted_mean_quaternion(j32(qs[0])),
          1e-5)


def test_projection_matches_jax(camera, tango_points):
    K, dist = camera
    rs = np.random.RandomState(3)
    x0, y0 = rs.uniform(-0.3, 0.3, (2, 40)).astype(np.float32)
    for ours, ref in zip(tg.distort_normalized(t32(x0), t32(y0), t32(dist)),
                         jg.distort_normalized(j32(x0), j32(y0), j32(dist))):
        close(ours, ref, 2e-6)
    uv = rs.uniform([0, 0], [1920, 1200], (7, 11, 2)).astype(np.float32)
    close(tg.undistort_points(t32(uv), t32(K), t32(dist)),
          jg.undistort_points(j32(uv), j32(K), j32(dist)), 2e-6)
    poses = [random_pose(rs) for _ in range(4)]
    q = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    ours = tg.project_keypoints(t32(q), t32(t), t32(K), t32(dist), t32(tango_points))
    assert ours.shape == (4, 2, 11)
    for i in range(4):
        close(ours[i], jg.project_keypoints(j32(q[i]), j32(t[i]), j32(K), j32(dist),
                                            j32(tango_points)), 2e-3)


def test_projection_and_quat_normalize_are_jax_bit_for_bit(camera, tango_points):
    """The quaternion norm and the projection's dot sum by fused
    multiply-adds in index order, as XLA's CPU code: project_keypoints, on
    a batch, equals JAX's per-pose call bit for bit (label CSVs depend on
    it); a plain torch matmul and vector_norm would not."""
    K, dist = camera
    rs = np.random.RandomState(9)
    poses = [random_pose(rs) for _ in range(64)]
    q = np.stack([p[0] for p in poses]).astype(np.float32)
    t = np.stack([p[1] for p in poses]).astype(np.float32)
    ours = tg.project_keypoints(t32(q), t32(t), t32(K), t32(dist), t32(tango_points)).numpy()
    ref = np.stack([np.asarray(jg.project_keypoints(q[i], t[i], j32(K), j32(dist),
                                                    j32(tango_points))) for i in range(64)])
    np.testing.assert_array_equal(ours, ref)
    qn = rs.randn(64, 4).astype(np.float32)
    np.testing.assert_array_equal(tg.quat_normalize(t32(qn)).numpy(),
                                  np.stack([np.asarray(jg.quat_normalize(j32(v))) for v in qn]))


def test_epnp_keeps_candidate_0_when_no_error_is_finite():
    """Keypoints regressed by a diverged model (a fake-dataset camera, the
    Tango points): each beta candidate puts a model point at z ~ 0, where
    the distortion polynomial overflows, so no reprojection error is finite.
    The port keeps candidate 0, as OpenCV's EPnP, and returns a finite pose;
    where no error is finite, the JAX package starts from R = I, t = 0 and
    returns NaN. (JAX's control-point axes have other signs than the port's,
    so on this input its candidates differ and one error is finite.)"""
    import importlib

    from speedplusbaseline_tpu_torch.io_utils import load_tango_3d_keypoints

    epnp = importlib.import_module("speedplusbaseline_tpu_torch.geometry.epnp")
    xc = [3.5113985538482666, 3.495016574859619, 2.049605369567871, 3.492147207260132,
          3.7470903396606445, 0.9256380200386047, 4.293936729431152, 2.833529472351074,
          0.17644639313220978, 3.239567756652832, 3.7825686931610107]
    yc = [1.9329252243041992, -0.20483677089214325, 2.6299383640289307, -0.8355242609977722,
          3.9751229286193848, 1.4153976440429688, -0.5752226114273071, 0.6912774443626404,
          3.413667917251587, 3.6033759117126465, 3.7479560375213623]
    bbox = t32([[286.0, 376.0, 182.0, 272.0]])
    K = t32([[384.0, 0.0, 320.0], [0.0, 384.0, 200.0], [0.0, 0.0, 1.0]])
    dist = t32([-0.1, 0.03, -5e-4, -5e-4, 0.0])
    P = t32(load_tango_3d_keypoints())
    errs = []
    real = epnp._reproj_error
    try:
        epnp._reproj_error = lambda *a: errs.append(real(*a)) or errs[-1]
        q, t = tg.keypoints_to_pose(t32([xc]), t32([yc]), bbox, P, K, dist)
    finally:
        epnp._reproj_error = real
    assert errs and not torch.isfinite(errs[0]).any()
    assert torch.isfinite(q).all() and torch.isfinite(t).all()


def test_undistort_matches_opencv(camera):
    cv2 = pytest.importorskip("cv2")
    K, dist = camera
    uv = np.random.RandomState(4).uniform([100, 100], [1820, 1100], (50, 2))
    ref = cv2.undistortPoints(uv.reshape(-1, 1, 2), K, dist).reshape(-1, 2)
    # cv2 iterates 5 times by default; the fixed point is reached well within
    # 10 here, so 2e-5 in normalized units (about 0.06 px).
    close(tg.undistort_points(t32(uv), t32(K), t32(dist)), ref, 2e-5)


def test_eigh_matches_float64():
    """The sync-free Jacobi eigensolver at its three sizes, on EPnP's M^T M
    among them: eigenvalues within 1e-5 of the largest, residual
    ||A v - lambda v|| within 2e-6 of it, orthonormal vectors."""
    rs = np.random.RandomState(5)
    mats = [rs.randn(8, n, n) for n in (3, 4)]
    mats = [m @ np.swapaxes(m, 1, 2) for m in mats]
    M = rs.randn(8, 22, 12)
    mats.append(np.swapaxes(M, 1, 2) @ M)
    for A in mats:
        w, V = _eigh.eigh(t32(A))
        w, V = w.double().numpy(), V.double().numpy()
        scale = np.abs(A).max()
        close(w, np.linalg.eigvalsh(A), 1e-5 * scale)
        close(A @ V - V * w[:, None, :], 0 * A, 2e-6 * scale)
        close(np.swapaxes(V, 1, 2) @ V, np.broadcast_to(np.eye(A.shape[-1]), A.shape), 2e-6)


@pytest.fixture(scope="module")
def poses():
    """32 random poses 3.5-9 m in front of the conftest camera, their exact
    projections of the conftest model, and 2-px-noisy copies."""
    rs = np.random.RandomState(6)
    q, t = zip(*[random_pose(rs) for _ in range(32)])
    return np.stack(q), np.stack(t), rs.randn(32, 11, 2) * 2.0


def observations(poses, camera, tango_points, noise):
    q, t, n = poses
    K, dist = camera
    uv = tg.project_keypoints(torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(K),
                              torch.as_tensor(dist), torch.as_tensor(tango_points))
    return uv.mT.numpy() + (n if noise else 0.0)


_jax_epnp_batched = jax.jit(jg.epnp_batched)
_jax_kp_to_pose = jax.jit(jg.keypoints_to_pose)

# (|dq|inf, |dt|inf in m) against JAX, noise-free and 2-px noise.
TOL_VS_JAX = {False: (2e-5, 2e-4), True: (1e-4, 1e-3)}


def assert_pose_close(q, t, q_ref, t_ref, noise):
    q, t, q_ref, t_ref = (np.asarray(a, np.float64) for a in (q, t, q_ref, t_ref))
    sign = np.sign(np.sum(q * q_ref, -1, keepdims=True))
    tq, tt = TOL_VS_JAX[noise]
    close(q * sign, q_ref, tq)
    close(t, t_ref, tt)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_epnp_batched_matches_jax(poses, camera, tango_points, B, noise):
    K, dist = camera
    uv = observations(poses, camera, tango_points, noise)[:B].astype(np.float32)
    q, t = tg.epnp_batched(t32(tango_points), t32(uv), t32(K), t32(dist))
    assert q.shape == (B, 4) and t.shape == (B, 3)
    q_ref, t_ref = _jax_epnp_batched(j32(tango_points), j32(uv), j32(K), j32(dist))
    assert_pose_close(q, t, q_ref, t_ref, noise)
    if not noise:  # against ground truth (test_epnp.py's acceptance)
        assert float(error_orientation(q, t32(poses[0][:B])).max()) < 0.08
        assert float(error_translation(t, t32(poses[1][:B])).max()) < 1e-3


def test_epnp_single_matches_batched(poses, camera, tango_points):
    K, dist = camera
    uv = observations(poses, camera, tango_points, True)[:3].astype(np.float32)
    qb, tb = tg.epnp_batched(tango_points, uv, K, dist)
    for i in range(3):
        q, t = tg.epnp(tango_points, uv[i], K, dist)
        close(q * torch.sign(q @ qb[i]), qb[i], 1e-6)
        close(t, tb[i], 1e-5)


def normalized_keypoints(uv):
    """Pixel keypoints -> RoI-normalized (x, y) and a 1.2x square RoI box, as
    the eval crop gives them."""
    lo, hi = uv.min(1), uv.max(1)
    c, half = (lo + hi) / 2, 0.6 * (hi - lo).max(1)
    bbox = np.stack([c[:, 0] - half, c[:, 0] + half, c[:, 1] - half, c[:, 1] + half], 1)
    x = (uv[..., 0] - bbox[:, 0:1]) / (bbox[:, 1:2] - bbox[:, 0:1])
    y = (uv[..., 1] - bbox[:, 2:3]) / (bbox[:, 3:4] - bbox[:, 2:3])
    return x.astype(np.float32), y.astype(np.float32), bbox.astype(np.float32)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_keypoints_to_pose_matches_jax(poses, camera, tango_points, B, noise):
    K, dist = camera
    x, y, bbox = normalized_keypoints(observations(poses, camera, tango_points, noise)[:B])
    q, t = tg.keypoints_to_pose(t32(x), t32(y), t32(bbox), t32(tango_points), t32(K), t32(dist))
    q_ref, t_ref = _jax_kp_to_pose(j32(x), j32(y), j32(bbox), j32(tango_points), j32(K),
                                   j32(dist))
    assert_pose_close(q, t, q_ref, t_ref, noise)
    if not noise:
        err_q = np.asarray(jax_error_orientation(j32(q.numpy()), j32(poses[0][:B])))
        assert err_q.max() < 0.08
        assert float(error_translation(t, t32(poses[1][:B])).max()) < 1e-3


def test_refine_jacobian_matches_jacfwd(poses, camera, tango_points):
    """The analytic d(proj)/d(w, dt) of the refinement against jax.jacfwd of
    the JAX package's residual (rodrigues(w) R0, t0 + dt) at p = 0, which
    runs through rodrigues' small-angle branch. 1e-5 of the largest entry."""
    K, dist = camera
    uv = observations(poses, camera, tango_points, True)[:4]
    uv_norm = np.asarray(jg.undistort_points(j32(uv), j32(K), j32(dist)))
    q, t = poses[0][:4], poses[1][:4] + 0.01
    R0 = np.stack([np.asarray(jg.quat2dcm(j32(qi))).T for qi in q]).astype(np.float32)
    pws = np.asarray(tango_points, np.float32)

    def res(params, R0, t0, uvn):
        Rd = jax_rodrigues(params[:3]) @ R0
        xyz = pws @ Rd.T + (t0 + params[3:])
        return (xyz[:, :2] / xyz[:, 2:3] - uvn).reshape(-1)

    with jax.default_matmul_precision("float32"):
        J_ref = jax.vmap(lambda *a: jax.jacfwd(res)(jnp.zeros(6), *a))(
            j32(R0), j32(t), j32(uv_norm))
        r_ref = jax.vmap(lambda *a: res(jnp.zeros(6), *a))(j32(R0), j32(t), j32(uv_norm))
    r, J = _refine_residual_jacobian(t32(R0), t32(t), t32(pws), t32(uv_norm))
    scale = float(np.abs(np.asarray(J_ref)).max())
    close(J, J_ref, 1e-5 * scale)
    close(r, r_ref, 1e-6)


def _entry_points(camera, tango_points, poses):
    K, dist = (t32(a) for a in camera)
    P = t32(tango_points)
    q, t = t32(poses[0][:5]), t32(poses[1][:5])
    uv = t32(observations(poses, camera, tango_points, True)[:5])
    x, y, bbox = (t32(a) for a in normalized_keypoints(uv.numpy()))
    R = tg.quat2dcm(q).mT
    return {
        "quat_normalize": lambda: tg.quat_normalize(q * 2),
        "quat2dcm": lambda: tg.quat2dcm(q),
        "dcm2quat": lambda: tg.dcm2quat(R),
        "quat_mul": lambda: tg.quat_mul(q, q.flip(0)),
        "quat_conj": lambda: tg.quat_conj(q),
        "quat_angular_distance": lambda: tg.quat_angular_distance(q, q.flip(0)),
        "rodrigues": lambda: tg.rodrigues(t * 0.1),
        "weighted_mean_quaternion": lambda: tg.weighted_mean_quaternion(q, t[:, 0]),
        "distort_normalized": lambda: torch.stack(tg.distort_normalized(x, y, dist)),
        "undistort_points": lambda: tg.undistort_points(uv, K, dist),
        "project_keypoints": lambda: tg.project_keypoints(q, t, K, dist, P),
        "epnp": lambda: torch.cat(tg.epnp(P, uv[0], K, dist)),
        "epnp_batched": lambda: torch.cat(tg.epnp_batched(P, uv, K, dist), 1),
        "keypoints_to_pose": lambda: torch.cat(tg.keypoints_to_pose(x, y, bbox, P, K, dist), 1),
        "compute_position_spn_batched": lambda: tg.compute_position_spn_batched(
            q, bbox, P, K, dist),
    }


def test_entry_points_ignore_autocast_and_reduced_precision(camera, tango_points, poses):
    """Every public geometry function gives bit for bit the same result
    inside a bf16 autocast and under float32 matmul precision "medium" as
    outside them (the eval forward runs under such an autocast), and leaves
    the caller's settings as they were."""
    fns = _entry_points(camera, tango_points, poses)
    assert set(fns) == set(tg.__all__) - {"f32_math"}
    ref = {k: f() for k, f in fns.items()}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with torch.autocast("cpu", dtype=torch.bfloat16):
            for k, f in fns.items():
                got = f()
                assert got.dtype == torch.float32, k
                np.testing.assert_array_equal(got.numpy(), ref[k].numpy(), err_msg=k)
                assert torch.is_autocast_enabled("cpu")
                assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    # The guard is what holds them: a bare bmm in this autocast is bf16.
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert (t32(np.eye(3)) @ t32(np.eye(3))).dtype == torch.bfloat16
