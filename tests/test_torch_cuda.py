"""The hand-written CUDA kernels against their plain versions on the card
(at the KRN and SPN paths' shapes), and the batched EPnP and SPN's pose on
the card against the CPU.

Marked ``cuda``: each test skips on a machine without a GPU (the CPU tests
reach only the plain versions). On the card, ``python -m pytest
tests/test_torch_cuda.py`` builds the kernels with nvcc and runs these; the
module imports no JAX. Tolerances: f32 1e-4 (B2) and 5e-4 + 1e-4 |ref| (B1,
1152-term sums of split-bf16 tensor-core products in another order); bf16
1e-2 + 2^-6 |ref| (one or two bf16 ulps where the f32 results round
differently). EPnP: card against CPU f32 on 1-px-noisy keypoints, q within
1e-4 after sign alignment and t within 1e-3 m (the two refinements stop at
one minimum, f32 rounding apart), with no host sync in the call, and its
CUDA graph replay equal to the eager call; SPN's pose the same way.
"""
import numpy as np
import pytest
import torch

from speedplusbaseline_tpu_torch.engine.steps import CudaGraphed, spn_pose
from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose, project_keypoints
from speedplusbaseline_tpu_torch.ops import _build
from speedplusbaseline_tpu_torch.ops.instancenorm import (instance_norm_film,
                                                          instance_norm_film_plain, path_calls,
                                                          plan_on_card)
from speedplusbaseline_tpu_torch.ops.resblock import ghiasi_resblock, ghiasi_resblock_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, ref, tol):
    atol, rtol = tol
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), err.max().item()


# Shape -> the path plan() gives it in (f32, bf16): the main path's layer2
# and layer10 shapes, an odd plane, no 16-byte split (3, 9, 7, 3), and the
# last square 32-channel plane that 16 cluster blocks hold (236^2) and the
# first they do not (237^2).
B2_PATHS = {(2, 8, 8, 32): ("cluster", "cluster"), (3, 9, 7, 3): ("two_pass", "two_pass"),
            (2, 57, 41, 128): ("cluster", "cluster"),
            (48, 56, 56, 128): ("cluster", "cluster"),
            (48, 224, 224, 3): ("cluster", "cluster"),
            (2, 236, 236, 32): ("two_pass", "cluster"),
            (2, 237, 237, 32): ("two_pass", "two_pass")}
# The SPN path's six bf16 sites at batch 48 (227 -> 114 -> 57 -> 114 -> 228)
# -> plan()'s path. 227^2 x 32 goes two-pass: its 3.3 MB slab (2^6 * 227^2
# bytes) splits on 16-byte bounds only into 1, 2 or 4 ranges, none of which
# fits one block; 228^2 x 32 takes 16 ranges.
SPN_B2_SITES = {(48, 227, 227, 32): "two_pass", (48, 114, 114, 64): "cluster",
                (48, 57, 57, 128): "cluster", (48, 228, 228, 32): "cluster",
                (48, 228, 228, 3): "cluster"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(B2_PATHS))
def test_instance_norm_film_kernel(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, device=dev, generator=g) * 0.5 + 5.0).to(dtype)
    gam = torch.randn(shape[0], shape[3], device=dev, generator=g)
    bet = torch.randn(shape[0], shape[3], device=dev, generator=g)
    path = plan_on_card(shape, dtype, dev).path
    assert path == B2_PATHS[shape][dtype == torch.bfloat16]
    before = _build.launches["instance_norm_film"]
    on_path = path_calls[path]
    for args, relu in (((None, None), False), ((gam, bet), True), ((gam, bet), False)):
        _check(instance_norm_film(x, *args, relu=relu),
               instance_norm_film_plain(x, *args, relu=relu), TOL[dtype])
    assert _build.launches["instance_norm_film"] == before + 3
    assert path_calls[path] == on_path + 3


@pytest.mark.parametrize("shape", list(SPN_B2_SITES))
def test_instance_norm_film_spn_sites(dev, shape):
    """Each SPN site in bf16 runs the path plan() gives it, on the card's own
    cluster occupancy too, and matches the plain version."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(shape, device=dev, generator=g).to(torch.bfloat16)
    gam = torch.randn(shape[0], shape[3], device=dev, generator=g)
    bet = torch.randn(shape[0], shape[3], device=dev, generator=g)
    path = plan_on_card(shape, torch.bfloat16, dev).path
    assert path == SPN_B2_SITES[shape]
    on_path = path_calls[path]
    _check(instance_norm_film(x, gam, bet, relu=True),
           instance_norm_film_plain(x, gam, bet, relu=True), TOL[torch.bfloat16])
    assert path_calls[path] == on_path + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 9, 9, 128), (1, 13, 6, 40),
                                   (48, 56, 56, 128), (48, 57, 57, 128), (3, 2, 5, 16),
                                   (1, 9, 9, 136)])
def test_resblock_kernel(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    C = shape[3]
    args = ([torch.randn(3, 3, C, C, device=dev, generator=g) / (9 * C) ** 0.5,
             torch.randn(C, device=dev, generator=g) * 0.1,
             torch.randn(3, 3, C, C, device=dev, generator=g) / (9 * C) ** 0.5,
             torch.randn(C, device=dev, generator=g) * 0.1]
            + [torch.randn(shape[0], C, device=dev, generator=g) for _ in range(4)])
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    tol = (5e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    before = _build.launches["ghiasi_resblock"]
    _check(ghiasi_resblock(x, *args), ghiasi_resblock_plain(x, *args), tol)
    assert _build.launches["ghiasi_resblock"] == before + 1


@pytest.mark.parametrize("shape,match", [((1, 4, 400, 128), "shared memory"),
                                         ((1, 8, 8, 12), "multiple of 8")])
def test_resblock_rejects_what_the_kernel_does_not_take(dev, shape, match):
    """Rows wider than one block's shared memory holds, and channels that are
    no whole 16-byte groups, are refused with the limit named; there is no
    fallback."""
    B, C = shape[0], shape[3]
    x = torch.zeros(shape, device=dev)
    args = ([torch.zeros(3, 3, C, C, device=dev), torch.zeros(C, device=dev)] * 2
            + [torch.zeros(B, C, device=dev) for _ in range(4)])
    with pytest.raises(ValueError, match=match):
        ghiasi_resblock(x, *args)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(2, 8, 8, 16, device=dev)
    with pytest.raises(ValueError):
        instance_norm_film(x.permute(0, 2, 1, 3))  # not contiguous
    with pytest.raises(ValueError):
        instance_norm_film(x.half())
    with pytest.raises(ValueError):
        instance_norm_film(x, torch.ones(2, 16, device=dev, dtype=torch.bfloat16))


def test_keypoints_to_pose_on_card_matches_cpu(dev):
    rs = np.random.RandomState(0)
    B = 48
    fx = 0.0176 / 5.86e-6
    K = torch.tensor([[fx, 0, 960], [0, fx, 600], [0, 0, 1.0]])
    dist = torch.tensor([-0.2238, 0.5141, -6.65e-4, -2.14e-4, -0.1312])
    P = torch.from_numpy(rs.uniform(-0.4, 0.4, (11, 3)).astype(np.float32))
    q = torch.from_numpy(rs.randn(B, 4).astype(np.float32))
    q = q / q.norm(dim=1, keepdim=True)
    t = torch.from_numpy(np.stack([rs.uniform(-0.6, 0.6, B), rs.uniform(-0.4, 0.4, B),
                                   rs.uniform(3.5, 9.0, B)], 1).astype(np.float32))
    uv = project_keypoints(q, t, K, dist, P).mT + torch.from_numpy(
        rs.randn(B, 11, 2).astype(np.float32))
    lo, hi = uv.amin(1), uv.amax(1)
    c, half = (lo + hi) / 2, 0.6 * (hi - lo).amax(1)
    bbox = torch.stack([c[:, 0] - half, c[:, 0] + half, c[:, 1] - half, c[:, 1] + half], 1)
    x = (uv[..., 0] - bbox[:, 0:1]) / (2 * half[:, None])
    y = (uv[..., 1] - bbox[:, 2:3]) / (2 * half[:, None])
    args = (x, y, bbox, P, K, dist)
    q_cpu, t_cpu = keypoints_to_pose(*args)
    on_card = [a.to(dev) for a in args]
    keypoints_to_pose(*on_card)  # first call makes the cached index tensors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q_gpu, t_gpu = keypoints_to_pose(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graphed = CudaGraphed(lambda *a: dict(zip("qt", keypoints_to_pose(*a))))
    for _ in range(2):  # capture, then replay
        out = graphed(*on_card)
        assert torch.equal(out["q"], q_gpu) and torch.equal(out["t"], t_gpu)
    q_gpu, t_gpu = q_gpu.cpu(), t_gpu.cpu()
    sign = torch.sign((q_gpu * q_cpu).sum(1, keepdim=True))
    assert torch.isfinite(q_gpu).all() and torch.isfinite(t_gpu).all()
    assert (q_gpu * sign - q_cpu).abs().max() <= 1e-4
    assert (t_gpu - t_cpu).abs().max() <= 1e-3


def test_spn_pose_on_card_matches_cpu(dev):
    """Top-k, softmax, weighted quaternion mean and Gauss-Newton position at
    batch 48 on the card: no host sync, the graph replay equals the eager
    call, and q within 1e-4, t within 1e-3 m of the CPU."""
    rs = np.random.RandomState(1)
    B, NC = 48, 500
    fx = 0.0176 / 5.86e-6
    K = torch.tensor([[fx, 0, 960], [0, fx, 600], [0, 0, 1.0]])
    dist = torch.tensor([-0.2238, 0.5141, -6.65e-4, -2.14e-4, -0.1312])
    P = torch.from_numpy(rs.uniform(-0.4, 0.4, (11, 3)).astype(np.float32))
    q_class = torch.from_numpy(rs.randn(NC, 4).astype(np.float32))
    q_class = q_class / q_class.norm(dim=1, keepdim=True)
    q = q_class[:B]
    t = torch.from_numpy(np.stack([rs.uniform(-0.6, 0.6, B), rs.uniform(-0.4, 0.4, B),
                                   rs.uniform(3.5, 9.0, B)], 1).astype(np.float32))
    uv = project_keypoints(q, t, K, dist, P)
    bbox = torch.stack([uv[:, 0].amin(1), uv[:, 0].amax(1), uv[:, 1].amin(1),
                        uv[:, 1].amax(1)], 1)
    logits = torch.from_numpy(rs.randn(B, NC).astype(np.float32))
    logits[torch.arange(B), torch.arange(B)] += 8.0  # the true class on top
    args = (logits, bbox, q_class, P, K, dist)
    q_cpu, t_cpu = spn_pose(*args, 5)
    on_card = [a.to(dev) for a in args]
    spn_pose(*on_card, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q_gpu, t_gpu = spn_pose(*on_card, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graphed = CudaGraphed(lambda *a: dict(zip("qt", spn_pose(*a, 5))))
    for _ in range(2):  # capture, then replay
        out = graphed(*on_card)
        assert torch.equal(out["q"], q_gpu) and torch.equal(out["t"], t_gpu)
    q_gpu, t_gpu = q_gpu.cpu(), t_gpu.cpu()
    sign = torch.sign((q_gpu * q_cpu).sum(1, keepdim=True))
    assert torch.isfinite(q_gpu).all() and torch.isfinite(t_gpu).all()
    assert (q_gpu * sign - q_cpu).abs().max() <= 1e-4
    assert (t_gpu - t_cpu).abs().max() <= 1e-3


def test_style_predictor_on_card_matches_cpu(dev):
    """The StylePredictor's eval forward in f32 (TF32 off) at batch 8 and the
    embedding CLI's 320x480, cuDNN on the card against the CPU, within 1e-4
    of the output's scale (the same f32 convs summed in another order)."""
    from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor

    torch.manual_seed(0)
    model = StylePredictor().eval()
    rs = np.random.RandomState(2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    x = torch.from_numpy(rs.rand(8, 3, 320, 480).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    assert got.shape == (8, 100) and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max().item())
