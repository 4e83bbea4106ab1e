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
CUDA graph replay equal to the eager call; SPN's pose the same way. Under
grad, B1 and B2 still run the forward and the gradients are their plain
versions' VJPs (f32 within 1e-5, the same recomputation on the same inputs;
a bf16 input's gradient within the bf16 tolerance). Then the phase-space
Ghiasi against the plain one on the card, and two data-parallel ranks over
gloo on one card against one process.
"""
import io

import numpy as np
import pytest
import torch

from speedplusbaseline_tpu_torch.engine.steps import CudaGraphed, spn_pose
from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose, project_keypoints
from speedplusbaseline_tpu_torch.ops import _build
from speedplusbaseline_tpu_torch.ops.edgeconv import reflect_conv9x9, reflect_conv9x9_plain
from speedplusbaseline_tpu_torch.ops.instancenorm import (instance_norm_film,
                                                          instance_norm_film_plain, path_calls,
                                                          plan_on_card)
from speedplusbaseline_tpu_torch.ops.midconv import reflect_conv3x3, reflect_conv3x3_plain
from speedplusbaseline_tpu_torch.ops.resblock import ghiasi_resblock, ghiasi_resblock_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}
TOL_GRAD = {torch.float32: (1e-5, 1e-5), torch.bfloat16: TOL[torch.bfloat16]}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,film", [((2, 8, 8, 32), True), ((2, 8, 8, 32), False),
                                        ((3, 9, 7, 3), True), ((3, 9, 7, 3), False)])
def test_instance_norm_film_gradient_on_card(dev, dtype, shape, film):
    """Under grad, the kernel still runs the forward (on both plan() paths,
    with and without FiLM) and the gradients are the plain version's VJP."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(shape, device=dev, generator=g) + 2.0).to(dtype).requires_grad_()
    gb = [torch.randn(shape[0], shape[3], device=dev, generator=g).requires_grad_() if film
          else None for _ in range(2)]
    before = _build.launches["instance_norm_film"]
    out = instance_norm_film(x, *gb, relu=True)
    assert _build.launches["instance_norm_film"] == before + 1 and out.grad_fn is not None
    _check(out, instance_norm_film_plain(x, *gb, relu=True), TOL[dtype])
    cot = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    wrt = [x] + [t for t in gb if t is not None]
    got = torch.autograd.grad(out, wrt, cot)
    ref = torch.autograd.grad(instance_norm_film_plain(x, *gb, relu=True), wrt, cot)
    for a, r in zip(got, ref):
        _check(a, r, TOL_GRAD[a.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resblock_gradient_on_card(dev, dtype):
    """Under grad, B1 still runs the forward and every argument's gradient is
    the plain block's VJP, recomputed from the same inputs."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, W, C = 2, 8, 8, 128
    shapes = [(B, H, W, C), (3, 3, C, C), (C,), (3, 3, C, C), (C,)] + [(B, C)] * 4
    args = [(torch.randn(s, device=dev, generator=g) * 0.1).requires_grad_() for s in shapes]
    args[0] = args[0].detach().to(dtype).requires_grad_()
    before = _build.launches["ghiasi_resblock"]
    out = ghiasi_resblock(*args)
    assert _build.launches["ghiasi_resblock"] == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    got = torch.autograd.grad(out, args, cot)
    ref = torch.autograd.grad(ghiasi_resblock_plain(*args), args, cot)
    for a, r in zip(got, ref):
        _check(a, r, TOL_GRAD[a.dtype])


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


# (B, H, W) of the edge convs: KRN's, SPN's layer0 (227^2) and layer10
# (228^2), and small odd ones, ragged on both layers' tiles.
EDGE_SHAPES = [(192, 224, 224), (48, 227, 227), (48, 228, 228), (2, 5, 7), (3, 37, 61)]


def _edge_args(dev, cin, cout, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(*shape, cin, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(cout, cin, 9, 9, device=dev, generator=g) / (81 * cin) ** 0.5
    b = torch.randn(cout, device=dev, generator=g) * 0.1
    return x, w.to(torch.bfloat16), b.to(torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 3)])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_reflect_conv9x9_kernel(dev, cin, cout, shape):
    """The edge-conv kernel against its plain version (f32 sums of the same
    bf16 operands, rounded once) at the main paths' shapes and odd ones."""
    x, w, b = _edge_args(dev, cin, cout, shape, 5)
    before = _build.launches["reflect_conv9x9"]
    _check(reflect_conv9x9(x, w, b), reflect_conv9x9_plain(x, w, b), TOL[torch.bfloat16])
    assert _build.launches["reflect_conv9x9"] == before + 1


def test_reflect_conv9x9_gradient_on_card(dev):
    """Under grad the kernel still runs the forward, and every argument's
    gradient is the plain version's VJP."""
    args = [a.requires_grad_() for a in _edge_args(dev, 32, 3, (2, 11, 13), 6)]
    before = _build.launches["reflect_conv9x9"]
    out = reflect_conv9x9(*args)
    assert _build.launches["reflect_conv9x9"] == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    cot = cot.to(torch.bfloat16)
    got = torch.autograd.grad(out, args, cot)
    ref = torch.autograd.grad(reflect_conv9x9_plain(*args), args, cot)
    for a, r in zip(got, ref):
        _check(a, r, TOL_GRAD[a.dtype])


def test_reflect_conv9x9_rejects_what_the_kernel_does_not_take(dev):
    """f32 on the card, a side under 5 and another channel pair are refused;
    there is no fallback."""
    x, w, b = _edge_args(dev, 32, 3, (1, 9, 9), 8)
    with pytest.raises(ValueError, match="bfloat16"):
        reflect_conv9x9(x.float(), w.float(), b.float())
    with pytest.raises(ValueError, match=">= 5"):
        reflect_conv9x9(x[:, :4].contiguous(), w, b)
    with pytest.raises(ValueError, match="one of"):
        reflect_conv9x9(x[..., :16].contiguous(), w[:, :16].contiguous(), b)


# (B, H, W) inputs of the mid convs (layer1, layer2, layer8, layer9): the two
# cells' main-path shapes, KRN's (192, 224^2) and SPN's (48, 227^2) through
# the generator, and small odd ones, ragged on every layer's tiles.
MID_SHAPES = {
    "layer1": [(192, 224, 224), (48, 227, 227)],
    "layer2": [(192, 112, 112), (48, 114, 114)],
    "layer8": [(192, 56, 56), (48, 57, 57)],
    "layer9": [(192, 112, 112), (48, 114, 114)],
}
MID_SMALL = [(2, 2, 3), (2, 5, 7), (3, 37, 61), (1, 17, 33)]
MID_LAYERS = dict(zip(MID_SHAPES, ((32, 64, 2, 1), (64, 128, 2, 1), (128, 64, 1, 2),
                                   (64, 32, 1, 2))))


def _mid_args(dev, layer, shape, seed):
    cin, cout, stride, up = MID_LAYERS[layer]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(*shape, cin, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(cout, 3, 3, cin, device=dev, generator=g) / (9 * cin) ** 0.5
    b = torch.randn(cout, device=dev, generator=g) * 0.1
    return (x, w.to(torch.bfloat16), b), {"stride": stride, "upsample": up}


@pytest.mark.parametrize("layer,shape", [(n, s) for n, shapes in MID_SHAPES.items()
                                         for s in shapes + MID_SMALL])
def test_reflect_conv3x3_kernel(dev, layer, shape):
    """The mid-conv kernel against its plain version (f32 sums of the same
    bf16 products, rounded once: the two sum in another order, so an output
    may round one bf16 ulp apart, within the bf16 tolerance) at the main
    paths' shapes and odd ones."""
    args, kw = _mid_args(dev, layer, shape, 5)
    before = _build.launches["reflect_conv3x3"]
    _check(reflect_conv3x3(*args, **kw), reflect_conv3x3_plain(*args, **kw), TOL[torch.bfloat16])
    assert _build.launches["reflect_conv3x3"] == before + 1


def test_reflect_conv3x3_gradient_on_card(dev):
    """Under grad the kernel still runs the forward, and every argument's
    gradient is the plain version's VJP."""
    args, kw = _mid_args(dev, "layer8", (2, 7, 5), 6)
    args = [a.requires_grad_() for a in args]
    before = _build.launches["reflect_conv3x3"]
    out = reflect_conv3x3(*args, **kw)
    assert _build.launches["reflect_conv3x3"] == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    cot = cot.to(torch.bfloat16)
    got = torch.autograd.grad(out, args, cot)
    ref = torch.autograd.grad(reflect_conv3x3_plain(*args, **kw), args, cot)
    for a, r in zip(got, ref):
        _check(a, r, TOL_GRAD[a.dtype])


def test_reflect_conv3x3_rejects_what_the_kernel_does_not_take(dev):
    """f32 on the card, a misaligned x and another channel pair are refused;
    there is no fallback."""
    (x, w, b), kw = _mid_args(dev, "layer9", (1, 9, 9), 8)
    with pytest.raises(ValueError, match="bfloat16"):
        reflect_conv3x3(x.float(), w.float(), b, **kw)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)[1:].view(x.shape)
        reflect_conv3x3(shifted.copy_(x), w, b, **kw)
    with pytest.raises(ValueError, match="one of"):
        reflect_conv3x3(x[..., :32].contiguous(), w[..., :32].contiguous(), b, **kw)


@pytest.mark.parametrize("side", [224, 227])
def test_ghiasi_bf16_on_card_within_bound_of_f32(dev, side):
    """The bf16 generator (B1, B2, the edge convs and the mid convs) on the
    shipped weights against the f32 one on the card, within chip_smoke's
    TOL_GHIASI_BF16 (2^-6), with layer0 and layer10 on the edge-conv kernel
    and layers 1, 2, 8 and 9 on the mid-conv kernel; the f32 generator
    launches neither."""
    import os

    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    sd = load_ghiasi_params(os.path.join(default_assets_dir(), "ghiasi_params.msgpack"))
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand(2, 3, side, side, device=dev, generator=g)
    st = torch.randn(2, 100, device=dev, generator=g) * 0.5
    out, ran = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        net = Ghiasi(dtype).to(dev).eval()
        net.load_state_dict(sd)
        before = dict(_build.launches)
        with torch.no_grad():
            out[dtype] = net(x, st).float()
        ran[dtype] = tuple(_build.launches[k] - before[k]
                           for k in ("reflect_conv9x9", "reflect_conv3x3"))
    assert ran == {torch.float32: (0, 0), torch.bfloat16: (2, 4)}
    _check(out[torch.bfloat16], out[torch.float32], (2.0 ** -6, 0.0))


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


@pytest.fixture(scope="module")
def cached_data(tmp_path_factory):
    """A small dataset of the port's generator with its KRN CSVs and the
    RoI cache of its train domain (host work only: no card needed)."""
    from speedplusbaseline_tpu_torch.data import generate_fake_speedplus, json2csv
    from speedplusbaseline_tpu_torch.data.cache import build_cache

    root = str(tmp_path_factory.mktemp("cuda_data"))
    cpu = torch.device("cpu")
    generate_fake_speedplus(root, num_train=8, num_test=2, domains=("synthetic",), device=cpu)
    csv = json2csv(root, "speedplus", "synthetic", "train.json", "splits_krn/train.csv",
                   device=cpu)
    build_cache(root, "speedplus", "synthetic", [csv], f"{root}/cache", cache_size=128)
    return root


@pytest.mark.parametrize("cache,native", [(True, False), (False, True), (True, True)])
def test_cached_and_native_loaders_feed_the_card(dev, cached_data, cache, native):
    """The loader from the RoI cache and/or through the native core lands
    pinned batches on the card, equal to the same loader's CPU batches. The
    native cases need libjpeg's headers and library on the machine."""
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.data import DataLoader, KRNDataset
    from speedplusbaseline_tpu_torch.native import native_available

    if native and not native_available():
        pytest.skip("the native decode core cannot be built here (no libjpeg headers)")

    cfg = default_cfg(dataroot=cached_data, input_shape=(64, 64),
                      cache_dir=f"{cached_data}/cache" if cache else "",
                      use_native_loader=native)
    ds = KRNDataset(cfg)
    assert (ds.cache is not None) == cache and ds.use_native == native
    on_card = list(DataLoader(ds, 4, dev, num_workers=4, seed=3))
    on_cpu = list(DataLoader(ds, 4, torch.device("cpu"), num_workers=4, seed=3))
    assert len(on_card) == len(on_cpu) == 2
    for g, c in zip(on_card, on_cpu):
        torch.cuda.synchronize()
        for k in ("image", "keypts"):
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k].cpu(), c[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", [224, 227])
def test_ghiasi_phase_space_on_card_matches_plain(dev, dtype, side):
    """The phase-space lowering against the plain one on the card, both with
    B1 and B2, at the main paths' sides and batch 2 on the shipped weights:
    227 against the plain lowering of the input reflect-padded to 228. f32
    within 1e-4 + 1e-4 |ref| (convs summed in another order); bf16 against
    the plain f32 output within 2^-6 (chip_smoke's bf16 generator bound)."""
    import os

    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    sd = load_ghiasi_params(os.path.join(default_assets_dir(), "ghiasi_params.msgpack"))
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(2, 3, side, side, device=dev, generator=g)
    st = torch.randn(2, 100, device=dev, generator=g) * 0.5
    nets = {}
    for phase in (False, True):
        nets[phase] = Ghiasi(torch.float32 if not phase else dtype, phase_space=phase).to(dev)
        nets[phase].load_state_dict(sd)
    with torch.no_grad():
        ref = nets[False](F.pad(x, (0, -side % 4, 0, -side % 4), mode="reflect"), st)
        got = nets[True](x, st)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2.0 ** -6, 0.0)
    _check(got.float(), ref, tol)


@pytest.mark.parametrize("seed", [1, 32])
def test_ghiasi_bf16_flax_init_within_rule_of_jax(dev, seed):
    """K(s): the bf16 generator with B1 and B2 on the card against the plain
    f32 generator on the CPU, on the flax-init weights of ``seed`` and
    chip_smoke phase ghiasi's inputs, held to JAX's bf16 generator at the
    same weights by chip_smoke's rule (max within 1.5x, mean within 1.25x
    of ``chip_smoke.JAX_GHIASI_BF16``, which tests/test_torch_ghiasi_bf16.py
    holds to JAX)."""
    import os
    import sys

    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    x, st = chip_smoke.ghiasi_inputs()
    net = Ghiasi().eval()
    net.load_state_dict(chip_smoke.flax_init_ghiasi(seed))
    card = Ghiasi(torch.bfloat16).to(dev).eval()
    card.load_state_dict(net.state_dict())
    before = dict(_build.launches)
    with torch.no_grad():
        ref = net(x, st)
        got = card(x.to(dev), st.to(dev)).float().cpu()
    assert {k: _build.launches[k] - v for k, v in before.items()} == {
        "instance_norm_film": 6, "ghiasi_resblock": 5, "reflect_conv9x9": 2,
        "reflect_conv3x3": 4}
    err = (got - ref).abs()
    assert not chip_smoke.ghiasi_bf16_fault(seed, err.max().item(), err.mean().item()), (
        err.max().item(), err.mean().item(), chip_smoke.JAX_GHIASI_BF16[seed])


def test_two_ranks_over_gloo_on_the_card(dev):
    """Two ranks on one card over gloo with CUDA tensors: one f32 step (TF32
    off) of the KRN trainer at the main path's 224^2, global batch 32, SGD
    at 1e-2 as the JAX DP test, against the one-process step on the same
    batch, within that test's 1e-4; both ranks end equal."""
    import test_torch_parallel_ranks as ranks
    from speedplusbaseline_tpu_torch.parallel import spawn

    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (32, 224, 224, 3)).astype(np.uint8),
             "keypts": rs.rand(32, 2, 11).astype(np.float32)}
    cfg = dict(model_name="krn", input_shape=(224, 224), batch_size=32, optimizer="sgd",
               lr=1e-2, momentum=0.0, weight_decay=0.0)
    cases = [dict(kind="krn", cfg=cfg, seed=1, batch=batch, dtype="float32")]
    two = spawn(ranks.run, (cases, "cuda:0"), 2, "gloo")[0]
    one = ranks.run(cases, dev)[0]
    assert two["spread"] == 0.0
    for k, v in one["state"].items():
        assert np.abs(two["state"][k] - v).max() <= 1e-4, k
    assert two["losses"]["loss_x"] == pytest.approx(one["losses"]["loss_x"], rel=1e-4)


def _spn_shaped(dev, g):
    """Random f32 tensors of SPN's 22 parameter shapes (152M) on the card."""
    from speedplusbaseline_tpu_torch.models.spn import SpacecraftPoseNet

    with torch.device("meta"):
        shapes = [p.shape for p in SpacecraftPoseNet(5000, input_shape=(227, 227)).parameters()]
    return [torch.randn(s, device=dev, generator=g) * 0.05 for s in shapes]


def _norm_gap(a, b):
    return float((a - b).norm() / b.norm())


def _adam_steps(pairs, g, n):
    """``n`` steps of each optimizer of ``pairs`` ((optimizer, params), ...)
    on the same random grads."""
    for _ in range(n):
        grads = [torch.randn(p.shape, device=p.device, generator=g) for p in pairs[0][1]]
        for opt, params in pairs:
            for p, grad in zip(params, grads):
                p.grad = grad.clone()
            opt.step()


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_build_optimizer_is_fused_on_spn_shapes(dev, name):
    """On SPN's 22 parameter shapes (152M f32 on the card) build_optimizer's
    Adam and AdamW take torch's fused update; after three steps each
    parameter is torch's foreach update's within 1e-6 of its norm, and its
    change within 1e-5. The fused kernel takes 1 - beta in f32 from the f32
    betas (1 - 0.999f is 1.29e-5 under 0.001), so its second moment sits
    1.3e-5 from foreach's (norm within 2e-5; the change reads 1.7e-6 to
    2.4e-6 of its norm). SGD and RMSprop keep torch's default update."""
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.engine import optim

    g = torch.Generator(device=dev).manual_seed(0)
    init = _spn_shaped(dev, g)
    cfg = default_cfg(optimizer=name, lr=1e-3, momentum=0.9, weight_decay=0.01)
    ours = [torch.nn.Parameter(t.clone()) for t in init]
    opt = optim.build_optimizer(cfg, ours)
    assert type(opt) is {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}[name]
    assert opt.defaults["fused"] is True and opt.param_groups[0]["fused"] is True
    ref = [torch.nn.Parameter(t.clone()) for t in init]
    ref_opt = type(opt)(ref, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                        foreach=True)
    _adam_steps([(opt, ours), (ref_opt, ref)], g, 3)
    for p, q, p0 in zip(ours, ref, init):
        assert _norm_gap(p.detach(), q.detach()) <= 1e-6
        assert _norm_gap(p.detach() - p0, q.detach() - p0) <= 1e-5
        assert _norm_gap(opt.state[p]["exp_avg_sq"], ref_opt.state[q]["exp_avg_sq"]) <= 2e-5
        assert opt.state[p]["step"].device == p.device and float(opt.state[p]["step"]) == 3
    del ref_opt, ref, init
    for other in ("sgd", "rmsprop"):
        plain = optim.build_optimizer(default_cfg(optimizer=other), ours[-1:])
        assert not plain.defaults.get("fused") and not plain.param_groups[0].get("fused")


def test_build_optimizer_resumes_a_foreach_adamw_state(dev):
    """A state that torch's foreach AdamW wrote on the card after three steps
    (its ``step`` a CPU tensor, as in every checkpoint of the port before the
    fused update) loads into build_optimizer's AdamW fused, with each
    ``step`` moved to its parameter's device; the next step then gives the
    foreach writer's own next step within the bounds of the test above."""
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.engine import optim

    g = torch.Generator(device=dev).manual_seed(1)
    ref = [torch.nn.Parameter(t) for t in _spn_shaped(dev, g)]
    writer = torch.optim.AdamW(ref, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                               foreach=True)
    _adam_steps([(writer, ref)], g, 3)
    buf = io.BytesIO()  # as a checkpoint: the loaded state shares no tensor with the writer's
    torch.save(writer.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert all(st["step"].device.type == "cpu" for st in saved["state"].values())
    ours = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    opt = optim.build_optimizer(
        default_cfg(optimizer="adamw", lr=1e-3, momentum=0.9, weight_decay=0.01), ours)
    opt.load_state_dict(saved)
    assert opt.param_groups[0]["fused"] is True
    for p in ours:
        assert opt.state[p]["step"].device == p.device and float(opt.state[p]["step"]) == 3
    before = [p.detach().clone() for p in ref]
    _adam_steps([(opt, ours), (writer, ref)], g, 1)
    for p, q, p0 in zip(ours, ref, before):
        assert _norm_gap(p.detach(), q.detach()) <= 1e-6
        assert _norm_gap(p.detach() - p0, q.detach() - p0) <= 1e-5
        assert _norm_gap(opt.state[p]["exp_avg_sq"], writer.state[q]["exp_avg_sq"]) <= 2e-5
        assert float(opt.state[p]["step"]) == float(writer.state[q]["step"]) == 4
