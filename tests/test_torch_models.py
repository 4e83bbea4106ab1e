"""Port models against the JAX package on the same weights (through
convert.py in both directions) and the same numpy inputs.

Weights are made by the port's own init, then converted to flax trees (so
the JAX side compiles only what it applies). Tolerances: forwards within
1e-4 of the output's scale (f32 convs summed in another order); train-mode
forwards within 1e-3, because flax's one-pass batch variance
E[x^2] - E[x]^2 over the few values of the late 2x2 maps is itself 3e-4 off
a float64 evaluation at these sizes (the port's two-pass one is 1e-4 off);
gradients in float64 (see test_krn_loss_grads); BatchNorm running
statistics within 1e-4 relative.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.krn import krn_loss as jax_krn_loss
from speedplusbaseline_tpu.models.layers import ConvBN as JaxConvBN
from speedplusbaseline_tpu.models.layers import RouterV3 as JaxRouterV3
from speedplusbaseline_tpu.models.layers import space_to_depth as jax_s2d
from speedplusbaseline_tpu.models.mobilenetv2 import MobileNetV2Features as JaxMNv2
from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
from speedplusbaseline_tpu_torch.convert import (flax_to_state_dict,
                                                 read_flax_msgpack,
                                                 state_dict_to_flax)
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.models.krn import KeypointRegressionNet, krn_loss
from speedplusbaseline_tpu_torch.models.layers import (BatchNorm, ConvBN, RouterV3,
                                                       space_to_depth)
from speedplusbaseline_tpu_torch.models.mobilenetv2 import MobileNetV2Features

torch.set_num_threads(1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=rel * max(1.0, np.abs(ref).max()))


def tree_close(ours, ref, atol, rtol=0.0):
    flat_o = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_o.keys() == flat_r.keys()
    for k in flat_r:
        np.testing.assert_allclose(np.asarray(flat_o[k]), np.asarray(flat_r[k]),
                                   atol=atol, rtol=rtol, err_msg=str(k))


S = 64


@pytest.fixture(scope="module")
def krn():
    """The port's KRN at 64^2 with non-trivial running stats, and its flax
    (params, batch_stats)."""
    torch.manual_seed(0)
    ours = KeypointRegressionNet(11, (S, S))
    rs = np.random.RandomState(0)
    for name, buf in ours.named_buffers():
        buf.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    params, stats = state_dict_to_flax(ours.state_dict())
    return JaxKRN(11), params, stats, ours


def fresh_port(params, stats):
    ours = KeypointRegressionNet(11, (S, S))
    ours.load_state_dict(flax_to_state_dict(params, stats))
    return ours


def jax_apply(model, variables, x, **kw):
    fn = jax.jit(lambda v, x: model.apply(v, x, **kw))
    with jax.default_matmul_precision("float32"):
        return jax.device_get(fn(variables, jnp.asarray(x)))


def test_krn_eval_forward(krn):
    model, params, stats, _ = krn
    ours = fresh_port(params, stats)
    x = np.random.RandomState(1).rand(2, S, S, 3).astype(np.float32)
    xc, yc = jax_apply(model, {"params": params, "batch_stats": stats}, x, train=False)
    ours.eval()
    with torch.no_grad():
        oxc, oyc = ours(nchw(x))
    close(oxc, xc)
    close(oyc, yc)


def test_krn_train_forward_and_running_stats(krn):
    """Train mode: batch statistics, and flax's BIASED running-variance
    update (torch's BatchNorm2d would use the unbiased one)."""
    model, params, stats, _ = krn
    ours = fresh_port(params, stats)
    x = np.random.RandomState(2).rand(3, S, S, 3).astype(np.float32)
    (xc, yc), mut = jax_apply(model, {"params": params, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
    ours.train()
    with torch.no_grad():
        oxc, oyc = ours(nchw(x))
    close(oxc, xc, rel=1e-3)
    close(oyc, yc, rel=1e-3)
    _, new_stats = state_dict_to_flax(ours.state_dict())
    tree_close(new_stats, mut["batch_stats"], atol=0.0, rtol=1e-4)


def test_krn_loss_grads(krn):
    """krn_loss and its gradients through the whole train-mode KRN, in
    float64 on both sides: at random init the f32 gradients are chaotic (the
    port's own f32 and f64 gradients differ by 2% median at this size), so
    f32 could not tell a wrong gradient from rounding. A BatchNorm bias
    whose output only reaches the loss through another train-mode BatchNorm
    has a zero gradient in exact arithmetic, so each leaf's tolerance,
    1e-3 of its max-abs, has a floor of 1e-9 of the largest gradient."""
    _, params, stats, _ = krn
    ours = fresh_port(params, stats).double().train()
    rs = np.random.RandomState(3)
    x = rs.rand(2, S, S, 3)
    target = rs.rand(2, 2, 11)
    model = JaxKRN(11, dtype=jnp.float64)

    with jax.enable_x64():
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                          (params, stats))

        def loss_fn(p):
            (xc, yc), _ = model.apply({"params": p, "batch_stats": s64},
                                      jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
            return jax_krn_loss(xc, yc, jnp.asarray(target))

        (loss, parts), grads = jax.device_get(
            jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64))
    oxc, oyc = ours(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    oloss, oparts = krn_loss(oxc, oyc, torch.from_numpy(target))
    oloss.backward()
    np.testing.assert_allclose(oloss.item(), float(loss), rtol=1e-9)
    np.testing.assert_allclose(oparts["loss_x"].item(), float(parts["loss_x"]), rtol=1e-9)
    ograds, _ = state_dict_to_flax({k: p.grad for k, p in ours.named_parameters()})
    flat_o = dict(jax.tree_util.tree_leaves_with_path(ograds))
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    floor = 1e-9 * max(np.abs(g).max() for _, g in leaves)
    assert len(flat_o) == len(leaves)
    for k, g in leaves:
        np.testing.assert_allclose(flat_o[k], g, atol=1e-3 * max(np.abs(g).max(), floor),
                                   err_msg=jax.tree_util.keystr(k))


def test_mobilenetv2_features_and_tap():
    torch.manual_seed(1)
    ours = MobileNetV2Features().eval()
    params, stats = state_dict_to_flax(ours.state_dict())
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    feat, tap = jax_apply(JaxMNv2(), {"params": params, "batch_stats": stats}, x,
                          train=False)
    with torch.no_grad():
        ofeat, otap = ours(nchw(x))
    assert tuple(otap.shape) == (2, 96, 4, 4) and tuple(ofeat.shape) == (2, 320, 2, 2)
    close(ofeat.permute(0, 2, 3, 1), feat)
    close(otap.permute(0, 2, 3, 1), tap)


def test_convert_round_trip(krn):
    _, params, stats, _ = krn
    ours = fresh_port(params, stats)
    p2, s2 = state_dict_to_flax(flax_to_state_dict(params, stats))
    tree_close(p2, params, atol=0)
    tree_close(s2, stats, atol=0)
    # depthwise (3, 3, 1, C) HWIO -> (C, 1, 3, 3)
    sd = ours.state_dict()
    assert tuple(sd["base.block1.depthwise.conv.weight"].shape) == (32, 1, 3, 3)
    assert tuple(sd["head.weight"].shape) == (22, 1024, 2, 2)
    # RouterV2's explicit "conv" holds flax's automatic Conv_0
    assert p2["router"]["conv"]["Conv_0"]["kernel"].shape == (1, 1, 96, 64)


@pytest.mark.parametrize("weights", ["asset", "random"])
def test_ghiasi_forward(weights):
    rs = np.random.RandomState(5)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    st = (rs.randn(2, 100) * 0.5).astype(np.float32)
    torch.manual_seed(2)
    ours = Ghiasi().eval()
    if weights == "asset":
        path = f"{default_assets_dir()}/ghiasi_params.msgpack"
        params = read_flax_msgpack(path)
        ours.load_state_dict(load_ghiasi_params(path))
    else:
        params, _ = state_dict_to_flax(ours.state_dict())
    fn = jax.jit(lambda p, x, s: JaxGhiasi().apply({"params": p}, x, s))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(st)))
    with torch.no_grad():
        out = ours(nchw(x), torch.from_numpy(st)).permute(0, 2, 3, 1).numpy()
    close(out, ref)


def test_space_to_depth_channel_order():
    """Channel (s_h*2 + s_w)*C + c, as JAX; F.pixel_unshuffle differs."""
    x = np.random.RandomState(6).rand(2, 4, 6, 3).astype(np.float32)
    ref = np.asarray(jax_s2d(jnp.asarray(x), 2))
    ours = space_to_depth(nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(ours, ref)
    unshuffled = F.pixel_unshuffle(nchw(x), 2).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(unshuffled, ref)


@pytest.mark.parametrize("k,stride", [(3, 2), (3, 1), (1, 1)])
def test_convbn_padding_matches_jax(k, stride):
    """Torch-style symmetric k//2 padding, as JAX's ``torch_pad``; XLA's SAME
    would pad a stride-2 3x3 conv on an even input by (0, 1) and differ."""
    torch.manual_seed(3)
    ours = ConvBN(4, 6, k, stride, act=F.relu6).eval()
    params, stats = state_dict_to_flax(ours.state_dict())
    x = np.random.RandomState(8).rand(2, 8, 8, 4).astype(np.float32)
    ref = jax_apply(JaxConvBN(6, k, stride, act=jax.nn.relu6),
                    {"params": params, "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        close(ours(nchw(x)).permute(0, 2, 3, 1), ref)
        if stride == 2:
            same = F.conv2d(F.pad(nchw(x), (0, 1, 0, 1)), ours.conv.weight, stride=2)
            assert not torch.allclose(ours.conv(nchw(x)), same, atol=1e-3)


def test_batchnorm_running_var_is_biased():
    """n = B*H*W = 8: flax's biased update differs from nn.BatchNorm2d's."""
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 4, 2, 2).astype(np.float32))
    ours, ref = BatchNorm(4), torch.nn.BatchNorm2d(4)
    ours(x)
    ref(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(), (0.9 + 0.1 * biased).numpy(),
                               rtol=1e-6)
    assert not torch.allclose(ours.running_var, ref.running_var, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("side", [5, 8])
def test_router_v3_matches_flax(side, dtype):
    """RouterV3 in eval mode, weights through convert.py both ways: the 2x
    bilinear upsample is jax.image.resize's half-pixel one, borders included
    (F.interpolate with align_corners=False; True differs). f32 within 1e-5
    of the output's scale, float64 within 1e-12."""
    torch.manual_seed(9)
    ours = RouterV3(6, 4).eval()
    rs = np.random.RandomState(side)
    for buf in ours.buffers():
        buf.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    params, stats = state_dict_to_flax(ours.state_dict())
    assert params["conv"]["Conv_0"]["kernel"].shape == (1, 1, 6, 4)
    ours.load_state_dict(flax_to_state_dict(params, stats))
    x1 = rs.randn(2, side, side, 6).astype(dtype)
    x2 = rs.randn(2, 2 * side, 2 * side, 3).astype(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    with jax.enable_x64(dtype == "float64"):
        p, st = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), (params, stats))
        fn = jax.jit(lambda v, a, b: JaxRouterV3(4, dtype=jdt).apply(v, a, b, train=False))
        with jax.default_matmul_precision("float32"):
            ref = np.asarray(fn({"params": p, "batch_stats": st}, jnp.asarray(x1),
                                jnp.asarray(x2)))
    assert ref.dtype == np.dtype(dtype) and ref.shape == (2, 2 * side, 2 * side, 7)
    ours = ours.to(getattr(torch, dtype))
    with torch.no_grad():
        out = ours(nchw(x1), nchw(x2))
        corners = torch.cat([F.interpolate(ours.conv(nchw(x1)), scale_factor=2,
                                           mode="bilinear", align_corners=True), nchw(x2)], 1)
    close(out.permute(0, 2, 3, 1), ref, rel=1e-5 if dtype == "float32" else 1e-12)
    assert not np.allclose(corners.permute(0, 2, 3, 1).numpy(), ref, atol=1e-3)
