"""The port's phase-space Ghiasi lowering (``ops/phase_conv.py``,
``Ghiasi(phase_space=True)``) against the JAX package's
(``speedplusbaseline_tpu/ops/phase_conv.py``, ``Ghiasi(tpu_opt=True)``) on the
same numpy inputs, the JAX side under ``default_matmul_precision("float32")``:
space-to-depth and every weight and pad rewrite bit for bit, the convs and
norms within 1e-5 (2e-5 for the 9x9 convs, as tests/test_phase_conv.py), at
that file's shapes. Then the rewrites' equivalences in the port alone, as
tests/test_phase_conv.py holds them in JAX: against reflect-pad + conv,
upsample + conv and full-resolution instance norm. Then the whole generator:
against JAX's at 32^2 and 27x31 with asset and random weights (within
tests/test_torch_models.py::test_ghiasi_forward's 1e-4 of scale), against
the port's plain lowering (1e-5; at 27x31 on the reflect-padded input), and
a checkpoint loaded after construction reaching the cached phase kernels.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.ops import phase_conv as jpc
from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
from speedplusbaseline_tpu_torch.convert import read_flax_msgpack, state_dict_to_flax
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi, reflect_pad, upsample_nearest
from speedplusbaseline_tpu_torch.models.weight_convert import convert_ghiasi
from speedplusbaseline_tpu_torch.ops import instance_norm_film_plain
from speedplusbaseline_tpu_torch.ops import phase_conv as pc

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def jx(fn, *args, **kw):
    with jax.default_matmul_precision("float32"):
        return np.asarray(fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args), **kw))


def close(ours, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-5, atol=atol)


@pytest.fixture
def rs():
    return np.random.RandomState(2021)


# ------------------------------------------------------ each function vs JAX


def test_space_to_depth_bit_for_bit(rs):
    x = rs.rand(2, 8, 12, 5).astype(np.float32)
    s2d = pc.space_to_depth2(t(x)).numpy()
    np.testing.assert_array_equal(s2d, jx(jpc.space_to_depth2, x))
    np.testing.assert_array_equal(pc.depth_to_space2(t(s2d)).numpy(),
                                  jx(jpc.depth_to_space2, s2d))
    np.testing.assert_array_equal(pc.depth_to_space2(pc.space_to_depth2(t(x))).numpy(), x)
    nchw = t(x.transpose(0, 3, 1, 2))
    unshuffled = F.pixel_unshuffle(nchw, 2).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(unshuffled, s2d)  # the channel-order trap


@pytest.mark.parametrize("name,shape", [
    ("phase_weights_s2", (3, 3, 6, 7)), ("phase_weights_s2_aligned", (3, 3, 6, 7)),
    ("phase_weights_9x9", (9, 9, 3, 4)), ("phase_weights_9x9_dp", (9, 9, 3, 3)),
])
def test_weight_rewrites_bit_for_bit(rs, name, shape):
    w = (rs.randn(*shape) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(getattr(pc, name)(t(w)).numpy(),
                                  jx(getattr(jpc, name), w))


def test_upsample_weights_match_jax(rs):
    """Each aligned subpixel tap is a sum of up to four original taps."""
    w = (rs.randn(3, 3, 6, 5) * 0.3).astype(np.float32)
    close(pc.phase_weights_up_aligned(t(w)), jx(jpc.phase_weights_up_aligned, w), 1e-6)


@pytest.mark.parametrize("name,shape", [("phase_pad_s2", (2, 8, 12, 24)),
                                        ("phase_pad_9x9", (2, 9, 11, 12))])
def test_pads_bit_for_bit(rs, name, shape):
    x4 = rs.rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(getattr(pc, name)(t(x4)).numpy(),
                                  jx(getattr(jpc, name), x4))


@pytest.mark.parametrize("name,x_shape,w_shape,atol", [
    ("conv3x3_s2_phase", (2, 16, 24, 6), (3, 3, 6, 7), 1e-5),
    ("conv3x3_s2_phase_aligned", (2, 16, 24, 6), (3, 3, 6, 7), 1e-5),
    ("upconv3x3_phase_packed", (2, 9, 13, 6), (3, 3, 6, 5), 1e-5),
    ("conv9x9_phase", (2, 18, 22, 3), (9, 9, 3, 4), 2e-5),
    ("conv9x9_phase_dp", (2, 20, 24, 3), (9, 9, 3, 3), 2e-5),
])
def test_convs_match_jax(rs, name, x_shape, w_shape, atol):
    x = rs.rand(*x_shape).astype(np.float32)
    w = (rs.randn(*w_shape) * 0.3).astype(np.float32)
    b = rs.randn(w_shape[-1]).astype(np.float32)
    x_in = x if name == "upconv3x3_phase_packed" else jx(jpc.space_to_depth2, x)
    close(getattr(pc, name)(t(x_in), t(w), t(b)), jx(getattr(jpc, name), x_in, w, b), atol)


@pytest.mark.parametrize("shape,phases,film", [((2, 8, 10, 12), 4, True),
                                               ((2, 8, 10, 12), 4, False),
                                               ((2, 5, 6, 48), 16, True)])
def test_packed_instance_norm_matches_jax(rs, shape, phases, film):
    z = (rs.rand(*shape) * 3 - 1).astype(np.float32)
    c = shape[-1] // phases
    g = (rs.rand(2, c) + 0.5).astype(np.float32) if film else None
    b = rs.randn(2, c).astype(np.float32) if film else None
    ours = pc.phase_instance_norm_packed(t(z), *(None if a is None else t(a) for a in (g, b)),
                                         phases=phases)
    close(ours, jx(jpc.phase_instance_norm_packed, z, g, b, phases=phases))


@pytest.mark.parametrize("phase_axis", [None, 3])
def test_phase_instance_norm_matches_jax(rs, phase_axis):
    shape = (2, 8, 10, 12) if phase_axis is None else (2, 8, 10, 4, 5)
    z = rs.rand(*shape).astype(np.float32)
    c = shape[-1] // 4 if phase_axis is None else shape[-1]
    g = (rs.rand(2, c) + 0.5).astype(np.float32)
    b = rs.randn(2, c).astype(np.float32)
    ours = pc.phase_instance_norm(t(z), t(g), t(b), phase_axis=phase_axis)
    close(ours, jx(jpc.phase_instance_norm, z, g, b, phase_axis=phase_axis))


def test_bf16_keeps_the_input_dtype(rs):
    """Convs in the input's dtype, norms with f32 statistics, output in the
    input's dtype, as the JAX functions."""
    x = t(rs.rand(2, 8, 8, 12).astype(np.float32)).bfloat16()
    w = t((rs.randn(9, 9, 3, 4) * 0.2).astype(np.float32))
    assert pc.conv9x9_phase(x, w).dtype == torch.bfloat16
    assert pc.phase_instance_norm_packed(x).dtype == torch.bfloat16


# --------------------------------------------- the equivalences, port alone


def conv_ref(x, w, stride=1):
    """VALID NHWC conv with HWIO weights."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride).permute(0, 2, 3, 1)


def pad_nhwc(x, p):
    return reflect_pad(x.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", ["conv3x3_s2_phase", "conv3x3_s2_phase_aligned"])
def test_s2_phase_equals_reflect_pad_conv(rs, name):
    x = t(rs.rand(2, 16, 24, 6).astype(np.float32))
    w = t((rs.randn(3, 3, 6, 7) * 0.3).astype(np.float32))
    b = t(rs.randn(7).astype(np.float32))
    close(getattr(pc, name)(pc.space_to_depth2(x), w, b), conv_ref(pad_nhwc(x, 1), w, 2) + b)


def test_upconv_equals_upsample_reflect_pad_conv(rs):
    x = t(rs.rand(2, 9, 13, 6).astype(np.float32))
    w = t((rs.randn(3, 3, 6, 5) * 0.3).astype(np.float32))
    b = t(rs.randn(5).astype(np.float32))
    up = upsample_nearest(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    close(pc.depth_to_space2(pc.upconv3x3_phase_packed(x, w, b)),
          conv_ref(pad_nhwc(up, 1), w) + b)


def test_conv9x9_equals_reflect_pad_conv_and_dp_form(rs):
    """The 9x9 phase conv and its double-packed form equal reflect-pad-4 +
    conv; the 16-phase instance norm equals the full-resolution one."""
    x = t(rs.rand(2, 20, 24, 3).astype(np.float32))
    w = t((rs.randn(9, 9, 3, 3) * 0.2).astype(np.float32))
    b = t(rs.randn(3).astype(np.float32))
    ref = conv_ref(pad_nhwc(x, 4), w) + b
    close(pc.depth_to_space2(pc.conv9x9_phase(pc.space_to_depth2(x), w, b)), ref, 2e-5)
    ydp = pc.conv9x9_phase_dp(pc.space_to_depth2(x), w, b)
    assert ydp.shape == (2, 5, 6, 48)
    full = pc.depth_to_space2(pc.depth_to_space2(ydp))
    close(full, ref, 2e-5)
    g = t((rs.rand(2, 3) + 0.5).astype(np.float32))
    be = t(rs.randn(2, 3).astype(np.float32))
    ours = pc.depth_to_space2(pc.depth_to_space2(
        pc.phase_instance_norm_packed(ydp, g, be, phases=16)))
    np.testing.assert_allclose(ours, instance_norm_film_plain(full, g, be), rtol=1e-4, atol=1e-5)


def test_phase_instance_norms_equal_the_full_resolution_one(rs):
    y = t(rs.rand(2, 8, 10, 12).astype(np.float32))
    g = t((rs.rand(2, 3) + 0.5).astype(np.float32))
    b = t(rs.randn(2, 3).astype(np.float32))
    ref = instance_norm_film_plain(pc.depth_to_space2(y), g, b)
    close(pc.depth_to_space2(pc.phase_instance_norm(y, g, b)), ref)
    close(pc.depth_to_space2(pc.phase_instance_norm_packed(y, g, b)), ref, 2e-5)
    z = t(rs.rand(2, 8, 10, 4, 5).astype(np.float32))
    close(pc.phase_instance_norm(z, phase_axis=3).reshape(2, 8, 10, 20),
          pc.phase_instance_norm(z.reshape(2, 8, 10, 20)), 1e-6)


def test_phase_conv_is_differentiable(rs):
    x = t(rs.rand(1, 8, 8, 12).astype(np.float32)).requires_grad_()
    w = t((rs.randn(9, 9, 3, 2) * 0.2).astype(np.float32)).requires_grad_()
    pc.phase_instance_norm_packed(pc.conv9x9_phase_dp(x, w)).square().sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
    assert x.grad.abs().sum() > 0 and w.grad.abs().sum() > 0


# ---------------------------------------------------------- the generator


def _weights(kind):
    """(state_dict, flax params) of the shipped asset or of a seeded init."""
    if kind == "asset":
        path = f"{default_assets_dir()}/ghiasi_params.msgpack"
        return load_ghiasi_params(path), read_flax_msgpack(path)
    torch.manual_seed(2)
    sd = Ghiasi().state_dict()
    return sd, state_dict_to_flax(sd)[0]


def _inputs(h, w, seed=5):
    rs = np.random.RandomState(seed)
    return rs.rand(2, h, w, 3).astype(np.float32), (rs.randn(2, 100) * 0.5).astype(np.float32)


def _ghiasi(sd, **kw):
    net = Ghiasi(**kw).eval()
    net.load_state_dict(sd)
    return net


def _run(net, x, s):
    with torch.no_grad():
        return net(t(x.transpose(0, 3, 1, 2)), t(s)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", ["asset", "random"])
@pytest.mark.parametrize("hw", [(32, 32), (27, 31)])
def test_ghiasi_phase_space_matches_jax_tpu_opt(kind, hw):
    sd, params = _weights(kind)
    x, s = _inputs(*hw)
    fn = jax.jit(lambda p, x, s: JaxGhiasi(tpu_opt=True).apply({"params": p}, x, s))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(s)))
    out = _run(_ghiasi(sd, phase_space=True), x, s)
    assert out.shape == ref.shape == (2, 4 * -(-hw[0] // 4), 4 * -(-hw[1] // 4), 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["asset", "random"])
def test_ghiasi_phase_space_matches_plain_lowering(kind):
    sd, _ = _weights(kind)
    x, s = _inputs(32, 32)
    close(_run(_ghiasi(sd, phase_space=True), x, s), _run(_ghiasi(sd), x, s))


def test_ghiasi_phase_space_odd_size_is_plain_on_the_padded_input():
    """27x31 -> 28x32: the phase lowering is the plain lowering of the input
    reflect-padded at the bottom and right (JAX's test_tpu_opt_odd_size)."""
    sd, _ = _weights("random")
    x, s = _inputs(27, 31)
    xp = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)), mode="reflect")
    out = _run(_ghiasi(sd, phase_space=True), x, s)
    assert out.shape == (2, 28, 32, 3)
    close(out, _run(_ghiasi(sd), xp, s))


def test_loaded_checkpoint_reaches_the_phase_kernels():
    """A converted checkpoint (convert_ghiasi, the torch layout) loaded after
    construction remakes the cached phase kernels, as the plain lowering's
    B1 HWIO buffers: the phase forward then equals the plain one on the new
    weights, and not on the init."""
    torch.manual_seed(7)
    phase = Ghiasi(phase_space=True).eval()
    init_w0 = phase.phase_w0.clone()
    sd, _ = _weights("asset")
    torch_layout = {k.replace("layer", "layers.", 1): v for k, v in sd.items()}
    phase.load_state_dict(convert_ghiasi(torch_layout))
    hwio = phase.layer0.conv.weight.permute(2, 3, 1, 0)
    assert torch.equal(phase.phase_w0, pc.phase_weights_9x9(hwio))
    assert not torch.equal(phase.phase_w0, init_w0)
    assert torch.equal(phase.phase_w10, pc.phase_weights_9x9_dp(
        phase.layer10.conv.weight.permute(2, 3, 1, 0)))
    assert set(phase.state_dict()) == set(sd)  # the cache is not saved
    x, s = _inputs(32, 32)
    close(_run(phase, x, s), _run(_ghiasi(sd), x, s))
