"""The plain PyTorch versions of kernels B1 and B2 against the JAX package:
the Pallas kernels in interpret mode and the plain JAX functions.

B2 = instance_norm_film (ops/instancenorm.py), B1 = ghiasi_resblock
(ops/resblock.py). Inputs come from numpy seeds; the JAX side runs at
float32 matmul precision. Tolerances: 1e-5 absolute for B2 (one f32
normalisation), 1e-4 for B1 (two 1152-term f32 conv sums in another order,
each followed by a normalisation). B1's CUDA kernel takes its convs on bf16
tensor cores through split-bf16 operands; ``test_b1_split_bf16_matches_pallas``
emulates that arithmetic here and holds it to the Pallas kernel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.models.ghiasi import ResidualBlock as JaxResidualBlock
from speedplusbaseline_tpu.ops.instancenorm import instance_norm_film as jax_inf
from speedplusbaseline_tpu.ops.pallas_instancenorm import instance_norm_film_pallas
from speedplusbaseline_tpu.ops.pallas_resblock import ghiasi_resblock_pallas
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict
from speedplusbaseline_tpu_torch.models.ghiasi import ResidualBlock
from speedplusbaseline_tpu_torch.ops import (ghiasi_resblock, ghiasi_resblock_plain,
                                             instance_norm_film,
                                             instance_norm_film_plain)
from speedplusbaseline_tpu_torch.ops.resblock import _conv3x3_reflect

torch.set_num_threads(1)

B2_SHAPES = [(2, 8, 8, 32), (3, 9, 7, 16), (2, 8, 8, 3)]  # even, odd, C=3


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", B2_SHAPES)
@pytest.mark.parametrize("film,relu", [(False, False), (True, True), (True, False)])
def test_b2_plain_matches_pallas_and_jax(shape, film, relu):
    rs = np.random.RandomState(sum(shape) + 2 * film + relu)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(shape[0], shape[3]).astype(np.float32) if film else None
    b = rs.randn(shape[0], shape[3]).astype(np.float32) if film else None
    jx = jnp.asarray(x)
    jg = None if g is None else jnp.asarray(g)
    jb = None if b is None else jnp.asarray(b)
    pallas = np.asarray(instance_norm_film_pallas(jx, jg, jb, relu=relu, interpret=True))
    plain = np.asarray(jax_inf(jx, jg, jb))
    if relu:
        plain = np.maximum(plain, 0.0)
    ours = instance_norm_film_plain(_t(x), None if g is None else _t(g),
                                    None if b is None else _t(b), relu=relu).numpy()
    np.testing.assert_allclose(ours, pallas, atol=1e-5)
    np.testing.assert_allclose(ours, plain, atol=1e-5)


def test_b2_plain_large_mean():
    """Mean 10x the std: the plain version stays at f32 accuracy against a
    float64 reference (the kernel's shifted/Chan statistics are held to
    this plain version on the card by chip_smoke.py)."""
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 64, 64, 8) * 0.5 + 5.0).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2), keepdims=True)
    ref = (x64 - mean) / np.sqrt(x64.var(axis=(1, 2), keepdims=True) + 1e-5)
    ours = instance_norm_film_plain(_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _block_inputs(rs, shape):
    C = shape[3]
    w = lambda: (rs.randn(3, 3, C, C) / np.sqrt(9 * C)).astype(np.float32)
    v = lambda *s: rs.randn(*s).astype(np.float32)
    return (v(*shape), w(), v(C) * 0.1, w(), v(C) * 0.1,
            v(shape[0], C), v(shape[0], C), v(shape[0], C), v(shape[0], C))


def test_b1_plain_matches_pallas():
    args = _block_inputs(np.random.RandomState(0), (2, 8, 8, 128))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(ghiasi_resblock_pallas(*map(jnp.asarray, args), interpret=True))
    ours = ghiasi_resblock_plain(*map(_t, args)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _split(t):
    """f32 -> (hi, lo) bf16 values as f32: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _conv_split(a, w, b, a_is_bf16):
    """The kernel's conv arithmetic: reflect pad 1, 3x3 conv of a (B, H, W, C)
    by HWIO w as hi*hi + hi*lo + lo*hi bf16 products (lo*lo dropped; a bf16
    operand has lo = 0 and takes two passes), summed in f32, + b."""
    zero = torch.zeros_like(b)
    w_hi, w_lo = _split(w)
    a_hi, a_lo = (a, None) if a_is_bf16 else _split(a)
    y = _conv3x3_reflect(a_hi, w_hi, b) + _conv3x3_reflect(a_hi, w_lo, zero)
    if a_lo is not None:
        y = y + _conv3x3_reflect(a_lo, w_hi, zero)
    return y


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [0.0, 5.0])
def test_b1_split_bf16_matches_pallas(x_dtype, mean):
    """The split-bf16 arithmetic of csrc/resblock.cu keeps B1's f32 function.

    Emulated in plain torch: conv 1 takes x (split into hi/lo when f32, as it
    is when bf16) and conv 2 the normalised f32 y1, split; both weights split;
    the lo*lo term dropped; f32 sums. Held to the Pallas kernel at the card's
    f32 tolerance for B1, 5e-4 + 1e-4 |ref|, not the 1e-4 of the f32 plain
    version: each split operand keeps 16 significant bits, not 24, so every
    product is off by up to ~2^-16 relative before the 1152-term sums. A bf16
    x is compared before the final cast to bf16: the Pallas kernel is given
    its values as f32 (it upcasts a bf16 x itself), so both sides are the f32
    result. ``mean`` 5.0 with std 0.5 is the hard case: the IN of a mean 10x
    the std.
    """
    rs = np.random.RandomState(4)
    args = list(_block_inputs(rs, (2, 8, 8, 128)))
    args[0] = (args[0] * (0.5 if mean else 1.0) + mean).astype(np.float32)
    if x_dtype == "bfloat16":
        args[0] = torch.from_numpy(args[0]).to(torch.bfloat16).float().numpy()
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(ghiasi_resblock_pallas(*map(jnp.asarray, args), interpret=True))
    x, w1, b1, w2, b2, g1, f1, g2, f2 = map(_t, args)
    y = _conv_split(x, w1, b1, x_dtype == "bfloat16")
    y = instance_norm_film_plain(y, g1, f1, relu=True)
    y = _conv_split(y, w2, b2, False)
    ours = (x + instance_norm_film_plain(y, g2, f2)).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-4)


def test_b1_odd_size_matches_jax_block():
    """Odd 9x9 (SPN's 57^2 case, where JAX gates its kernel off): the
    port's ResidualBlock module, through convert.py, against the plain JAX
    block."""
    rs = np.random.RandomState(1)
    x = rs.rand(2, 9, 9, 128).astype(np.float32)
    st = rs.randn(2, 100).astype(np.float32)
    block = JaxResidualBlock(128)
    variables = block.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                           jnp.asarray(st))
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(block.apply(variables, jnp.asarray(x), jnp.asarray(st)))
    ours = ResidualBlock(128)
    ours.load_state_dict(flax_to_state_dict(variables["params"]))
    with torch.no_grad():
        out = ours(_t(x).permute(0, 3, 1, 2), _t(st)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_wrappers_take_plain_version_only_on_cpu():
    rs = np.random.RandomState(2)
    args = [_t(a) for a in _block_inputs(rs, (1, 4, 4, 8))]
    assert torch.equal(instance_norm_film(args[0]), instance_norm_film_plain(args[0]))
    assert torch.equal(ghiasi_resblock(*args), ghiasi_resblock_plain(*args))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm_film(meta[0])
    with pytest.raises(ValueError, match="unsupported device"):
        ghiasi_resblock(*meta)
