"""The plain PyTorch versions of kernels B1 and B2 against the JAX package:
the Pallas kernels in interpret mode and the plain JAX functions.

B2 = instance_norm_film (ops/instancenorm.py), B1 = ghiasi_resblock
(ops/resblock.py). Inputs come from numpy seeds; the JAX side runs at
float32 matmul precision. Tolerances: 1e-5 absolute for B2 (one f32
normalisation), 1e-4 for B1 (two 1152-term f32 conv sums in another order,
each followed by a normalisation).
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
