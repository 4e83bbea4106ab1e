"""The port's untrained models start as the JAX package's do: every conv and
dense kernel drawn as flax's default ``lecun_normal`` (a normal of variance
1 / fan_in truncated at two standard deviations) and every bias zero.

No parity test sees init, because each loads one set of weights into both
packages; training from scratch does. torch's default init (a uniform of
variance 1 / (3 fan_in), uniform biases) kept SPN at ln(500) for a whole
run on the card (``test_torch_spn.py::test_spn_init_matches_flax_defaults``)
and left the KRN-based models' training dynamics unlike JAX's.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.revgrad import RevGrad as JaxRevGrad
from speedplusbaseline_tpu.models.style_predictor import StylePredictor as JaxStylePredictor
from speedplusbaseline_tpu_torch.models import KeypointRegressionNet, RevGrad
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor
from speedplusbaseline_tpu_torch.ops.phase_conv import phase_weights_s2_aligned

torch.set_num_threads(1)

# flax's unit normal truncated at +-2 has this standard deviation.
TRUNC_STD = 0.87962566103423978
S = 64  # square input side: KRN's head window and the Ghiasi input depend on it


def _jax_params(name):
    key = {"params": jax.random.PRNGKey(0)}
    x = jnp.zeros((1, S, S, 3))
    if name == "krn":
        return JaxKRN(11).init(key, x, train=False)["params"]
    if name == "revgrad":
        return JaxRevGrad(11).init(key, x, train=False, alpha=1.0)["params"]
    if name == "style_predictor":
        return JaxStylePredictor().init(key, x)["params"]
    return JaxGhiasi().init(key, x, jnp.zeros((1, 100)))["params"]


def _port_model(name):
    torch.manual_seed(0)
    return {"krn": lambda: KeypointRegressionNet(11, (S, S)),
            "revgrad": lambda: RevGrad(11, (S, S)),
            "style_predictor": StylePredictor,
            "ghiasi": Ghiasi}[name]()


def _jax_layers(params):
    """[(kernel as a numpy array, fan_in, bias or None)] of a flax tree."""
    out = []

    def walk(tree):
        if "kernel" in tree:
            k = np.asarray(tree["kernel"])
            out.append((k, k.size // k.shape[-1],
                        np.asarray(tree["bias"]) if "bias" in tree else None))
        for v in tree.values():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v)

    walk(params)
    return out


def _port_layers(model):
    return [(m.weight.detach().numpy(), m.weight[0].numel(),
             None if m.bias is None else m.bias.detach().numpy())
            for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]


def _check_lecun_normal(layers):
    """Each kernel's std within 3/sqrt(n) of sqrt(1 / fan_in) (about five
    standard errors of a sample std of n draws), none past two standard
    deviations of the untruncated normal, all of them together within 1%;
    every bias zero."""
    pooled = []
    for k, fan_in, bias in layers:
        std = (1.0 / fan_in) ** 0.5
        assert abs(k.std() / std - 1.0) < 3.0 / k.size ** 0.5, (k.shape, k.std() / std)
        assert np.abs(k).max() <= 2.0 * std / TRUNC_STD * (1 + 1e-6), k.shape
        assert bias is None or not bias.any(), k.shape
        pooled.append(k.ravel() / std)
    assert abs(np.concatenate(pooled).std() - 1.0) < 0.01


def assert_init_matches_flax(params, model):
    """``model``'s conv and dense layers are those of the flax ``params``
    (by size, fan-in and whether each has a bias), and both sets follow
    flax's defaults."""
    ref, ours = _jax_layers(params), _port_layers(model)
    shape = lambda layers: sorted((k.size, f, b is None) for k, f, b in layers)
    assert shape(ours) == shape(ref)
    _check_lecun_normal(ref)
    _check_lecun_normal(ours)


@pytest.mark.parametrize("name", ["krn", "revgrad", "style_predictor", "ghiasi"])
def test_init_matches_flax_defaults(name):
    assert_init_matches_flax(_jax_params(name), _port_model(name))


def test_ghiasi_kernel_weights_follow_the_init():
    """The fused residual block reads HWIO copies of its conv weights; they
    are made after the init, in both lowerings."""
    torch.manual_seed(0)
    for net in (Ghiasi(), Ghiasi(phase_space=True)):
        for i in range(3, 8):
            blk = getattr(net, f"layer{i}")
            for w, conv in ((blk.w1_hwio, blk.conv1), (blk.w2_hwio, blk.conv2)):
                assert torch.equal(w, conv.weight.permute(2, 3, 1, 0))
    assert torch.equal(net.phase_w2, phase_weights_s2_aligned(
        net.layer2.conv.weight.permute(2, 3, 1, 0)))
