"""The port's StylePredictor, its converter, the convert.py naming of
explicit conv / bn modules, and the embedding CLI against the JAX package
on the same seeded weights and images.

The StylePredictor runs at 2 x 75 x 99. Tolerances: converted tensors and
round trips bit for bit; forwards within 1e-4 of the output's scale (f32
convs summed in another order), the embeddings and their mean within 1e-5
of the largest embedding and the covariance within what that allows
(``chip_smoke.embed_tols``), with ``jax.default_matmul_precision("float32")``
on the JAX side.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from scripts.get_embedding_mean_and_covariance import main as jax_embedding_main
from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.revgrad import RevGrad as JaxRevGrad
from speedplusbaseline_tpu.models.spn import SpacecraftPoseNet as JaxSPN
from speedplusbaseline_tpu.models.style_predictor import StylePredictor as JaxStylePredictor
from speedplusbaseline_tpu.models.weight_convert import (
    convert_style_predictor as jax_convert_style_predictor)
from speedplusbaseline_tpu_torch import embedding
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.models import Ghiasi, KeypointRegressionNet, RevGrad
from speedplusbaseline_tpu_torch.models import SpacecraftPoseNet
from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor
from speedplusbaseline_tpu_torch.models.weight_convert import convert_style_predictor
from chip_smoke import embed_tols
from test_torch_weight_convert import close, fake_style_predictor_sd, nchw, trees_equal

torch.set_num_threads(1)

H, W = 75, 99
FILES = ("embeddings_speedplus.npy", "style_embedding_speedplus_mean.npy",
         "embedding_covariance_speedplus.npy")


def jax_variables_shape():
    """The flax StylePredictor's variables as shapes (no init compute)."""
    return jax.eval_shape(lambda: JaxStylePredictor().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, H, W, 3))))


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def converted():
    """A fake checkpoint_stylepredictor state_dict through both converters:
    (reference sd, port state_dict, JAX variables)."""
    sd = fake_style_predictor_sd()
    ours = convert_style_predictor(sd)
    ref = jax_convert_style_predictor({k: v.numpy() for k, v in sd.items()},
                                      jax_variables_shape())
    return sd, ours, ref


def test_convert_style_predictor_matches_jax(converted):
    """num_batches_tracked goes, the names stay; the port's tree in flax
    names is JAX's converted one bit for bit. A conv bias (BasicConv2d's
    convs have none) or a missing key raises."""
    sd, ours, ref = converted
    assert len(ours) == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    model = StylePredictor()
    model.load_state_dict(ours)
    p, s = state_dict_to_flax(model.state_dict(), flax_auto_names=False)
    trees_equal({"params": p, "batch_stats": s}, ref)
    with pytest.raises(KeyError, match="unmapped"):
        convert_style_predictor({**sd, "Mixed_5b.branch1x1.conv.bias": torch.zeros(64)})
    with pytest.raises(KeyError, match="missing"):
        convert_style_predictor({k: v for k, v in sd.items() if not k.startswith("fc.")})


def test_style_predictor_forward_matches_jax(converted):
    """Eval forward at 2 x 75 x 99 on the converted weights: the double
    preprocessing with the 0.255 quirk, BN eps 1e-3 on running statistics,
    the padded average pool, the VALID max pools, the (1, 7) / (7, 1)
    paddings and the f32 spatial mean."""
    _, ours, ref = converted
    model = StylePredictor().eval()
    model.load_state_dict(ours)
    x = np.random.RandomState(1).rand(2, H, W, 3).astype(np.float32)
    fn = jax.jit(lambda v, x: JaxStylePredictor().apply(v, x, train=False))
    with jax.default_matmul_precision("float32"):
        expected = np.asarray(fn(ref, jnp.asarray(x)))
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    close(got, expected)
    # the two images' embeddings differ by more than 10x the tolerance
    scale = max(1.0, np.abs(expected).max())
    assert got.shape == (2, 100) and np.abs(expected[0] - expected[1]).max() > 1e-3 * scale
    with torch.no_grad():
        assert model(torch.rand(1, 3, 43, 43)).shape == (1, 100)  # the least input
        with pytest.raises(RuntimeError):
            model(torch.rand(1, 3, 42, 42))


def test_convert_round_trip_with_explicit_conv_bn_names(converted):
    """flax StylePredictor variables -> state_dict -> flax, bit for bit:
    its own ``conv`` / ``bn`` names stay (no Conv_0 / BatchNorm_0) and its
    ``bn/scale`` maps to a BatchNorm weight."""
    _, _, ref = converted
    sd = flax_to_state_dict(ref["params"], ref["batch_stats"])
    model = StylePredictor()
    model.load_state_dict(sd)
    p, s = state_dict_to_flax(model.state_dict(), flax_auto_names=False)
    trees_equal({"params": p, "batch_stats": s}, ref)
    assert "conv" in p["Mixed_6e"]["branch7x7dbl_5"] and "bn" in s["Conv2d_1a_3x3"]


@pytest.mark.parametrize("name", ["krn", "spn", "revgrad", "ghiasi", "style_predictor"])
def test_converted_names_and_shapes_match_flax(name):
    """Every port model's state_dict in flax names has the tree of the flax
    module's variables: the automatic Conv_0 / BatchNorm_0 for the older
    models, the explicit conv / bn for StylePredictor."""
    torch.manual_seed(0)
    key = {"params": jax.random.PRNGKey(0)}
    x = jnp.zeros((1, 64, 64, 3))
    if name == "krn":
        ours, ref = KeypointRegressionNet(11, (64, 64)), lambda: JaxKRN(11).init(key, x)
    elif name == "spn":
        ours = SpacecraftPoseNet(37, input_shape=(99, 99))
        ref = lambda: JaxSPN(37).init(key, jnp.zeros((1, 99, 99, 3)))  # noqa: E731
    elif name == "revgrad":
        ours, ref = RevGrad(11, (64, 64)), lambda: JaxRevGrad(11).init(key, x, alpha=0.5)
    elif name == "ghiasi":
        ours = Ghiasi()
        ref = lambda: JaxGhiasi().init(key, x, jnp.zeros((1, 100)))  # noqa: E731
    else:
        ours, ref = StylePredictor(), lambda: JaxStylePredictor().init(key, x)
    p, s = state_dict_to_flax(ours.state_dict(), flax_auto_names=name != "style_predictor")
    want = jax.eval_shape(ref)
    assert shapes(p) == shapes(want["params"])
    assert shapes(s) == shapes(dict(want).get("batch_stats", {}))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Five images of five sizes, JPEG and PNG, in a nested tree, beside a
    file that is not an image; at batch 2 the walk's last image is the
    dropped tail."""
    root = tmp_path_factory.mktemp("style_images")
    rs = np.random.RandomState(2)
    os.makedirs(root / "sub")
    for name, size in (("a.jpg", (120, 90)), ("c.png", (64, 48)), ("b.JPEG", (99, 75)),
                       ("sub/d.png", (200, 130)), ("sub/e.jpg", (80, 160))):
        arr = rs.randint(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / name)
    (root / "notes.txt").write_text("not an image")
    return str(root)


def test_embedding_cli_matches_jax_script(images, converted, tmp_path):
    """The embedding CLI against scripts/get_embedding_mean_and_covariance.py
    on the same images and the same .msgpack checkpoint: the same walk, the
    dropped tail, all three files; the .pth checkpoint gives the same
    embeddings as the .msgpack."""
    _, _, ref = converted
    ckpt = tmp_path / "style_predictor.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(ref))
    common = ["--data_dir", images, "--batchsize", "2", "--input_size", str(H), str(W),
              "--checkpoint", str(ckpt)]
    with jax.default_matmul_precision("float32"):
        jax_embedding_main(common + ["--out_dir", str(tmp_path / "jax")])
    out = embedding.main(common + ["--out_dir", str(tmp_path / "ours"), "--no_cuda"])
    assert out.shape == (4, 100)
    assert [os.path.basename(p) for p in embedding.image_paths(images)] == [
        "a.jpg", "b.JPEG", "c.png", "d.png", "e.jpg"]
    tols = embed_tols(np.load(tmp_path / "jax" / FILES[0]), 1e-5)
    for f, tol in zip(FILES, tols):
        got, expected = np.load(tmp_path / "ours" / f), np.load(tmp_path / "jax" / f)
        assert got.dtype == expected.dtype and got.shape == expected.shape, f
        np.testing.assert_allclose(got, expected, rtol=0, atol=tol, err_msg=f)
    pth = tmp_path / "checkpoint_stylepredictor.pth"
    torch.save({"state_dict_stylepredictor": fake_style_predictor_sd()}, pth)
    out_pth = embedding.main(common[:-1] + [str(pth), "--out_dir", str(tmp_path / "pth"),
                                            "--no_cuda"])
    np.testing.assert_array_equal(out_pth, out)
