"""The port's pretrained-weight converters, loader, msgpack writer and
``convert_weights`` CLI against the JAX package on the same seeded state
dicts (the real checkpoints are not in the repository; the fake state dicts of
``test_weight_convert.py`` give the original key names and shapes).

Tolerances: converted tensors are compared bit for bit; forwards within
1e-4 of the output's scale (f32 convs summed in another order), with
``jax.default_matmul_precision("float32")`` on the JAX side.
"""
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization, struct

from scripts.convert_ghiasi import main as jax_convert_ghiasi
from scripts.convert_style_predictor import main as jax_convert_style_predictor
from scripts.convert_torchvision_mobilenet import main as jax_convert_mobilenet
from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.spn import SpacecraftPoseNet as JaxSPN
from speedplusbaseline_tpu.models import weight_convert as jwc
from speedplusbaseline_tpu_torch import convert_weights, train
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import (flax_to_state_dict, read_flax_msgpack,
                                                 state_dict_to_flax, write_flax_msgpack)
from speedplusbaseline_tpu_torch.models import weight_convert as wc
from speedplusbaseline_tpu_torch.models.build import get_model
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.models.krn import KeypointRegressionNet
from speedplusbaseline_tpu_torch.models.spn import SpacecraftPoseNet
from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor
from test_weight_convert import fake_ghiasi_sd, fake_torchvision_mobilenet_sd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _State:
    """What JAX's maybe_load_pretrained reads and replaces of a TrainState."""
    params: dict
    batch_stats: dict


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=rel * max(1.0, np.abs(ref).max()))


def trees_equal(ours, ref):
    flat_o = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_o.keys() == flat_r.keys()
    for k, v in flat_r.items():
        np.testing.assert_array_equal(np.asarray(flat_o[k]), np.asarray(v), err_msg=str(k))


def jax_apply(model, variables, *xs, **kw):
    fn = jax.jit(lambda v, *a: model.apply(v, *a, **kw))
    with jax.default_matmul_precision("float32"):
        return jax.device_get(fn(variables, *map(jnp.asarray, xs)))


def fake_bvlc(rs):
    """bvlc_alexnet.npy's dict: per conv [HWIO kernel (I/g for the grouped
    conv2, conv4, conv5), bias]."""
    shapes = {"conv1": (11, 11, 3, 96), "conv2": (5, 5, 48, 256), "conv3": (3, 3, 256, 384),
              "conv4": (3, 3, 192, 384), "conv5": (3, 3, 192, 256)}
    return {name: [(rs.randn(*s) * 0.05).astype(np.float32),
                   (rs.randn(s[-1]) * 0.1).astype(np.float32)] for name, s in shapes.items()}


def fake_torch_spn_sd(rs, num_classes):
    """A torch SpacecraftPoseNet state_dict at 227^2: OIHW convs, (out, in)
    Linears, fc6/fc9 over the (C=256, 6, 6) flatten of pool5."""
    sd = {}
    convs = {"conv1": (96, 3, 11), "conv2": (256, 48, 5), "conv3": (384, 256, 3),
             "conv4": (384, 192, 3), "conv5": (256, 192, 3)}
    for name, (o, i, k) in convs.items():
        sd[f"{name}.weight"] = (rs.randn(o, i, k, k) * 0.05).astype(np.float32)
        sd[f"{name}.bias"] = (rs.randn(o) * 0.1).astype(np.float32)
    fcs = {"fc6": (4096, 9216), "fc7": (4096, 4096), "fc8": (num_classes, 4096),
           "fc9": (4096, 9216), "fc10": (4096, 4096), "fc11": (num_classes, 4096)}
    for name, (o, i) in fcs.items():
        sd[f"{name}.weight"] = (rs.randn(o, i) / np.sqrt(i)).astype(np.float32)
        sd[f"{name}.bias"] = (rs.randn(o) * 0.1).astype(np.float32)
    return sd


def fake_style_predictor_sd(seed=0):
    """checkpoint_stylepredictor.pth's state_dict: the reference's names,
    He-scaled convs (so that the embedding still depends on the image after
    about 50 layers), BN statistics away from 0 / 1, and
    ``num_batches_tracked``."""
    rs = np.random.RandomState(seed)
    torch.manual_seed(seed)
    sd = {}
    for k, v in StylePredictor().state_dict().items():
        if k.endswith("conv.weight"):
            v = torch.from_numpy((rs.randn(*v.shape) * np.sqrt(2.0 / v[0].numel()))
                                 .astype(np.float32))
        elif k.endswith(("running_mean", "bn.bias")):
            v = torch.from_numpy((rs.randn(*v.shape) * 0.1).astype(np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32))
        sd[k] = v
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


# ----- converters against JAX's, through each model's forward

def test_mobilenet_v2_converter_matches_jax():
    """KRN at 64^2 in eval mode: the port's KRN with the converted backbone
    against the flax KRN with JAX's converted backbone and the same head."""
    sd = fake_torchvision_mobilenet_sd(np.random.RandomState(0))
    sd["features.0.1.num_batches_tracked"] = np.array(3)
    ours = KeypointRegressionNet(11, (64, 64)).eval()
    ours.base.load_state_dict(wc.convert_mobilenet_v2(sd))
    params, stats = jwc.convert_mobilenet_v2(sd)
    p, s = state_dict_to_flax(ours.state_dict())
    trees_equal({"p": p["base"], "s": s["base"]}, {"p": params, "s": stats})
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    ref = jax_apply(JaxKRN(11), {"params": {**p, "base": params},
                                 "batch_stats": {**s, "base": stats}}, x, train=False)
    with torch.no_grad():
        out = ours(nchw(x))
    for o, r in zip(out, ref):
        close(o, r)


def test_bvlc_alexnet_converter_matches_jax():
    """SPN at 99^2 with conv1-5 from bvlc_alexnet's HWIO arrays."""
    weights = fake_bvlc(np.random.RandomState(2))
    torch.manual_seed(0)
    ours = SpacecraftPoseNet(37, input_shape=(99, 99)).eval()
    p, _ = state_dict_to_flax(ours.state_dict())
    ours.load_state_dict({**ours.state_dict(), **wc.convert_bvlc_alexnet(weights)})
    ref_params = jwc.convert_bvlc_alexnet(weights, p)
    trees_equal(state_dict_to_flax(ours.state_dict())[0], ref_params)
    x = np.random.RandomState(3).rand(2, 99, 99, 3).astype(np.float32)
    ref = jax_apply(JaxSPN(37), {"params": ref_params}, x, train=False)
    with torch.no_grad():
        out = ours(nchw(x))
    for o, r in zip(out, ref):
        close(o, r)


def test_spn_torch_converter_matches_jax():
    """A torch SPN at 227^2, where pool5 is 6x6: fc6 and fc9's input columns
    go from the (C, 6, 6) flatten to the port's (6, 6, C)."""
    sd = fake_torch_spn_sd(np.random.RandomState(4), 10)
    ours = SpacecraftPoseNet(10).eval()
    ours.load_state_dict(wc.convert_spn_torch(sd))
    ref_params = jwc.convert_spn_torch(sd, state_dict_to_flax(ours.state_dict())[0])
    trees_equal(state_dict_to_flax(ours.state_dict())[0], ref_params)
    x = np.random.RandomState(5).rand(2, 227, 227, 3).astype(np.float32)
    ref = jax_apply(JaxSPN(10), {"params": ref_params}, x, train=False)
    with torch.no_grad():
        out = ours(nchw(x))
    for o, r in zip(out, ref):
        close(o, r)


def test_ghiasi_converter_matches_jax_and_reaches_b1_weights():
    """checkpoint_transformer's keys through load_state_dict: the HWIO f32
    weights that kernel B1 reads are remade from the converted convs (a
    converter writing .data would leave them at the init), and the
    generator's forward (plain B1/B2 on the CPU) at 32^2 equals flax's with
    JAX's converted params."""
    sd = fake_ghiasi_sd(np.random.RandomState(6))
    torch.manual_seed(1)
    ours = Ghiasi().eval()
    init_hwio = ours.layer3.w1_hwio.clone()
    ours.load_state_dict(wc.convert_ghiasi(sd))
    for i in range(3, 8):
        block = getattr(ours, f"layer{i}")
        for j in (1, 2):
            np.testing.assert_array_equal(
                getattr(block, f"w{j}_hwio").numpy(),
                sd[f"layers.{i}.conv{j}.weight"].transpose(2, 3, 1, 0))
    assert not torch.equal(init_hwio, ours.layer3.w1_hwio)
    params = jwc.convert_ghiasi(sd, state_dict_to_flax(ours.state_dict())[0])
    trees_equal(state_dict_to_flax(ours.state_dict())[0], params)
    rs = np.random.RandomState(7)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    st = (rs.randn(2, 100) * 0.5).astype(np.float32)
    ref = jax_apply(JaxGhiasi(), {"params": params}, x, st)
    with torch.no_grad():
        out = ours(nchw(x), torch.from_numpy(st)).permute(0, 2, 3, 1).numpy()
    close(out, ref)
    with pytest.raises(KeyError, match="unmapped"):
        wc.convert_ghiasi({**sd, "extra.weight": np.zeros(1)})


# ----- maybe_load_pretrained against JAX's on the same files

def write_backbone(path, sd):
    params, stats = state_dict_to_flax(wc.convert_mobilenet_v2(sd))
    write_flax_msgpack({"params": params, "batch_stats": stats}, path)


def fresh(model_name, dann=False):
    torch.manual_seed(3)
    side = 64 if model_name == "krn" else 99
    cfg = default_cfg(model_name=model_name, dann=dann, num_classes=37,
                      input_shape=(side, side))
    return cfg, get_model(cfg)


@pytest.mark.parametrize("model_name,dann", [("krn", False), ("krn", True), ("spn", False)])
def test_maybe_load_pretrained_matches_jax(model_name, dann, tmp_path, caplog):
    """The port's loader and JAX's read the same asset (the backbone written
    by the port's msgpack writer) into the same fresh model: the whole trees
    agree bit for bit, so the base (net.base under DANN) or conv1-5 is the
    file's and the rest keeps its init. The log line is JAX's."""
    rs = np.random.RandomState(8)
    if model_name == "krn":
        write_backbone(str(tmp_path / "mobilenetv2_backbone.msgpack"),
                       fake_torchvision_mobilenet_sd(rs))
    else:
        np.save(tmp_path / "bvlc_alexnet.npy",
                {k.encode(): v for k, v in fake_bvlc(rs).items()}, allow_pickle=True)
    cfg, model = fresh(model_name, dann)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    p, s = state_dict_to_flax(model.state_dict())
    jcfg = jax_default_cfg(model_name=model_name, dann=dann)
    ref = jwc.maybe_load_pretrained(jcfg, _State(params=p, batch_stats=s), str(tmp_path))
    with caplog.at_level(logging.INFO):
        assert wc.maybe_load_pretrained(cfg, model, str(tmp_path))
    loaded = state_dict_to_flax(model.state_dict())
    trees_equal({"p": loaded[0], "s": loaded[1]}, {"p": ref.params, "s": ref.batch_stats})
    target = ("net.base." if dann else "base.") if model_name == "krn" else "conv"
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) != k.startswith(target), k
    line = ("MobileNetV2 ImageNet backbone loaded from" if model_name == "krn"
            else "bvlc_alexnet conv1-5 loaded from")
    assert line in caplog.text


@pytest.mark.parametrize("model_name", ["krn", "spn"])
def test_maybe_load_pretrained_is_a_noop_without_the_file(model_name, tmp_path):
    cfg, model = fresh(model_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not wc.maybe_load_pretrained(cfg, model, str(tmp_path))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_maybe_load_pretrained_raises_on_a_partial_file(tmp_path):
    """A backbone file with a key missing raises in both packages, where a
    quiet partial load would leave the model half initialised."""
    sd = wc.convert_mobilenet_v2(fake_torchvision_mobilenet_sd(np.random.RandomState(9)))
    params, stats = state_dict_to_flax(sd)
    del params["block17"]["project"]["Conv_0"]
    write_flax_msgpack({"params": params, "batch_stats": stats},
                       str(tmp_path / "mobilenetv2_backbone.msgpack"))
    cfg, model = fresh("krn")
    with pytest.raises(RuntimeError, match="Missing key"):
        wc.maybe_load_pretrained(cfg, model, str(tmp_path))
    p, s = state_dict_to_flax(model.state_dict())
    with pytest.raises(ValueError):
        jwc.maybe_load_pretrained(jax_default_cfg(), _State(params=p, batch_stats=s),
                                  str(tmp_path))
    weights = fake_bvlc(np.random.RandomState(9))
    weights["conv3"] = weights["conv3"][:1]  # no bias
    np.save(tmp_path / "bvlc_alexnet.npy", weights, allow_pickle=True)
    cfg, model = fresh("spn")
    with pytest.raises(KeyError, match="conv3.bias"):
        wc.maybe_load_pretrained(cfg, model, str(tmp_path))


# ----- the msgpack writer and the convert_weights CLI

def test_write_flax_msgpack_is_flax_format(tmp_path):
    """flax restores the file into the same arrays; the bytes are flax's;
    read_flax_msgpack reads it back."""
    rs = np.random.RandomState(10)
    tree = {"b": {"kernel": rs.randn(3, 3, 2, 4).astype(np.float32),
                  "z": np.arange(5, dtype=np.int32)},
            "a": {"mean": rs.randn(7).astype(np.float32), "s": np.full((), 2.5, np.float32)}}
    path = str(tmp_path / "t.msgpack")
    write_flax_msgpack(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    trees_equal(serialization.msgpack_restore(data), tree)
    assert data == serialization.msgpack_serialize(tree)
    trees_equal(read_flax_msgpack(path), tree)


def _save_pth(path, sd, entry=None):
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    torch.save({entry: sd} if entry else sd, path)


@pytest.mark.parametrize("target", ["mobilenet_v2", "ghiasi", "style_predictor"])
def test_convert_weights_cli_matches_jax_scripts(target, tmp_path):
    """Each subcommand against its JAX script on the same fake .pth: the
    restored trees are equal, and so are the files' bytes, but for the key
    order of the Ghiasi file: its script writes with ``to_bytes``, which
    keeps flax's init order, where ``msgpack_serialize`` (the other two
    scripts, and the port's writer) sorts the keys."""
    rs = np.random.RandomState(11)
    src = str(tmp_path / "src.pth")
    if target == "mobilenet_v2":
        sd = fake_torchvision_mobilenet_sd(rs)
        sd["features.1.conv.0.1.num_batches_tracked"] = np.array(4)
        _save_pth(src, sd)
        jax_main = jax_convert_mobilenet
    elif target == "ghiasi":
        _save_pth(src, fake_ghiasi_sd(rs), "state_dict_ghiasi")
        jax_main = jax_convert_ghiasi
    else:
        _save_pth(src, fake_style_predictor_sd(), "state_dict_stylepredictor")
        jax_main = jax_convert_style_predictor
    ref, ours = str(tmp_path / "ref.msgpack"), str(tmp_path / "ours.msgpack")
    jax_main(["--src", src, "--out", ref])
    assert convert_weights.main([target, "--src", src, "--out", ours, "--no_cuda"]) == ours
    with open(ref, "rb") as f:
        ref_bytes = f.read()
    with open(ours, "rb") as f:
        our_bytes = f.read()
    ref_tree = serialization.msgpack_restore(ref_bytes)
    trees_equal(serialization.msgpack_restore(our_bytes), ref_tree)
    if target == "ghiasi":
        assert our_bytes != ref_bytes
        ref_bytes = serialization.msgpack_serialize(ref_tree)
    assert our_bytes == ref_bytes


# ----- the train CLI with converted assets

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from speedplusbaseline_tpu_torch import preprocess
    from speedplusbaseline_tpu_torch.data import generate_fake_speedplus

    root = str(tmp_path_factory.mktemp("pretrained_train"))
    generate_fake_speedplus(root, num_train=4, num_test=0, domains=("synthetic",),
                            device=torch.device("cpu"))
    for m in ("krn", "spn"):
        preprocess.main(["--dataroot", root, "--domain", "synthetic", "--jsonfile",
                         "train.json", "--csvfile", f"splits_{m}/train.csv", "--model_name",
                         m, "--no_cuda"])
    return root


@pytest.mark.parametrize("model_name", ["krn", "spn"])
def test_train_cli_starts_from_the_converted_assets(model_name, dataset, tmp_path,
                                                    monkeypatch):
    """The train CLI's first step starts from the weights JAX's loader reads
    from the same file (caught at the epoch's start), the head from its
    init; an auto-resumed run starts from its checkpoint instead."""
    assets = tmp_path / "assets"
    assets.mkdir()
    rs = np.random.RandomState(12)
    if model_name == "krn":
        src = str(tmp_path / "mnv2.pth")
        _save_pth(src, fake_torchvision_mobilenet_sd(rs))
        convert_weights.main(["mobilenet_v2", "--src", src, "--out",
                              str(assets / "mobilenetv2_backbone.msgpack"), "--no_cuda"])
        with open(assets / "mobilenetv2_backbone.msgpack", "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        expected = {"base." + k: v for k, v in
                    flax_to_state_dict(raw["params"], raw["batch_stats"]).items()}
        shape = ["32", "32"]
    else:
        weights = fake_bvlc(rs)
        np.save(assets / "bvlc_alexnet.npy", weights, allow_pickle=True)
        expected = {}
        for n, (w, b) in weights.items():
            expected[f"{n}.weight"] = torch.from_numpy(np.ascontiguousarray(
                w.transpose(3, 2, 0, 1)))
            expected[f"{n}.bias"] = torch.from_numpy(b)
        os.symlink(os.path.join(REPO, "assets", "attitude_classes.npy"),
                   assets / "attitude_classes.npy")
        shape = ["99", "99"]
    monkeypatch.setenv("SPEEDPLUS_ASSETS_DIR", str(assets))
    starts = []
    epoch = train.train_epoch

    def spy(n, cfg, state, *a, **k):
        starts.append({key: v.clone() for key, v in state.model.state_dict().items()})
        return epoch(n, cfg, state, *a, **k)

    monkeypatch.setattr(train, "train_epoch", spy)
    save = str(tmp_path / "save")
    common = ["--dataroot", dataset, "--model_name", model_name, "--savedir", save,
              "--logdir", str(tmp_path / "log"), "--input_shape", *shape, "--batch_size",
              "2", "--num_workers", "1", "--no_cuda"]
    records = train.main(common + ["--max_epochs", "1", "--start_over"])
    assert len(records) == 2
    first = starts[0]
    for k, v in expected.items():
        assert torch.equal(first[k], v.float()), k
    torch.manual_seed(2021)  # the trainer's seed: the rest is its fresh init
    init = get_model(default_cfg(model_name=model_name, input_shape=tuple(map(int, shape)),
                                 num_classes=5000)).state_dict()
    for k, v in first.items():
        if k not in expected:
            assert torch.equal(v, init[k]), k
    saved = torch.load(os.path.join(save, "checkpoint.pt"), weights_only=True)["variables"]
    records = train.main(common + ["--max_epochs", "2"])
    assert [r["epoch"] for r in records] == [2, 2]
    second = starts[1]
    assert second.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(second[k], v), k
    assert any(not torch.equal(second[k], v.float()) for k, v in expected.items())
