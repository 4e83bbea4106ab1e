"""The port's SPN path against the JAX package on the CPU: LocalResponseNorm,
the SPN forward (99^2, where pool5 is 2x2 and the HWC flatten matters, and
227^2), the loss, dropout, two train steps, the Gauss-Newton position, the
eval step, Ghiasi at 227^2, the SPN dataset, and the trainer and test CLIs.

Weights are made by the port's init and carried to flax trees by
``convert.py`` (or the other way for a JAX init), inputs from seeded numpy.
JAX runs with ``default_matmul_precision("float32")``. Tolerances: LRN 1e-6
relative; the forward 1e-4 abs + 1e-4 rel; the loss 1e-6; train steps in
float64 on both sides (as test_torch_train.py's KRN step), parameters within
1e-7 after two AdamW steps but for under 0.1% of a tensor, all within 1e-4
(see that test), gradients within 1e-6 of their scale; the position 1e-4 m
(2e-3 m of ground truth); the eval step's q 1e-5 and t 1e-4 m per row; the
CLI dumps within their printed 1e-5 (err_q 2e-4 deg).
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.config import parse_cfg as jax_parse_cfg
from speedplusbaseline_tpu.data import SPNDataset as JaxSPNDataset
from speedplusbaseline_tpu.data import generate_fake_speedplus
from speedplusbaseline_tpu.engine import make_spn_eval_step as jax_make_spn_eval_step
from speedplusbaseline_tpu.engine import make_spn_train_step as jax_make_spn_train_step
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
from speedplusbaseline_tpu.geometry import compute_position_spn_batched as jax_position
from speedplusbaseline_tpu.geometry import project_keypoints as jax_project
from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu.models.layers import LocalResponseNorm as JaxLRN
from speedplusbaseline_tpu.models.spn import SpacecraftPoseNet as JaxSPN
from speedplusbaseline_tpu.models.spn import spn_loss as jax_spn_loss
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch import train
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.data import SPNDataset
from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer, clip_gradients,
                                                make_spn_eval_step, spn_step)
from speedplusbaseline_tpu_torch.geometry import compute_position_spn_batched
from speedplusbaseline_tpu_torch.models import RevGrad, get_model
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.models.layers import LocalResponseNorm
from speedplusbaseline_tpu_torch.models.spn import SpacecraftPoseNet, dropout, spn_loss
from tests.conftest import random_pose

torch.set_num_threads(1)

NC = 37  # classes of the small models


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def unit_quats(rs, n):
    q = rs.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (q * np.sign(q[:, :1])).astype(np.float32)


def spn_pair(S, num_classes=NC, seed=0, keep_prob=0.5):
    """The port's SPN at S^2 and its flax params."""
    torch.manual_seed(seed)
    model = SpacecraftPoseNet(num_classes, keep_prob, (S, S))
    params, stats = state_dict_to_flax(model.state_dict())
    assert stats == {}
    return model, params


@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_local_response_norm_matches_flax(scale):
    """At unit scale the denominator is ~1; at 300 the alpha * mean term is
    ~1 too, so the windowed mean and its channel padding matter."""
    x = (np.random.RandomState(0).randn(2, 5, 4, 7) * scale).astype(np.float32)
    ref = np.asarray(JaxLRN().apply({}, jnp.asarray(x)))
    ours = LocalResponseNorm()(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert np.abs(ours - x).max() > (1e-3 if scale > 1 else 0)
    # f32 inside a bf16 autocast, cast back to the input's dtype
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = LocalResponseNorm()(nchw(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(), np.asarray(
        JaxLRN().apply({}, jnp.asarray(x, jnp.bfloat16))).astype(np.float32), rtol=1e-2)


@pytest.mark.parametrize("S", [99, 227])
def test_spn_eval_forward_matches_jax(S):
    """pool5 is 2x2 at 99^2 (a CHW flatten would permute fc6/fc9's inputs)
    and 6x6 at 227^2 (the 9216-wide flatten)."""
    model, params = spn_pair(S)
    model.eval()
    x = np.random.RandomState(1).rand(2, S, S, 3).astype(np.float32)
    with torch.no_grad():
        c, r = model(nchw(x))
    with jax.default_matmul_precision("float32"):
        jc, jr = jax.jit(lambda p, x: JaxSPN(NC).apply({"params": p}, x, train=False))(
            params, jnp.asarray(x))
    for ours, ref in ((c, jc), (r, jr)):
        assert ours.shape == (2, NC) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # the flatten is HWC: a CHW flatten feeds fc6 other numbers
    flat = 256 * (2 if S == 99 else 6) ** 2
    assert model.fc6.weight.shape == (4096, flat)


def test_spn_loss_matches_jax():
    rs = np.random.RandomState(2)
    c, w = (rs.randn(2, 4, NC).astype(np.float32) * 3)
    yc = np.zeros((4, NC), np.float32)
    yw = np.zeros((4, NC), np.float32)
    for i in range(4):
        idx = rs.choice(NC, 5, replace=False)
        yc[i, idx] = 0.2
        yw[i, idx] = rs.dirichlet(np.ones(5))
    loss, sm = spn_loss(*(torch.from_numpy(a) for a in (c, w, yc, yw)))
    jloss, jsm = jax_spn_loss(*(jnp.asarray(a) for a in (c, w, yc, yw)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in ("loss_c", "loss_r"):
        np.testing.assert_allclose(sm[k].item(), float(jsm[k]), rtol=1e-6)
    # the targets are detached
    yt = torch.from_numpy(yc).requires_grad_()
    logits = torch.from_numpy(c).requires_grad_()
    spn_loss(logits, torch.from_numpy(w), yt, torch.from_numpy(yw))[0].backward()
    assert yt.grad is None and logits.grad is not None


def test_dropout_draws_from_the_generator():
    x = torch.ones(64, 4096)
    g = torch.Generator().manual_seed(3)
    a = dropout(x, 0.5, g, True)
    b = dropout(x, 0.5, torch.Generator().manual_seed(3), True)
    assert torch.equal(a, b)  # the same seed, the same mask
    assert not torch.equal(a, dropout(x, 0.5, g, True))  # the stream moves on
    assert set(a.unique().tolist()) == {0.0, 2.0}  # survivors scaled by 1 / (1 - p)
    assert abs((a == 0).float().mean().item() - 0.5) < 0.01
    assert abs((dropout(x, 0.2, g, True) == 0).float().mean().item() - 0.2) < 0.01
    assert dropout(x, 0.5, None, False) is x  # off in eval mode
    assert dropout(x, 0.0, None, True) is x  # p = 0 is the identity
    with pytest.raises(ValueError):
        dropout(x, 0.5, None, True)


def test_spn_dropout_follows_train_and_eval_mode():
    model, _ = spn_pair(99, keep_prob=0.5)
    x = nchw(np.random.RandomState(4).rand(2, 99, 99, 3).astype(np.float32))
    with torch.no_grad():
        model.train()
        t1 = model(x, torch.Generator().manual_seed(5))
        t2 = model(x, torch.Generator().manual_seed(5))
        t3 = model(x, torch.Generator().manual_seed(6))
        model.eval()
        e = model(x)
    assert all(torch.equal(a, b) for a, b in zip(t1, t2))
    assert not torch.equal(t1[0], t3[0]) and not torch.equal(t1[0], e[0])


def test_clip_by_value_matches_optax():
    rs = np.random.RandomState(7)
    grads = {"a": (rs.randn(4, 3) * 2).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    ref = optax.clip(1.0).update(jax.tree_util.tree_map(jnp.asarray, grads), None)[0]
    ps = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in grads.items()}
    for k, p in ps.items():
        p.grad = torch.from_numpy(grads[k].copy())
    clip_gradients("spn", ps.values())
    for k in grads:
        np.testing.assert_array_equal(ps[k].grad.numpy(), np.asarray(ref[k]))
    assert np.abs(grads["a"]).max() > 1.0


def test_spn_train_steps_match_jax():
    """Two plain AdamW steps (clip by value 1.0) of spn_step against the JAX
    package's make_spn_train_step, dropout off on both sides, in float64
    (the logits and loss are f32 in both, as both models cast their heads
    to f32). The inputs are scaled up so that some gradients pass the clip.
    Parameters agree within 1e-7 but for under 0.1% of each tensor, and all
    within 1e-4 (a tenth of lr): a third of conv3's gradients are under
    Adam's eps of 1e-8, and there the update g / (|g| + eps) follows the
    gradient's last bits, which the f32 logits set (read: 36 of conv2's
    307,200 weights past 1e-7, the largest gap 1.6e-5). The gradients
    themselves are held tighter by test_spn_grads_match_jax."""
    S, B = 99, 2
    model, params = spn_pair(S, keep_prob=0.0)
    model.double()
    rs = np.random.RandomState(8)
    yc = np.zeros((B, NC), np.float32)
    yw = np.zeros((B, NC), np.float32)
    for i in range(B):
        idx = rs.choice(NC, 5, replace=False)
        yc[i, idx] = 0.2
        yw[i, idx] = rs.dirichlet(np.ones(5))
    batch = {"image": (rs.rand(B, S, S, 3) * 20).astype(np.float32), "y_classes": yc,
             "y_weights": yw}
    batches = [batch, batch]
    kw = dict(model_name="spn", optimizer="adamw", lr=1e-3, weight_decay=0.01,
              num_classes=NC)
    state = TrainState(model, build_optimizer(default_cfg(**kw), model.parameters()))
    ours = [spn_step(state, *(torch.from_numpy(b[k]) for k in ("image", "y_classes",
                                                               "y_weights")), False)
            for b in batches]
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = jax_build_optimizer(jax_default_cfg(**kw), 10)
        step = jax_make_spn_train_step(JaxSPN(NC, keep_prob=0.0, dtype=jnp.float64), tx,
                                       jax_default_cfg(**kw))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats={},
                               opt_state=tx.init(p64))
        ref = []
        for b in batches:
            jstate, sm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.PRNGKey(0))
            ref.append(jax.device_get(sm))
        new_p = jax.device_get(jstate.params)
    for o, r in zip(ours, ref):
        for k in ("loss_c", "loss_r"):
            np.testing.assert_allclose(o[k].item(), float(r[k]), rtol=1e-5)
    assert state.step == 2
    assert max(p.grad.abs().max().item() for p in model.parameters()) == 1.0  # clipped
    flat = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(model.state_dict())[0]))
    init = dict(jax.tree_util.tree_leaves_with_path(params))
    for k, v in jax.tree_util.tree_leaves_with_path(new_p):
        np.testing.assert_allclose(flat[k], v, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(k))
        assert np.mean(np.abs(flat[k] - v) > 1e-7) < 1e-3, jax.tree_util.keystr(k)
    moved = max(np.abs(v - init[k]).max() for k, v in jax.tree_util.tree_leaves_with_path(new_p))
    assert moved > 1e-3  # the two steps moved some weights by about 2 lr


def test_spn_grads_match_jax():
    """The SPN loss gradients in float64 on both sides (dropout off; the
    logits f32 in both), within 1e-6 of each tensor's largest gradient."""
    S, B = 99, 2
    model, params = spn_pair(S, keep_prob=0.0)
    model.double().train()
    rs = np.random.RandomState(16)
    x = (rs.rand(B, S, S, 3) * 20).astype(np.float32)
    yc = np.zeros((B, NC), np.float32)
    yc[:, :5] = 0.2
    yw = np.zeros((B, NC), np.float32)
    yw[:, 3:8] = rs.dirichlet(np.ones(5), B)
    c, w = model(nchw(x))
    spn_loss(c, w, torch.from_numpy(yc), torch.from_numpy(yw))[0].backward()
    ours = {k: v.grad.numpy() for k, v in model.named_parameters()}
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def loss(p):
            c, w = JaxSPN(NC, keep_prob=0.0, dtype=jnp.float64).apply(
                {"params": p}, jnp.asarray(x), train=True)
            return jax_spn_loss(c, w, jnp.asarray(yc), jnp.asarray(yw))[0]

        ref = flax_to_state_dict(jax.device_get(jax.grad(loss)(p64)))
    assert set(ours) == set(ref)
    for k, g in ours.items():  # ref is converted to f32, 6e-8 relative
        r = ref[k].numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max(), err_msg=k)


@pytest.fixture(scope="module")
def gt_boxes(camera, tango_points):
    """32 random poses, and the tight boxes of their exact distorted
    projections of the conftest model."""
    rs = np.random.RandomState(9)
    q, t = (np.stack(a) for a in zip(*[random_pose(rs) for _ in range(32)]))
    K, dist = camera
    uv = np.stack([np.asarray(jax_project(q[i], t[i], K, dist, tango_points))
                   for i in range(32)])  # (B, 2, N)
    bbox = np.stack([uv[:, 0].min(1), uv[:, 0].max(1), uv[:, 1].min(1), uv[:, 1].max(1)], 1)
    return q.astype(np.float32), t.astype(np.float32), bbox.astype(np.float32)


def test_compute_position_spn_batched_matches_jax(gt_boxes, camera, tango_points):
    q, t, bbox = gt_boxes
    K, dist = (a.astype(np.float32) for a in camera)
    P = tango_points.astype(np.float32)
    ours = compute_position_spn_batched(*(torch.from_numpy(a) for a in (q, bbox, P, K, dist)))
    ref = np.asarray(jax.jit(jax_position)(q, bbox, P, K, dist))
    assert ours.shape == (32, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    # With the true attitude and the exact box, the fit recovers the position.
    np.testing.assert_allclose(ours.numpy(), t, atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def classes(tmp_path_factory):
    """NC attitude classes as an .npy asset."""
    path = str(tmp_path_factory.mktemp("spn_assets") / "classes.npy")
    np.save(path, unit_quats(np.random.RandomState(10), NC))
    return path


def test_spn_eval_step_matches_jax(camera, tango_points, gt_boxes, classes):
    """The port's make_spn_eval_step against the JAX package's on the same
    weights and batch: q_pr, t_pr and the scores per row."""
    S, B = 99, 6
    model, params = spn_pair(S, seed=11)
    q_class = np.load(classes)
    K, dist = (a.astype(np.float32) for a in camera)
    P = tango_points.astype(np.float32)
    q_gt, t_gt, bbox = (a[:B] for a in gt_boxes)
    batch = {"image": np.random.RandomState(12).randint(0, 256, (B, S, S, 3)).astype(np.uint8),
             "bbox": bbox, "q_gt": q_gt, "t_gt": t_gt}
    out = make_spn_eval_step(q_class, P, K, dist, 5, torch.device("cpu"))(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    with jax.default_matmul_precision("float32"):
        ref = jax.device_get(jax_make_spn_eval_step(JaxSPN(NC), q_class, P, K, dist, 5)(
            params, {}, {k: jnp.asarray(v) for k, v in batch.items()}))
    sign = np.sign(np.sum(out["q_pr"].numpy() * ref["q_pr"], 1, keepdims=True))
    np.testing.assert_allclose(out["q_pr"].numpy() * sign, ref["q_pr"], atol=1e-5)
    np.testing.assert_allclose(out["t_pr"].numpy(), ref["t_pr"], atol=1e-4)
    for k, tol in (("err_q", 2e-4), ("err_t", 1e-4), ("speed_raw", 1e-5), ("speed_mod", 1e-5)):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=tol, err_msg=k)
    np.testing.assert_array_equal(out["acc"].numpy(), ref["acc"])


def test_ghiasi_227_gives_228_as_jax_plain_lowering():
    """SPN's 227^2 through the generator: 227 -> 114 -> 57 (B1's odd slab) ->
    114 -> 228, as the JAX package's plain lowering (use_pallas=False,
    tpu_opt=False); 1e-4 of the output scale, test_torch_models.py's Ghiasi
    tolerance."""
    rs = np.random.RandomState(13)
    x = rs.rand(1, 227, 227, 3).astype(np.float32)
    st = (rs.randn(1, 100) * 0.5).astype(np.float32)
    torch.manual_seed(14)
    ours = Ghiasi().eval()
    params, _ = state_dict_to_flax(ours.state_dict())
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.jit(lambda p, x, s: JaxGhiasi(use_pallas=False, tpu_opt=False)
                                 .apply({"params": p}, x, s))(params, jnp.asarray(x),
                                                              jnp.asarray(st)))
    with torch.no_grad():
        out = ours(nchw(x), torch.from_numpy(st)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (1, 228, 228, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


S_CLI = 99
N_TEST = 4


@pytest.fixture(scope="module")
def data(tmp_path_factory, classes):
    """The JAX package's fake dataset with SPN CSVs binned against the NC
    classes (train: 8 rows, test: 4)."""
    root = str(tmp_path_factory.mktemp("torch_spn"))
    generate_fake_speedplus(root, num_train=8, num_test=N_TEST)
    import preprocess

    for domain, jsonfile, csv in (("synthetic", "train.json", "splits_spn/train.csv"),
                                  ("lightbox", "test.json", "splits_spn/lightbox.csv")):
        preprocess.main(["--dataroot", root, "--domain", domain, "--jsonfile", jsonfile,
                         "--csvfile", csv, "--model_name", "spn", "--attitude_class",
                         classes])
    return root


def cfg_kw(data, classes):
    return dict(dataroot=data, model_name="spn", input_shape=(S_CLI, S_CLI), num_classes=NC,
                attitude_class=classes, num_workers=2, batch_size=4, eval_batch_size=4)


@pytest.mark.parametrize("is_train", [True, False])
def test_spn_dataset_matches_jax(data, classes, is_train):
    kw = cfg_kw(data, classes)
    ours = SPNDataset(default_cfg(**kw), is_train=is_train, is_source=is_train)
    ref = JaxSPNDataset(jax_default_cfg(**kw), is_train=is_train, is_source=is_train)
    assert len(ours) == len(ref) == (8 if is_train else N_TEST)
    keys = ("image", "y_classes", "y_weights") if is_train else ("image", "bbox", "q_gt", "t_gt")
    for i in range(len(ours)):
        o, r = ours[i], ref[i]
        assert set(o) == set(r) == set(keys)
        for k in keys:
            assert o[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
        if is_train:
            assert o["y_classes"].sum() == pytest.approx(1.0)
            assert (o["y_classes"] > 0).sum() == 5


def cli_args(data, classes, logdir, **extra):
    args = ["--dataroot", data, "--savedir", os.path.join(data, "save"),
            "--logdir", os.path.join(data, logdir), "--model_name", "spn",
            "--input_shape", str(S_CLI), str(S_CLI), "--num_classes", str(NC),
            "--attitude_class", classes, "--batch_size", "4", "--max_epochs", "1",
            "--num_workers", "2", "--eval_batch_size", "4", "--resultfn", "results.txt"]
    for k, v in extra.items():
        args += [f"--{k}"] + ([] if v is None else [str(v)])
    return args


DUMPS = ("err_q.txt", "err_t.txt", "speed_raw.txt", "speed_mod.txt")
ROW_TOL = {"err_q.txt": 2e-4, "err_t.txt": 2e-5, "speed_raw.txt": 2e-5, "speed_mod.txt": 2e-5}


def read_dumps(logdir):
    out = {}
    for name in DUMPS:
        with open(os.path.join(logdir, name)) as f:
            out[name] = np.array([float(v) for v in f.read().split()])
        assert out[name].shape == (N_TEST,) and np.isfinite(out[name]).all(), name
    return out


def test_spn_train_and_test_cli(data, classes):
    """The styled SPN trainer with --test_epoch 1 on the CPU, then the test
    CLI on its model_best.pt: the same dumps as the trainer's validation."""
    records = train.main(cli_args(data, classes, "train_log", test_epoch=1, no_cuda=None,
                                  start_over=None, randomize_texture=None,
                                  texture_ratio=1.0, optimizer="adamw"))
    assert len(records) == 2 and all(r["styled"] for r in records)
    assert all(np.isfinite(r["loss_c"]) and np.isfinite(r["loss_r"]) for r in records)
    for f in ("checkpoint.pt", "model_best.pt", "config.txt"):
        assert os.path.exists(os.path.join(data, "save", f))
    with open(os.path.join(data, "train_log", "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train/loss_c", "train/loss_r", "Valid/err_q [deg]"} <= tags
    assert "train/loss_x" not in tags
    valid = read_dumps(os.path.join(data, "train_log"))
    test_cli.main(cli_args(data, classes, "test_log", no_cuda=None,
                           pretrained=os.path.join(data, "save", "model_best.pt")))
    for name, v in read_dumps(os.path.join(data, "test_log")).items():
        np.testing.assert_array_equal(v, valid[name], err_msg=name)


def test_test_cli_scores_a_jax_msgpack_as_jax(data, classes, tmp_path):
    """A JAX SPN initialized by model.init and written by flax's to_bytes:
    the port's test CLI and the JAX package's give the same dumps."""
    from flax import serialization

    import test as jax_test_cli

    variables = JaxSPN(NC).init(jax.random.PRNGKey(15), jnp.zeros((1, S_CLI, S_CLI, 3)),
                                train=False)
    path = str(tmp_path / "model_best.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"params": variables["params"]}))
    with jax.default_matmul_precision("float32"):
        jax_test_cli.main(jax_parse_cfg(cli_args(data, classes, "jax_eval", pretrained=path)))
    ref = read_dumps(os.path.join(data, "jax_eval"))
    test_cli.main(cli_args(data, classes, "port_eval", no_cuda=None, pretrained=path))
    for name, v in read_dumps(os.path.join(data, "port_eval")).items():
        np.testing.assert_allclose(v, ref[name], rtol=0, atol=ROW_TOL[name], err_msg=name)


def test_cli_rejects_a_class_count_mismatch(data, classes):
    with pytest.raises(ValueError, match="num_classes"):
        train.main(cli_args(data, classes, "bad_log", no_cuda=None, start_over=None,
                            num_classes=NC + 1, savedir=os.path.join(data, "bad_save")))


def test_get_model_builds_each_model():
    cfg = default_cfg(model_name="spn", num_classes=NC, input_shape=(99, 99))
    assert isinstance(get_model(cfg), SpacecraftPoseNet)
    cfg.model_name = "krn"
    assert not isinstance(get_model(cfg), SpacecraftPoseNet)
    cfg.dann = True  # DANN: KRN inside RevGrad, and for KRN only
    assert isinstance(get_model(cfg), RevGrad)
    cfg.model_name = "spn"
    with pytest.raises(ValueError):
        get_model(cfg)
    cfg.model_name, cfg.dann = "foo", False
    with pytest.raises(ValueError):
        get_model(cfg)


def test_convert_round_trips_the_spn_tree():
    """Grouped HWIO (k, k, I/g, O) kernels become OIHW (O, I/g, k, k), Dense
    kernels transpose, and there are no batch_stats."""
    model, params = spn_pair(99)
    assert params["conv2"]["kernel"].shape == (5, 5, 48, 256)
    assert params["fc6"]["kernel"].shape == (1024, 4096)
    sd = flax_to_state_dict(params, {})
    assert sd["conv2.weight"].shape == (256, 48, 5, 5)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert set(sd) == set(model.state_dict())
