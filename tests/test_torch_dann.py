"""Port DANN adaptation against the JAX package on the CPU: the gradient
reversal layer, the domain classifier, RevGrad and KRN's backbone map, the
BCE loss, one whole DANN step (float64), the DANN epoch loop, the adapt CLI
end to end, and the test CLI on DANN checkpoints.

The step. JAX's ``make_dann_train_step`` runs its augs inside the step from
its key; the port's ``dann_step`` takes the draws, so the test hands it
JAX's, re-derived by ``jax_draws`` from ``split(fold_in(key, 0))``. Both
sides run in float64 (at random init a 1e-7 change of the input moves the
KRN gradients by percents, test_torch_train.py), so the images go in as
float64 on both sides and JAX runs under ``enable_x64`` (its draws then are
float64 ones, and ``jax_draws`` runs there too). XLA fuses the brightness
and noise augs' multiply-adds, torch does not, so the key is one whose
draws fire only rotations and flips, which are exact: from KEY both streams
are augmented, and no sample is brightened or noised. Tolerances: the three
losses 1e-5 relative (JAX's BCE targets are float64 under x64, so its
domain losses are float64 where the port's are f32); the parameters after
one AdamW step within 1e-7; the running statistics after both forwards
within 1e-6 relative. The domain branch's gradient passes through an f32
cast at the reversal layer on both sides, as JAX's ``feat.astype(float32)``.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.config import parse_cfg as jax_parse_cfg
from speedplusbaseline_tpu.engine.loops import train_epoch as jax_train_epoch
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
from speedplusbaseline_tpu.engine.steps import make_dann_train_step as jax_make_dann_train_step
from speedplusbaseline_tpu.io_utils.checkpoint import save_checkpoint as jax_save_checkpoint
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.revgrad import DomainClassifier as JaxDomainClassifier
from speedplusbaseline_tpu.models.revgrad import RevGrad as JaxRevGrad
from speedplusbaseline_tpu.models.revgrad import bce_with_logits as jax_bce_with_logits
from speedplusbaseline_tpu.models.revgrad import grad_reverse as jax_grad_reverse
from speedplusbaseline_tpu_torch import adapt, train
from speedplusbaseline_tpu_torch import preprocess as preprocess_cli
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.data import generate_fake_speedplus
from speedplusbaseline_tpu_torch.engine import TrainState, build_optimizer, dann_step, train_epoch
from speedplusbaseline_tpu_torch.models import (DomainClassifier, KeypointRegressionNet, RevGrad,
                                                bce_with_logits, get_model, grad_reverse)
from test_torch_augment import jax_draws
from test_torch_eval import DUMPS, N_TEST, assert_dumps_close, fixed_keypoints, read_dumps

torch.set_num_threads(1)

S = 64
KEY = 137  # only rotations and flips fire in either stream of step 0


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=rel * max(1.0, np.abs(ref).max()))


def jax_apply(model, variables, x, **kw):
    fn = jax.jit(lambda v, x: model.apply(v, x, **kw))
    with jax.default_matmul_precision("float32"):
        return jax.device_get(fn(variables, jnp.asarray(x)))


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_grad_reverse_matches_jax_vjp(alpha):
    """Identity forward; backward -alpha * g, and no gradient for alpha."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5).astype(np.float32)
    g = rs.randn(3, 5).astype(np.float32)
    lam = np.float32(alpha)
    y_ref, vjp = jax.vjp(jax_grad_reverse, jnp.asarray(x), jnp.asarray(lam))
    gx_ref, glam_ref = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = grad_reverse(xt, lam)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_ref))
    assert float(glam_ref) == 0.0


@pytest.mark.parametrize("side", [2, 7])
def test_domain_classifier_matches_flax(side):
    """A mean over the whole map: at 2x2 (the CPU tests' 64^2 input) as at
    7x7 (224^2), where it is the reference's AvgPool2d(7)."""
    torch.manual_seed(0)
    ours = DomainClassifier().eval()
    params, _ = state_dict_to_flax(ours.state_dict())
    feat = np.random.RandomState(1).randn(3, side, side, 320).astype(np.float32)
    ref = jax_apply(JaxDomainClassifier(), {"params": params}, feat)
    with torch.no_grad():
        got = ours(nchw(feat))
    assert got.shape == (3,) and got.dtype == torch.float32
    close(got, ref)


@pytest.fixture(scope="module")
def revgrad():
    """The port's RevGrad at 64^2 with non-trivial running stats, and its
    flax (params, batch_stats)."""
    torch.manual_seed(0)
    ours = RevGrad(11, (S, S))
    rs = np.random.RandomState(0)
    for _, buf in ours.named_buffers():
        buf.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    params, stats = state_dict_to_flax(ours.state_dict())
    return ours, params, stats


def test_revgrad_convert_round_trip(revgrad):
    """flax's names: net/... and domain_classifier/conv0, conv1; only the
    net has batch_stats."""
    ours, params, stats = revgrad
    assert set(params) == {"net", "domain_classifier"} and set(stats) == {"net"}
    assert params["domain_classifier"]["conv0"]["kernel"].shape == (1, 1, 320, 1280)
    assert params["domain_classifier"]["conv1"]["kernel"].shape == (1, 1, 1280, 1)
    sd = flax_to_state_dict(params, stats)
    assert set(sd) == set(ours.state_dict())
    for k, v in ours.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_revgrad_forward_matches_flax(revgrad, alpha):
    """Eval forwards on converted weights: (xc, yc) without alpha, ((xc,
    yc), logits) with it, and the same (xc, yc) either way."""
    ours, params, stats = revgrad
    x = np.random.RandomState(2).rand(2, S, S, 3).astype(np.float32)
    ref = jax_apply(JaxRevGrad(11), {"params": params, "batch_stats": stats}, x, train=False,
                    alpha=alpha)
    ours.eval()
    with torch.no_grad():
        got = ours(nchw(x), alpha)
        plain = ours(nchw(x))
    if alpha is None:
        close(got[0], ref[0])
        close(got[1], ref[1])
        return
    (xc, yc), dom = got
    (rxc, ryc), rdom = ref
    assert dom.shape == (2,)
    for o, r in ((xc, rxc), (yc, ryc), (dom, rdom)):
        close(o, r)
    assert torch.equal(xc, plain[0]) and torch.equal(yc, plain[1])


def test_return_features_matches_flax(revgrad):
    """KRN's return_features gives the backbone's 320-channel map."""
    _, params, stats = revgrad
    ours = KeypointRegressionNet(11, (S, S))
    ours.load_state_dict(flax_to_state_dict(params["net"], stats["net"]))
    ours.eval()
    x = np.random.RandomState(3).rand(2, S, S, 3).astype(np.float32)
    xc, yc, feat = jax_apply(JaxKRN(11), {"params": params["net"],
                                          "batch_stats": stats["net"]}, x, train=False,
                             return_features=True)
    with torch.no_grad():
        oxc, oyc, ofeat = ours(nchw(x), return_features=True)
    assert tuple(ofeat.shape) == (2, 320, 2, 2)
    close(ofeat.permute(0, 2, 3, 1), feat)
    close(oxc, xc)
    close(oyc, yc)


def test_bce_with_logits_matches_jax():
    logits = np.array([-100.0, -30.0, -2.5, -1e-3, 0.0, 0.7, 3.0, 30.0, 100.0], np.float32)
    for targets in (np.ones_like(logits), np.zeros_like(logits),
                    np.linspace(0, 1, logits.size).astype(np.float32)):
        ref = float(jax_bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)))
        got = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)).item()
        assert np.isfinite(got)
        assert got == pytest.approx(ref, rel=1e-6)


def test_dann_step_matches_jax(revgrad):
    """One AdamW DANN step of the port (dann_step) against JAX's
    make_dann_train_step in float64, at alpha 0.37."""
    _, params, stats = revgrad
    B = 2
    rs = np.random.RandomState(4)
    src = rs.rand(B, S, S, 3)
    tgt = rs.rand(B, S, S, 3)
    keypts = rs.rand(B, 2, 11).astype(np.float32)
    alpha = np.float32(0.37)
    key = jax.random.PRNGKey(KEY)
    kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01, dann=True)

    with jax.enable_x64():
        src_key, tgt_key = jax.random.split(jax.random.fold_in(key, 0))
        draws = [jax_draws(k, B, S) for k in (src_key, tgt_key)]
        tx = jax_build_optimizer(jax_default_cfg(**kw), 10)
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64,
                               opt_state=tx.init(p64))
        step = jax_make_dann_train_step(JaxRevGrad(11, dtype=jnp.float64), tx, None)
        new_state, aux = jax.device_get(step(
            jstate, {"image": jnp.asarray(src), "keypts": jnp.asarray(keypts)},
            {"image": jnp.asarray(tgt)}, key, jnp.float32(alpha)))
    for d in draws:  # both streams augmented, by exact augs only
        assert not (d["bc_on"].any() or d["noise_on"].any())
        assert (d["rot_on"] | d["flip_on"]).any()

    model = RevGrad(11, (S, S))
    model.load_state_dict(flax_to_state_dict(params, stats))
    model = model.double()
    state = TrainState(model, build_optimizer(default_cfg(**kw), model.parameters()))
    sm = dann_step(state, torch.from_numpy(src), torch.from_numpy(keypts), draws[0],
                   torch.from_numpy(tgt), draws[1], alpha, False)
    assert state.step == 1
    for k in ("loss_pose", "loss_source", "loss_target"):
        np.testing.assert_allclose(sm[k].item(), float(aux[k]), rtol=1e-5, err_msg=k)
    ours_p, ours_bs = state_dict_to_flax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_p))
    leaves = jax.tree_util.tree_leaves_with_path(new_state.params)
    assert len(flat) == len(leaves)
    for k, v in leaves:
        np.testing.assert_allclose(flat[k], v, atol=1e-7, err_msg=jax.tree_util.keystr(k))
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_bs))
    for k, v in jax.tree_util.tree_leaves_with_path(new_state.batch_stats):
        np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(k))


class _Loader:
    def __init__(self, n, tag):
        self.n, self.tag, self.epochs = n, tag, []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter({"image": np.full((2, 1, 1, 3), i, np.uint8), "tag": self.tag}
                    for i in range(self.n))


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


@pytest.mark.parametrize("lens", [(5, 3), (3, 4)])
def test_dann_epoch_loop_matches_jax(lens):
    """The DANN epoch against JAX's train_epoch with stub steps: both loaders
    get set_epoch, n_batches is the shorter length, the source and target
    batches are zipped in order, alpha is the adapt CLI's schedule as an
    np.float32, and the train/ scalars are the meters' means."""
    cfg = SimpleNamespace(model_name="krn", dann=True, seed=2021, texture_ratio=0.5,
                          max_epochs=3)
    epoch = 1
    calls = {"jax": [], "port": []}

    def losses(i):
        return {"loss_pose": 0.5 + i, "loss_source": 0.25 * i, "loss_target": 1.0 / (i + 1)}

    def jax_step(state, src, tgt, rng, alpha):
        calls["jax"].append((int(src["image"][0, 0, 0, 0]), int(tgt["image"][0, 0, 0, 0]),
                             type(alpha), alpha))
        return state, losses(len(calls["jax"]))

    def port_step(state, src, tgt, alpha):
        calls["port"].append((int(src["image"][0, 0, 0, 0]), int(tgt["image"][0, 0, 0, 0]),
                              type(alpha), alpha))
        return {k: torch.tensor(v) for k, v in losses(len(calls["port"])).items()}

    def jax_alpha(idx, n_batches):  # the JAX adapt.py schedule (adapt.py:95-97)
        p = float(idx + epoch * n_batches) / cfg.max_epochs / n_batches
        return 2.0 / (1.0 + np.exp(-10.0 * p)) - 1.0

    jw, pw = _Writer(), _Writer()
    jl, pl = (_Loader(lens[0], "s"), _Loader(lens[1], "t")), (_Loader(lens[0], "s"),
                                                               _Loader(lens[1], "t"))
    jax_train_epoch(epoch + 1, cfg, None, jax_step, None, None, jw, dann_loaders=jl,
                    dann_alpha_fn=jax_alpha)
    records = train_epoch(epoch + 1, cfg, None, port_step, None, pw, dann_loaders=pl,
                          dann_alpha_fn=lambda i, n: adapt.grl_alpha(i, n, epoch,
                                                                     cfg.max_epochs))
    n = min(lens)
    assert len(calls["port"]) == len(records) == n
    assert calls["port"] == calls["jax"]
    assert all(t is np.float32 for _, _, t, _ in calls["port"])
    assert [loader.epochs for loader in pl] == [[epoch + 1], [epoch + 1]]
    assert sorted(t for t, _, _ in pw.scalars) == ["train/loss_pose", "train/loss_source",
                                                    "train/loss_target"]
    ref = {t: v for t, v, _ in jw.scalars}
    for tag, value, step in pw.scalars:
        assert step == epoch + 1
        assert value == pytest.approx(ref[tag], rel=1e-6), tag
    assert [r["step"] for r in records] == list(range(n))
    assert not any(r["styled"] for r in records)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A fake dataset made and labelled by the port alone: its generator
    and its preprocess CLI, on the CPU."""
    root = str(tmp_path_factory.mktemp("torch_dann"))
    generate_fake_speedplus(root, num_train=8, num_test=N_TEST, device=torch.device("cpu"))
    for domain, jsonfile, csv in (("synthetic", "train.json", "splits_krn/train.csv"),
                                  ("lightbox", "test.json", "splits_krn/lightbox.csv")):
        preprocess_cli.main(["--dataroot", root, "--domain", domain, "--jsonfile", jsonfile,
                             "--csvfile", csv, "--no_cuda"])
    return root


def cli_args(data, logdir, **extra):
    args = ["--dataroot", data, "--savedir", os.path.join(data, "save"),
            "--logdir", os.path.join(data, logdir), "--input_shape", "32", "32",
            "--batch_size", "2", "--max_epochs", "1", "--num_workers", "2",
            "--eval_batch_size", "4", "--resultfn", "results.txt", "--perform_dann"]
    for k, v in extra.items():
        args += [f"--{k}"] + ([] if v is None else [str(v)])
    return args


def test_adapt_cli_end_to_end(data):
    """adapt.main on the CPU for one epoch with validation: 3 steps (the 6
    target rows in batches of 2 against 4 source batches), alpha rising from
    0, finite losses, the three train/ tags and the Valid/ tags, both
    checkpoints (model "krn", RevGrad's weights); then the test CLI with
    --perform_dann on model_best.pt gives the validation's dumps."""
    records = adapt.main(cli_args(data, "adapt_log", test_epoch=1, no_cuda=None,
                                  start_over=None))
    assert len(records) == 3
    assert records[0]["alpha"] == 0.0 and 0 < records[1]["alpha"] < records[2]["alpha"] < 1
    for r in records:
        assert all(np.isfinite(r[k]) for k in ("loss_pose", "loss_source", "loss_target"))
    with open(os.path.join(data, "adapt_log", "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert tags == {"train/loss_pose", "train/loss_source", "train/loss_target",
                    "Valid/err_q [deg]", "Valid/err_t [m]", "Valid/speed (raw) [-]",
                    "Valid/speed (thr) [-]"}
    ckpt = torch.load(os.path.join(data, "save", "checkpoint.pt"), weights_only=True)
    assert ckpt["model"] == "krn" and ckpt["epoch"] == 1 and ckpt["step"] == 3
    best = torch.load(os.path.join(data, "save", "model_best.pt"), weights_only=True)
    assert "domain_classifier.conv0.weight" in best and "net.head.bias" in best
    valid = read_dumps(os.path.join(data, "adapt_log"))
    test_cli.main(cli_args(data, "adapt_test_log", no_cuda=None,
                           pretrained=os.path.join(data, "save", "model_best.pt")))
    for name, v in read_dumps(os.path.join(data, "adapt_test_log")).items():
        assert v.shape == (N_TEST,)
        np.testing.assert_array_equal(v, valid[name], err_msg=name)
    # auto-resume goes on at epoch 2 from the saved step
    records = adapt.main(cli_args(data, "adapt_log", no_cuda=None, max_epochs=2))
    assert [r["epoch"] for r in records] == [2, 2, 2]
    assert torch.load(os.path.join(data, "save", "checkpoint.pt"),
                      weights_only=True)["step"] == 6


def test_test_cli_scores_a_jax_dann_msgpack_as_jax(data, tmp_path):
    """A DANN RevGrad whose KRN regresses one fixed keypoint set (zero head
    kernel), written as the JAX package's checkpoint.msgpack: the port's test
    CLI with --perform_dann and JAX's test.main give the same dumps."""
    import test as jax_test_cli

    torch.manual_seed(3)
    model = RevGrad(11, (32, 32))
    with torch.no_grad():
        model.net.head.weight.zero_()
        model.net.head.bias.copy_(torch.from_numpy(fixed_keypoints(data).T.reshape(-1)))
    params, stats = state_dict_to_flax(model.state_dict())
    jdir = str(tmp_path / "jax_dann")
    jax_save_checkpoint({"epoch": 1, "model": "krn", "variables": {"params": params,
                                                                   "batch_stats": stats},
                         "opt_state": {}, "step": 1, "best_score": 1}, True, jdir)
    path = os.path.join(jdir, "checkpoint.msgpack")
    jax_test_cli.main(jax_parse_cfg(cli_args(data, "jax_dann_eval", pretrained=path)))
    test_cli.main(cli_args(data, "port_dann_eval", no_cuda=None, pretrained=path))
    assert_dumps_close(read_dumps(os.path.join(data, "port_dann_eval")),
                       read_dumps(os.path.join(data, "jax_dann_eval")))
    assert set(DUMPS) <= set(os.listdir(os.path.join(data, "port_dann_eval")))


@pytest.mark.parametrize("main", [adapt.main, train.main, test_cli.main],
                         ids=["adapt", "train", "test"])
def test_spn_dann_raises(main, tmp_path):
    with pytest.raises(ValueError, match="KRN"):
        main(["--model_name", "spn", "--perform_dann", "--no_cuda",
              "--savedir", str(tmp_path / "s"), "--logdir", str(tmp_path / "l")])


def test_adapt_refuses_without_perform_dann(tmp_path):
    with pytest.raises(ValueError, match="--perform_dann"):
        adapt.main(["--no_cuda", "--savedir", str(tmp_path / "s"),
                    "--logdir", str(tmp_path / "l")])


def test_adapt_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        adapt.main(["--perform_dann", "--savedir", str(tmp_path / "s"),
                    "--logdir", str(tmp_path / "l")])


def test_get_model_builds_revgrad():
    cfg = default_cfg(dann=True, input_shape=(S, S))
    model = get_model(cfg)
    assert isinstance(model, RevGrad)
    assert model.net.head.kernel_size == (2, 2)
