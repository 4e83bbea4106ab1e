"""Port KRN evaluation against the JAX package on the CPU: the SPEED score,
the eval forward, the pose and score of the eval step, ``run_validation``
and the test CLI (JAX ``.msgpack`` and port ``.pt`` checkpoints), the train
CLI's validation, and the misc/visualize helpers.

Method. A random-init KRN regresses keypoints far from any projection of
the model, and EPnP on them is ill-conditioned: f32 rounding can then
decide which beta candidate wins. So the two halves are held apart:
  * the forward (random weights, converted with ``flax_to_state_dict``)
    gives the same xc/yc as the JAX KRN within 1e-4 of the output scale, the
    tolerance of test_torch_models.py::test_krn_eval_forward;
  * the whole loop runs on both sides with a KRN whose head kernel is zero
    and whose head bias is one fixed, well-conditioned keypoint set (the
    model's projection at a known pose, normalized to its 1.2x RoI): both
    frameworks then regress exactly those keypoints for every image, and the
    pose, scores, dumps, meters and results.txt are compared row for row.
    The eval crop boxes are square, so each image's keypoints are a similar
    image of a true projection and EPnP is well posed.
Tolerances: per-row err_q 2e-4 deg, err_t 2e-5 m, speeds 2e-5 (EPnP agrees
to a few 1e-7 in q and 1e-6 m in t, test_torch_geometry.py, and the dumps
are printed to 1e-5); meters 1e-5 relative.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import parse_cfg as jax_parse_cfg
from speedplusbaseline_tpu.data import generate_fake_speedplus
from speedplusbaseline_tpu.geometry import keypoints_to_pose as jax_keypoints_to_pose
from speedplusbaseline_tpu.geometry import project_keypoints as jax_project
from speedplusbaseline_tpu.io_utils import misc as jax_misc
from speedplusbaseline_tpu.io_utils import visualize as jax_vis
from speedplusbaseline_tpu.io_utils.checkpoint import save_checkpoint as jax_save_checkpoint
from speedplusbaseline_tpu.metrics import speed_score_batched as jax_speed_score_batched
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch import train
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from speedplusbaseline_tpu_torch.data import make_dataloader
from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer, images_to_float,
                                                make_krn_eval_step)
from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose
from speedplusbaseline_tpu_torch.io_utils import (load_camera_intrinsics,
                                                  load_tango_3d_keypoints, save_checkpoint)
from speedplusbaseline_tpu_torch.io_utils import misc, visualize
from speedplusbaseline_tpu_torch.metrics import POS_THRESH, ROT_THRESH_DEG, speed_score_batched
from speedplusbaseline_tpu_torch.models.krn import KeypointRegressionNet

torch.set_num_threads(1)

S = 32
N_TEST = 6  # eval batch 4: one full batch and a tail of 2
DUMPS = ("err_q.txt", "err_t.txt", "speed_raw.txt", "speed_mod.txt")
ROW_TOL = {"err_q.txt": 2e-4, "err_t.txt": 2e-5, "speed_raw.txt": 2e-5, "speed_mod.txt": 2e-5}


def _score_inputs():
    """Random poses plus the edge cases: zero error, a translation error of
    exactly POS_THRESH (relative, |t| = 1), rotations 0.01 deg either side
    of ROT_THRESH_DEG, and |q . q| rounding above 1."""
    rs = np.random.RandomState(0)
    q_gt = rs.randn(12, 4)
    q_gt /= np.linalg.norm(q_gt, axis=1, keepdims=True)
    t_gt = rs.uniform(-1, 1, (12, 3)) + [0, 0, 6]
    q_pr = q_gt + 0.01 * rs.randn(12, 4)
    t_pr = t_gt + 0.02 * rs.randn(12, 3)
    q_pr[0], t_pr[0] = q_gt[0], t_gt[0]
    t_gt[1], q_pr[1] = [0, 0, 1], q_gt[1]
    t_pr[1] = [np.float32(POS_THRESH), 0, 1]
    for i, deg in ((2, ROT_THRESH_DEG - 0.01), (3, ROT_THRESH_DEG + 0.01)):
        half = np.deg2rad(deg) / 2
        q_gt[i], q_pr[i], t_pr[i] = [1, 0, 0, 0], [np.cos(half), np.sin(half), 0, 0], t_gt[i]
    q_pr[4] = q_gt[4] * (1 + 3e-7)  # |q . q| > 1
    return [np.asarray(a, np.float32) for a in (t_pr, q_pr, t_gt, q_gt)]


def test_speed_score_batched_matches_jax():
    args = _score_inputs()
    ours = speed_score_batched(*(torch.from_numpy(a) for a in args))
    ref = jax_speed_score_batched(*(jnp.asarray(a) for a in args))
    for k in ("err_q", "err_t", "speed_raw", "speed_mod", "acc"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # zero error: err_q sits at the f32 acos floor (sum q*q a few ulps under
    # 1), under the threshold, so speed_mod is exactly 0
    assert ours["err_t"][0] == 0 and ours["speed_mod"][0] == 0 and ours["acc"][0] == 1
    assert ours["speed_mod"][1] == ours["speed_raw"][1] and ours["acc"][1] == 0
    assert ours["acc"][2] == 1 and ours["acc"][3] == 0
    assert ours["err_q"][4] == 0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_eval"))
    generate_fake_speedplus(root, num_train=4, num_test=N_TEST)
    import preprocess

    for domain, jsonfile, csv in (("synthetic", "train.json", "splits_krn/train.csv"),
                                  ("lightbox", "test.json", "splits_krn/lightbox.csv")):
        preprocess.main(["--dataroot", root, "--domain", domain, "--jsonfile", jsonfile,
                         "--csvfile", csv, "--model_name", "krn"])
    return root


def cli_args(data, logdir, **extra):
    args = ["--dataroot", data, "--savedir", os.path.join(data, "save"),
            "--logdir", os.path.join(data, logdir), "--input_shape", str(S), str(S),
            "--batch_size", "4", "--max_epochs", "1", "--num_workers", "2",
            "--eval_batch_size", "4", "--resultfn", "results.txt"]
    for k, v in extra.items():
        args += [f"--{k}"] + ([] if v is None else [str(v)])
    return args


def fixed_keypoints(data):
    """The Tango points projected by the dataset's camera at one pose,
    normalized to their 1.2x square RoI: (K,) x and y."""
    K, dist = load_camera_intrinsics(os.path.join(data, "speedplus", "camera.json"))
    q = np.array([0.9, 0.2, -0.3, 0.1]) / np.linalg.norm([0.9, 0.2, -0.3, 0.1])
    uv = np.asarray(jax_project(q, np.array([0.05, -0.02, 4.5]), K, dist,
                                load_tango_3d_keypoints()))
    c, half = uv.mean(1), 0.6 * (uv.max(1) - uv.min(1)).max()
    return (uv - (c - half)[:, None]) / (2 * half)


@pytest.fixture(scope="module")
def ckpts(data):
    """The fixed-keypoint KRN (random backbone, zero head kernel, the head
    bias set to fixed_keypoints) as the JAX package's model_best.msgpack and
    checkpoint.msgpack and the port's model_best.pt and checkpoint.pt."""
    torch.manual_seed(0)
    model = KeypointRegressionNet(11, (S, S))
    with torch.no_grad():
        model.head.weight.zero_()
        model.head.bias.copy_(torch.from_numpy(fixed_keypoints(data).T.reshape(-1)))
    params, stats = state_dict_to_flax(model.state_dict())
    jdir, pdir = os.path.join(data, "jax_ckpt"), os.path.join(data, "port_ckpt")
    jax_save_checkpoint({"epoch": 1, "model": "krn", "variables": {"params": params,
                                                                   "batch_stats": stats},
                         "opt_state": {}, "step": 1, "best_score": 1}, True, jdir)
    state = TrainState(model, build_optimizer(default_cfg(), model.parameters()))
    save_checkpoint(state.as_checkpoint_dict(1, "krn", 1), True, pdir)
    return {"model_best.msgpack": os.path.join(jdir, "model_best.msgpack"),
            "checkpoint.msgpack": os.path.join(jdir, "checkpoint.msgpack"),
            "model_best.pt": os.path.join(pdir, "model_best.pt"),
            "checkpoint.pt": os.path.join(pdir, "checkpoint.pt")}


def read_dumps(logdir):
    out = {}
    for name in DUMPS:
        with open(os.path.join(logdir, name)) as f:
            out[name] = np.array([float(v) for v in f.read().split()])
    return out


def read_results(logdir):
    with open(os.path.join(logdir, "results.txt")) as f:
        lines = f.read().splitlines()
    return {ln.split(":")[0]: float(ln.split(":")[1].split()[0]) for ln in lines}


@pytest.fixture(scope="module")
def jax_eval(data, ckpts):
    """JAX's test CLI on model_best.msgpack (one eval compile at 32^2)."""
    import test as jax_test_cli

    jax_test_cli.main(jax_parse_cfg(cli_args(data, "jax_eval",
                                             pretrained=ckpts["model_best.msgpack"])))
    return read_dumps(os.path.join(data, "jax_eval")), read_results(
        os.path.join(data, "jax_eval"))


def assert_dumps_close(got, ref):
    for name in DUMPS:
        assert got[name].shape == (N_TEST,) and np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=ROW_TOL[name],
                                   err_msg=name)


@pytest.mark.parametrize("ckpt", ["model_best.msgpack", "checkpoint.msgpack",
                                  "model_best.pt", "checkpoint.pt"])
def test_test_cli_matches_jax(data, ckpts, jax_eval, ckpt):
    """The port's test CLI on each checkpoint form against JAX's test.main on
    the same weights: dumps row for row, results.txt and the meters."""
    ref_dumps, ref_results = jax_eval
    logdir = os.path.join(data, f"port_eval_{ckpt}")
    meters = test_cli.main(cli_args(data, f"port_eval_{ckpt}", pretrained=ckpts[ckpt],
                                    no_cuda=None))
    assert_dumps_close(read_dumps(logdir), ref_dumps)
    results = read_results(logdir)
    assert list(results) == ["eR", "eT", "speed (raw)", "speed (thr)"]
    for k, v in ref_results.items():
        assert results[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
        assert meters[k].avg == pytest.approx(v, rel=1e-5, abs=1e-5), k


def test_test_cli_missing_pretrained_raises(data):
    with pytest.raises(FileNotFoundError):
        test_cli.main(cli_args(data, "port_eval_missing", no_cuda=None,
                               pretrained=os.path.join(data, "no_such.msgpack")))


def test_eval_forward_matches_jax(data):
    """Random KRN weights, converted: the eval batch's xc/yc against the JAX
    KRN (train=False) within 1e-4 of the output scale."""
    torch.manual_seed(1)
    model = KeypointRegressionNet(11, (S, S)).eval()
    params, stats = state_dict_to_flax(model.state_dict())
    model.load_state_dict(flax_to_state_dict(params, stats))
    batch = next(iter(make_dataloader(default_cfg(**vars_of(data)), torch.device("cpu"),
                                      is_train=False)))
    with torch.inference_mode():
        xc, yc = model(images_to_float(batch["image"]))
    x = batch["image"].numpy().astype(np.float32) / 255.0
    with jax.default_matmul_precision("float32"):
        jxc, jyc = jax.jit(lambda v, x: JaxKRN(11).apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    for ours, ref in ((xc, jxc), (yc, jyc)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


def vars_of(data):
    return dict(dataroot=data, input_shape=(S, S), eval_batch_size=4, num_workers=2)


def test_eval_step_runs_geometry_in_f32_under_bf16(data, ckpts):
    """make_krn_eval_step with --use_fp16: the forward in a bf16 autocast
    (the fixed-keypoint head then returns its bias rounded to bf16), the
    pose and scores in f32: bit for bit keypoints_to_pose and
    speed_score_batched run outside any autocast on those keypoints. The
    tail batch keeps its 2 rows."""
    model = KeypointRegressionNet(11, (S, S))
    model.load_state_dict(torch.load(ckpts["model_best.pt"], weights_only=True))
    cfg = default_cfg(**vars_of(data))
    K, dist, P = (torch.from_numpy(a) for a in (
        *load_camera_intrinsics(os.path.join(data, "speedplus", "camera.json")),
        load_tango_3d_keypoints()))
    step = make_krn_eval_step(P, K, dist, torch.device("cpu"), fp16=True)
    kp = torch.from_numpy(fixed_keypoints(data).astype(np.float32)).bfloat16().float()
    sizes = []
    for batch in make_dataloader(cfg, torch.device("cpu"), is_train=False):
        out = step(model, batch)
        B = out["err_q"].shape[0]
        sizes.append(B)
        assert all(v.dtype == torch.float32 for v in out.values())
        q, t = keypoints_to_pose(kp[0].expand(B, -1), kp[1].expand(B, -1), batch["bbox"],
                                 P, K, dist)
        ref = {"q_pr": q, "t_pr": t, **speed_score_batched(t, q, batch["t_gt"], batch["q_gt"])}
        for k, v in ref.items():
            np.testing.assert_array_equal(out[k].numpy(), v.numpy(), err_msg=k)
    assert sizes == [4, 2]


_jax_kp_to_pose = jax.jit(jax_keypoints_to_pose)


def test_pose_and_score_from_jax_keypoints(data, ckpts, jax_eval):
    """JAX's pose and score code and the port's on the same regressed
    keypoints (the fixed set) and crop boxes give the JAX CLI's dumps."""
    ref_dumps, _ = jax_eval
    cfg = default_cfg(**vars_of(data))
    K, dist = load_camera_intrinsics(os.path.join(data, "speedplus", "camera.json"))
    P = load_tango_3d_keypoints()
    kp = fixed_keypoints(data).astype(np.float32)
    rows = {k: [] for k in ("err_q", "err_t", "speed_raw", "speed_mod")}
    for batch in make_dataloader(cfg, torch.device("cpu"), is_train=False):
        B = batch["bbox"].shape[0]
        x, y = np.repeat(kp[0:1], B, 0), np.repeat(kp[1:2], B, 0)
        jq, jt = _jax_kp_to_pose(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(batch["bbox"].numpy()), P, K, dist)
        q, t = keypoints_to_pose(torch.from_numpy(x), torch.from_numpy(y), batch["bbox"],
                                 torch.from_numpy(P), torch.from_numpy(K),
                                 torch.from_numpy(dist))
        np.testing.assert_allclose(np.abs(np.sum(q.numpy() * np.asarray(jq), 1)), 1, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-5)
        m = speed_score_batched(t, q, batch["t_gt"], batch["q_gt"])
        for k in rows:
            rows[k].extend(m[k].tolist())
    assert_dumps_close({f"{k}.txt": np.round(np.array(v), 5) for k, v in rows.items()},
                       ref_dumps)


def test_train_cli_validates(data):
    """train.main with --test_epoch 1 validates after the epoch: the four
    Valid/ scalars, and a dump line per test row."""
    log = os.path.join(data, "train_log")
    train.main(cli_args(data, "train_log", test_epoch=1, no_cuda=None, start_over=None,
                        savedir=os.path.join(data, "train_save")))
    with open(os.path.join(log, "scalars.jsonl")) as f:
        tags = [json.loads(line) for line in f]
    valid = {t["tag"]: t for t in tags if t["tag"].startswith("Valid/")}
    assert set(valid) == {"Valid/err_q [deg]", "Valid/err_t [m]", "Valid/speed (raw) [-]",
                          "Valid/speed (thr) [-]"}
    assert all(t["step"] == 1 and np.isfinite(t["value"]) for t in valid.values())
    dumps = read_dumps(log)
    assert all(v.shape == (N_TEST,) for v in dumps.values())
    assert np.mean(dumps["err_q.txt"]) == pytest.approx(valid["Valid/err_q [deg]"]["value"],
                                                        abs=1e-4)


def test_set_all_seeds_and_compute_mean_std_match_jax():
    g = misc.set_all_seeds(5)
    ours = (np.random.rand(3), torch.rand(2, generator=g))
    jax_misc.set_all_seeds(5)
    np.testing.assert_array_equal(ours[0], np.random.rand(3))
    assert torch.equal(ours[1], torch.rand(2, generator=torch.Generator().manual_seed(5)))
    rs = np.random.RandomState(1)
    batches = [{"image": rs.randint(0, 256, (2, 5, 4, 3)).astype(np.uint8)} for _ in range(3)]
    ref = jax_misc.compute_mean_std(batches)
    got = misc.compute_mean_std([{"image": torch.from_numpy(b["image"])} for b in batches])
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_, r_, rtol=1e-12)


def test_visualize_helpers_match_jax():
    import matplotlib.pyplot as plt

    rs = np.random.RandomState(2)
    img = rs.rand(3, 12, 10).astype(np.float32)  # CHW
    x, y, bbox = rs.rand(11), rs.rand(11), np.array([1.0, 8.0, 2.0, 9.0])
    pairs = [(visualize.imshow(torch.from_numpy(img)), jax_vis.imshow(img)),
             (visualize.plot_2D_bbox(torch.from_numpy(img), torch.from_numpy(bbox)),
              jax_vis.plot_2D_bbox(img, bbox)),
             (visualize.scatter_keypoints(torch.from_numpy(img), torch.from_numpy(x),
                                          torch.from_numpy(y)),
              jax_vis.scatter_keypoints(img, x, y))]
    for ours, ref in pairs:
        a, b = ours.axes[0], ref.axes[0]
        np.testing.assert_array_equal(a.images[0].get_array(), b.images[0].get_array())
        assert [p.get_bbox().bounds for p in a.patches] == [p.get_bbox().bounds
                                                           for p in b.patches]
        for ca, cb in zip(a.collections, b.collections):
            np.testing.assert_array_equal(ca.get_offsets(), cb.get_offsets())
        plt.close(ours)
        plt.close(ref)
