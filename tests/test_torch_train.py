"""Port training pieces against the JAX package: the optimizers and StepLR,
one whole styled train step, the host style gate, the loader's batches, and
the train CLI end to end on the CPU.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.augment.photometric import augment_batch
from speedplusbaseline_tpu.augment.styleaug import StyleAugmentor as JaxStyleAugmentor
from speedplusbaseline_tpu.augment.styleaug import random_style_stats
from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.data import DataLoader as JaxDataLoader
from speedplusbaseline_tpu.data import KRNDataset as JaxKRNDataset
from speedplusbaseline_tpu.data import generate_fake_speedplus
from speedplusbaseline_tpu.engine.loops import train_epoch as jax_train_epoch
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.optim import step_lr_schedule as jax_schedule
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.krn import krn_loss as jax_krn_loss
from speedplusbaseline_tpu_torch import adapt, train
from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import state_dict_to_flax
from speedplusbaseline_tpu_torch.data import DataLoader, KRNDataset
from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer, krn_step,
                                                set_lr, step_lr_schedule, train_epoch)
from speedplusbaseline_tpu_torch.engine import state as state_module
from speedplusbaseline_tpu_torch.models.krn import KeypointRegressionNet
from test_torch_augment import jax_draws

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["sgd", "rmsprop", "adam", "adamw"])
def test_optimizer_matches_optax(name):
    """Six steps on identical grads (some above the clip norm of 1.0) over
    three epochs of a StepLR decay, against the optax chain; f32, 1e-5."""
    kw = dict(optimizer=name, lr=0.01, momentum=0.9, weight_decay=0.05,
              lr_decay_alpha=0.5, lr_decay_step=1)
    cfg, jcfg = default_cfg(**kw), jax_default_cfg(**kw)
    rs = np.random.RandomState(0)
    init = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    spe = 2
    tx = jax_build_optimizer(jcfg, spe)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = build_optimizer(cfg, tp.values())
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step, spe)
    for step in range(6):
        scale = 0.1 if step % 2 else 3.0  # clipped on even steps
        g = {k: (rs.randn(*v.shape) * scale).astype(np.float32) for k, v in init.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        set_lr(opt, schedule(step))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        torch.nn.utils.clip_grad_norm_(tp.values(), 1.0)
        opt.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


def _adam_run(opt, params, grads, schedule, steps):
    """``steps`` updates of ``opt`` on the given grads, under ``schedule``."""
    for step in steps:
        set_lr(opt, schedule(step))
        for p, g in zip(params, grads[step]):
            p.grad = None if g is None else g.clone()
        opt.step()


def _adam_case(dtype):
    """Three parameters and six steps of grads; the second parameter has
    no grad on step 2."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(shape, generator=gen, dtype=dtype) for shape in ((4, 3), (5,), (2, 2, 3))]
    grads = [[torch.randn(t.shape, generator=gen, dtype=dtype) * (3.0 if step % 2 else 0.1)
              for t in init] for step in range(6)]
    grads[2][1] = None
    return init, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_fused_adam_matches_single_tensor_update(name, dtype):
    """build_optimizer's Adam and AdamW take torch's fused update on the CPU
    and give the single-tensor update's parameters and moments over six
    steps of a StepLR decay; 1e-6 relative."""
    cfg = default_cfg(optimizer=name, lr=0.01, momentum=0.9, weight_decay=0.05,
                      lr_decay_alpha=0.5, lr_decay_step=1)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step, 2)
    init, grads = _adam_case(dtype)
    ours = [torch.nn.Parameter(t.clone()) for t in init]
    ref = [torch.nn.Parameter(t.clone()) for t in init]
    opt = build_optimizer(cfg, ours)
    assert type(opt) is {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}[name]
    assert opt.defaults["fused"] is True and opt.defaults["foreach"] is None
    assert opt.param_groups[0]["fused"] is True
    ref_opt = type(opt)(ref, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05,
                        foreach=False)
    _adam_run(opt, ours, grads, schedule, range(6))
    _adam_run(ref_opt, ref, grads, schedule, range(6))
    for p, q in zip(ours, ref):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-9)
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt.state[p][key], ref_opt.state[q][key],
                                       rtol=1e-6, atol=1e-12)
        assert float(opt.state[p]["step"]) == float(ref_opt.state[q]["step"])
    assert float(opt.state[ours[1]]["step"]) == 5


@pytest.mark.parametrize("name,cls", [("sgd", torch.optim.SGD), ("rmsprop", torch.optim.RMSprop)])
def test_sgd_and_rmsprop_keep_their_update(name, cls):
    opt = build_optimizer(default_cfg(optimizer=name), [torch.nn.Parameter(torch.zeros(3))])
    assert type(opt) is cls
    assert opt.defaults["foreach"] is None and not opt.defaults.get("fused")


@pytest.mark.parametrize("writer", ["foreach", "fused"])
def test_resume_across_update_paths(writer):
    """A state written after three AdamW steps by one update path and loaded
    into the other continues as the writer would have: the next three
    steps match the uninterrupted run. build_optimizer's AdamW keeps its
    fused path when it reads a foreach state; torch's foreach AdamW (what
    build_optimizer built on CUDA before the fused update) takes over the
    fused path of the state it reads."""
    cfg = default_cfg(optimizer="adamw", lr=0.01, momentum=0.9, weight_decay=0.05,
                      lr_decay_alpha=0.5, lr_decay_step=1)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step, 2)
    init, grads = _adam_case(torch.float32)

    def foreach_adamw(params):
        # What build_optimizer built on CUDA before the fused update (torch's default there).
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.05, foreach=True)

    def fused_adamw(params):
        return build_optimizer(cfg, params)

    write, read = ((foreach_adamw, fused_adamw) if writer == "foreach"
                   else (fused_adamw, foreach_adamw))
    whole = [torch.nn.Parameter(t.clone()) for t in init]
    _adam_run(write(whole), whole, grads, schedule, range(6))

    first = [torch.nn.Parameter(t.clone()) for t in init]
    opt = write(first)
    _adam_run(opt, first, grads, schedule, range(3))
    saved = opt.state_dict()
    assert saved["state"][0]["step"].device.type == "cpu"
    second = [torch.nn.Parameter(p.detach().clone()) for p in first]
    resumed = read(second)
    resumed.load_state_dict(saved)
    assert resumed.param_groups[0]["fused"] is True
    assert all(s["step"].dtype == torch.float32 for s in resumed.state.values())
    _adam_run(resumed, second, grads, schedule, range(3, 6))
    for p, q in zip(second, whole):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-9)


def test_step_lr_schedule():
    ours = step_lr_schedule(0.01, 0.9, 2, 3)
    ref = jax_schedule(0.01, 0.9, 2, 3)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.01)
    steplr = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.9)
    for epoch in range(10):
        for count in range(3 * epoch, 3 * epoch + 3):
            assert ours(count) == pytest.approx(float(ref(count)), rel=1e-12)
            assert ours(count) == pytest.approx(opt.param_groups[0]["lr"], rel=1e-12)
        opt.step()
        steplr.step()


class _Spy:
    """Stands in for the style augmentor and records what it returned."""

    def __init__(self, aug):
        self.aug = aug
        self.out = None

    def __call__(self, x, generator=None, z=None):
        self.out = self.aug(x, generator, z)
        return self.out


def test_styled_train_step_matches_jax():
    """One styled AdamW step of the port (krn_step) against the JAX pieces
    composed by hand: augment_batch, the style augmentor (Ghiasi on the same
    embedding normals), KRN train-mode apply, krn_loss, jax.grad, the optax
    chain. The aug draws are those JAX takes from its key.

    The restyled batch is compared in f32 (1e-4). The KRN update is then
    compared in float64 on both sides from that same batch: the port's model
    is .double() and the JAX model runs with dtype float64. (At random init
    the KRN gradients move by percents for a 1e-7 change of the input, so an
    f32 comparison could not separate a fault from rounding.) Loss and
    outputs stay f32 in both, as both models cast their outputs to f32."""
    B, S = 2, 64
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    keypts = rs.rand(B, 2, 11).astype(np.float32)
    aug_key, style_key = jax.random.split(jax.random.PRNGKey(7))

    stats = random_style_stats(3)
    torch.manual_seed(0)
    aug = StyleAugmentor(0.5, stats, device=torch.device("cpu"))
    ghiasi_params, _ = state_dict_to_flax(aug.ghiasi.state_dict())
    model = KeypointRegressionNet(11, (S, S)).double()
    params, bstats = state_dict_to_flax(model.state_dict())
    kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01)
    state = TrainState(model, build_optimizer(default_cfg(**kw), model.parameters()))

    # JAX: augs + restyle in f32.
    x = jnp.asarray(images).astype(jnp.float32) * (1.0 / 255.0)
    x, kp = augment_batch(aug_key, x, jnp.asarray(keypts))
    with jax.default_matmul_precision("float32"):
        styled = np.asarray(JaxStyleAugmentor(0.5, stats)(ghiasi_params, style_key, x))

    # Port step, with JAX's draws and embedding normals.
    spy = _Spy(aug)
    z = np.array(jax.random.normal(style_key, (B, 100), dtype=jnp.float32))
    sm = krn_step(state, torch.from_numpy(images), torch.from_numpy(keypts),
                  jax_draws(aug_key, B, S), False, spy, z=torch.from_numpy(z))
    assert state.step == 1
    np.testing.assert_allclose(spy.out.permute(0, 2, 3, 1).numpy(), styled, atol=1e-4)

    # JAX: the KRN step in float64 on the port's restyled batch.
    x64 = spy.out.permute(0, 2, 3, 1).double().numpy()
    with jax.enable_x64():
        jmodel = JaxKRN(11, dtype=jnp.float64)
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                          (params, bstats))
        tx = jax_build_optimizer(jax_default_cfg(**kw), 10)

        def loss_fn(p):
            (xc, yc), mut = jmodel.apply({"params": p, "batch_stats": s64},
                                         jnp.asarray(x64), train=True,
                                         mutable=["batch_stats"])
            loss, parts = jax_krn_loss(xc, yc, kp)
            return loss, (parts, mut["batch_stats"])

        @jax.jit
        def step(p):
            grads, (parts, new_bs) = jax.grad(loss_fn, has_aux=True)(p)
            upd, _ = tx.update(grads, tx.init(p), p)
            return optax.apply_updates(p, upd), new_bs, parts

        new_p, new_bs, parts = jax.device_get(step(p64))

    for k in ("loss_x", "loss_y"):
        np.testing.assert_allclose(sm[k].item(), float(parts[k]), rtol=1e-5)
    ours_p, ours_bs = state_dict_to_flax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_p))
    for k, v in jax.tree_util.tree_leaves_with_path(new_p):
        np.testing.assert_allclose(flat[k], v, atol=1e-7, err_msg=jax.tree_util.keystr(k))
    flat = dict(jax.tree_util.tree_leaves_with_path(ours_bs))
    for k, v in jax.tree_util.tree_leaves_with_path(new_bs):
        np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(k))


class _Loader:
    def __init__(self, n):
        self.n = n

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter({"image": np.zeros((2, 1, 1, 3), np.uint8)} for _ in range(self.n))


@pytest.mark.parametrize("epoch", [1, 2])
def test_style_gate_sequence_matches_jax(epoch):
    cfg = SimpleNamespace(model_name="krn", dann=False, seed=2021, texture_ratio=0.3)
    jax_seq, port_seq = [], []

    def jax_step(state, batch, rng, sp):
        jax_seq.append(sp is not None)
        return state, {"loss_x": 0.0, "loss_y": 0.0}

    def port_step(state, batch, styled):
        port_seq.append(styled)
        return {"loss_x": torch.tensor(0.0), "loss_y": torch.tensor(0.0)}

    jax_train_epoch(epoch, cfg, None, jax_step, _Loader(40), None, None,
                    style_params={"any": 1})
    records = train_epoch(epoch, cfg, None, port_step, _Loader(40), None, styled=True)
    assert port_seq == jax_seq and 0 < sum(port_seq) < 40
    assert [r["styled"] for r in records] == port_seq


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train"))
    generate_fake_speedplus(root, num_train=8, num_test=2, domains=("synthetic",))
    import preprocess

    preprocess.main(["--dataroot", root, "--domain", "synthetic", "--jsonfile",
                     "train.json", "--csvfile", "splits_krn/train.csv",
                     "--model_name", "krn"])
    return root


def test_loader_batches_match_jax(dataset):
    kw = dict(dataroot=dataset, input_shape=(32, 32), batch_size=3, seed=5)
    jds = JaxKRNDataset(jax_default_cfg(**kw))
    ours = DataLoader(KRNDataset(default_cfg(**kw)), 3, torch.device("cpu"),
                      num_workers=2, seed=5)
    ref = JaxDataLoader(jds, 3, shuffle=True, num_workers=2, seed=5)
    assert len(ours) == len(ref) == 2
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(ours)
        exp = list(ref)
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g["image"].numpy(), np.asarray(e["image"]))
            np.testing.assert_array_equal(g["keypts"].numpy(), np.asarray(e["keypts"]))


def test_train_cli_end_to_end(dataset, tmp_path):
    save, log = str(tmp_path / "save"), str(tmp_path / "log")
    common = ["--dataroot", dataset, "--savedir", save, "--logdir", log,
              "--input_shape", "32", "32", "--batch_size", "4", "--num_workers", "2",
              "--optimizer", "adamw", "--randomize_texture", "--texture_ratio", "0.5",
              "--no_cuda"]
    # cuDNN would run f32 convs in TF32; the trainer turns both switches off.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    records = train.main(common + ["--max_epochs", "1", "--start_over"])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert len(records) == 2 and all(np.isfinite(r["loss_x"]) for r in records)
    for f in ("checkpoint.pt", "model_best.pt", "config.txt"):
        assert os.path.exists(os.path.join(save, f))
    with open(os.path.join(log, "scalars.jsonl")) as f:
        assert {json.loads(line)["tag"] for line in f} == {"train/loss_x", "train/loss_y"}
    # auto-resume continues at epoch 2 from the saved step
    records = train.main(common + ["--max_epochs", "2"])
    assert [r["epoch"] for r in records] == [2, 2]
    ckpt = torch.load(os.path.join(save, "checkpoint.pt"), weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 4
    with pytest.raises(ValueError, match="mismatch"):
        train.main(common + ["--max_epochs", "3", "--optimizer", "sgd"])


# The adapt CLI's target stream is the synthetic train CSV: the dataset has
# no other domain.
RESUME_CLIS = {"train": (train, []),
               "adapt": (adapt, ["--perform_dann", "--test_domain", "synthetic",
                                 "--test_csv", "train.csv"])}


@pytest.mark.parametrize("cli", list(RESUME_CLIS))
def test_train_cli_resumes_a_foreach_adamw_checkpoint(dataset, tmp_path, monkeypatch, cli):
    """A checkpoint whose AdamW state torch's default update wrote (as every
    checkpoint before the fused update: foreach on CUDA, the single-tensor
    loop on the CPU) resumes through the train CLI (and the adapt CLI, on
    DANN's RevGrad) fused, with its moments and step count: its next step
    gives what the writer's own update gives. One step an epoch, since
    AdamW's sign-like steps on KRN's random init turn the two updates'
    last-bit differences into gaps of 1e-3 a step later."""
    module, flags = RESUME_CLIS[cli]
    common = ["--dataroot", dataset, "--input_shape", "32", "32", "--batch_size", "8",
              "--num_workers", "2", "--optimizer", "adamw", "--no_cuda"] + flags

    def run(name, epochs):
        save = str(tmp_path / name)
        module.main(common + ["--savedir", save, "--logdir", str(tmp_path / f"{name}_log"),
                              "--max_epochs", str(epochs)])
        return torch.load(os.path.join(save, "checkpoint.pt"), weights_only=True)

    def torch_default_adamw(cfg, params):  # build_optimizer's AdamW before the fused update
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(cfg.momentum, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)

    with monkeypatch.context() as m:
        m.setattr(state_module, "build_optimizer", torch_default_adamw)
        old = run("ours", 1)
        shutil.copytree(tmp_path / "ours", tmp_path / "ref")
        ref = run("ref", 2)
    assert old["step"] == 1 and old["opt_state"]["param_groups"][0]["fused"] is None
    assert old["opt_state"]["state"][0]["step"].device.type == "cpu"
    ours = run("ours", 2)
    assert ours["epoch"] == ref["epoch"] == 2 and ours["step"] == ref["step"] == 2
    assert ours["opt_state"]["param_groups"][0]["fused"] is True
    assert ref["opt_state"]["param_groups"][0]["fused"] is None
    for k, v in ref["variables"].items():
        torch.testing.assert_close(ours["variables"][k], v, rtol=1e-6, atol=1e-9, msg=k)
    for i, st in ref["opt_state"]["state"].items():
        assert float(ours["opt_state"]["state"][i]["step"]) == float(st["step"]) == 2
        torch.testing.assert_close(ours["opt_state"]["state"][i]["exp_avg"], st["exp_avg"],
                                   rtol=1e-6, atol=1e-12)


def test_profile_dir_traces_from_the_second_epoch(dataset, tmp_path):
    """--profile_dir, as the JAX trainer: a one-epoch run writes no trace; a
    two-epoch run writes a Chrome trace of its second epoch that holds the
    step's ops."""
    prof = tmp_path / "prof"
    common = ["--dataroot", dataset, "--input_shape", "32", "32", "--batch_size", "4",
              "--num_workers", "2", "--no_cuda", "--profile_dir", str(prof)]
    train.main(common + ["--savedir", str(tmp_path / "s1"), "--logdir", str(tmp_path / "l1"),
                         "--max_epochs", "1"])
    assert not prof.exists()
    records = train.main(common + ["--savedir", str(tmp_path / "s2"),
                                   "--logdir", str(tmp_path / "l2"), "--max_epochs", "2"])
    assert [r["epoch"] for r in records] == [1, 1, 2, 2]
    assert os.listdir(prof) == ["trace_epochs2-2.json"]
    with open(prof / "trace_epochs2-2.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::convolution", "aten::convolution_backward"} <= names
