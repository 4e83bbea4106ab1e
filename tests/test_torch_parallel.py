"""Data parallelism of the port (``parallel/mesh.py``) on the CPU, against
one process and against the JAX package's single-device step.

The JAX package's property (tests/test_parallel.py): a step over N devices
on a global batch B gives the parameters, BatchNorm statistics and losses of
the one-device step on the same B. Here two ranks over gloo, each with its
rows of a global batch of 8 at 64^2 in float64, take one step of the plain
and the styled KRN trainer, the SPN trainer with dropout and the DANN
trainer; each is held to the same step in one process: parameters,
optimizer state and BatchNorm running statistics within 1e-9 relative to
each tensor's scale, the losses within 1e-12 relative, and every rank's
parameters equal to rank 0's. The plain KRN and the DANN step on the
inputs and weights of tests/test_torch_train.py and tests/test_torch_dann.py
are held to JAX's single-device step within those files' float64
tolerances (JAX's own DP tests show its sharded step equals that step).
Then the train and test CLIs with ``--num_devices 2 --no_cuda`` against one
process, with an eval batch that two ranks do not divide.
"""
import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
from speedplusbaseline_tpu.engine.optim import build_optimizer as jax_build_optimizer
from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
from speedplusbaseline_tpu.engine.steps import make_dann_train_step as jax_make_dann_train_step
from speedplusbaseline_tpu.engine.steps import make_krn_train_step as jax_make_krn_train_step
from speedplusbaseline_tpu.models.krn import KeypointRegressionNet as JaxKRN
from speedplusbaseline_tpu.models.revgrad import RevGrad as JaxRevGrad
from speedplusbaseline_tpu_torch import preprocess as preprocess_cli
from speedplusbaseline_tpu_torch import test as test_cli
from speedplusbaseline_tpu_torch import train
from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor, random_style_stats
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import state_dict_to_flax
from speedplusbaseline_tpu_torch.data import generate_fake_speedplus
from speedplusbaseline_tpu_torch.data.loader import DataLoader
from speedplusbaseline_tpu_torch.models import get_model
from speedplusbaseline_tpu_torch.parallel import make_mesh, spawn
from test_torch_augment import jax_draws
from test_torch_eval import DUMPS, N_TEST, read_dumps
import test_torch_parallel_ranks as ranks

torch.set_num_threads(1)

WORLD, B, S = 2, 8, 64
SPN_S, SPN_CLASSES = 99, 50
KEY = 137  # only rotations and flips fire in either stream of step 0 (test_torch_dann.py)
ADAMW = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01)
CLI_S, CLI_B = 64, 16  # the JAX package's DP test's KRN shape and global batch


# ---------------------------------------------------------------- make_mesh


@pytest.mark.parametrize("num_devices,batch,device_type,cuda_count,n", [
    (0, 48, "cpu", 0, 1),      # all local devices on the CPU: one process
    (2, 48, "cpu", 0, 2),      # an explicit N on the CPU: N gloo processes
    (0, 48, "cuda", 8, 8),     # all local CUDA devices
    (16, 48, "cuda", 8, 8),    # capped at the devices present
    (0, 48, "cuda", 0, 1),
])
def test_mesh_counts(monkeypatch, num_devices, batch, device_type, cuda_count, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cuda_count)
    assert make_mesh(num_devices, batch, device_type) == n


def test_mesh_clamp_warns_loudly(monkeypatch):
    """Batch 50 on 8 devices: the largest divisor is 5 and 3 devices would
    idle, so the clamp warns with the JAX package's text."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.warns(RuntimeWarning, match="IDLING"):
        assert make_mesh(batch_size=50) == 5
    with pytest.warns(RuntimeWarning, match="IDLING"):
        assert make_mesh(8, 50, "cpu") == 5


def test_mesh_exact_divisor_does_not_warn(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_mesh(batch_size=48) == 8
        assert make_mesh(6, 48, "cpu") == 6


# ------------------------------------------------------------------- loader


class _Stub:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        return {"image": np.full((2, 2, 3), i, np.float32), "idx": np.asarray(i, np.int64)}


def _rank_loaders(n, batch, world, **kw):
    return [DataLoader(_Stub(n), batch, torch.device("cpu"), num_workers=2, rank=r,
                       world=world, **kw) for r in range(world)]


def test_eval_batch_not_divisible_by_ranks():
    """Ranks 0..5 of 6, an eval batch of 32 over 70 rows: every batch is
    padded to 36 rows, 6 a rank, and the valid rows joined over the ranks
    are every row once, in CSV order (the JAX package's
    TestEvalMeshDivisibility, with no processes)."""
    loaders = _rank_loaders(70, 32, 6, shuffle=False, drop_last=False)
    assert all(len(loader) == 3 for loader in loaders)
    batches = [list(loader) for loader in loaders]
    seen = []
    for b in range(3):
        rows = [batches[r][b] for r in range(6)]
        assert [x["image"].shape[0] for x in rows] == [6] * 6
        for x in rows:
            seen += x["idx"][x["valid"] > 0.5].tolist()
    assert seen == list(range(70))


def test_full_divisible_batches_unpadded():
    loaders = _rank_loaders(48, 16, 8, shuffle=False, drop_last=False)
    for rows in zip(*(list(loader) for loader in loaders)):
        assert [x["image"].shape[0] for x in rows] == [2] * 8
        assert all(float(x["valid"].sum()) == 2 for x in rows)


def test_train_rows_join_to_the_one_process_batches():
    """Shuffled training batches: each rank loads its contiguous rows of the
    one-process batch (the same Philox order); no padding, no valid key."""
    one = DataLoader(_Stub(10), 4, torch.device("cpu"), num_workers=2, seed=3)
    loaders = _rank_loaders(10, 4, WORLD, seed=3)
    for epoch in (1, 2):
        for loader in (one, *loaders):
            loader.set_epoch(epoch)
        ref = list(one)
        got = [list(loader) for loader in loaders]
        assert len(ref) == 2 and all(len(g) == 2 for g in got)
        for b, batch in enumerate(ref):
            assert "valid" not in batch and all("valid" not in g[b] for g in got)
            joined = torch.cat([g[b]["idx"] for g in got])
            assert torch.equal(joined, batch["idx"])


# -------------------------------------------------------------------- steps


def _state(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _batch(rs, n, side=S, labels=True):
    out = {"image": rs.randint(0, 256, (n, side, side, 3)).astype(np.uint8)}
    if labels:
        out["keypts"] = rs.rand(n, 2, 11).astype(np.float32)
    return out


def _spawn(cases):
    """The two ranks' results of ``cases``, as a future: the ranks run while
    this process computes its references."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, ranks.run, (cases,), WORLD, "gloo")
    pool.shutdown(wait=False)
    return future


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale, err_msg=what)


def _assert_same_step(one, two, init):
    """Two ranks against one process: parameters, BatchNorm statistics and
    optimizer state within 1e-9 of each tensor's scale, losses within 1e-12
    relative, every rank equal to rank 0; and the step moved the parameters
    and every running variance."""
    assert two["spread"] == 0.0
    assert set(one["state"]) == set(two["state"]) == set(init)
    for k, v in one["state"].items():
        _close(two["state"][k], v, 1e-9, k)
    moved = {k for k, v in one["state"].items() if not np.array_equal(v, init[k])}
    assert moved and all(k in moved for k in init if k.endswith("running_var"))
    assert len(one["opt"]) == len(two["opt"]) > 0
    for i, (a, b) in enumerate(zip(one["opt"], two["opt"])):
        assert set(a) == set(b)
        for k in a:
            _close(b[k], a[k], 1e-9, f"optimizer state {i} {k}")
    assert set(one["losses"]) == set(two["losses"])
    for k, v in one["losses"].items():
        assert two["losses"][k] == pytest.approx(v, rel=1e-12, abs=0), k


def _flax_tree(state):
    return state_dict_to_flax({k: torch.from_numpy(v) for k, v in state.items()})


def _jax_step(make, model, init, batches, alpha=None, dann=False):
    """JAX's single-device train step (float64, AdamW) from ``init`` on
    ``batches`` with PRNGKey(KEY): (new params, new batch_stats, losses)."""
    params, stats = _flax_tree(init)
    with jax.enable_x64():
        tx = jax_build_optimizer(jax_default_cfg(dann=dann, **ADAMW), 10)
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64,
                               opt_state=tx.init(p64))
        step = make(model, tx, None)
        args = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
        extra = (None,) if alpha is None else (jnp.float32(alpha),)
        new_state, aux = jax.device_get(step(jstate, *args, jax.random.PRNGKey(KEY), *extra))
    return new_state.params, new_state.batch_stats, aux


def _assert_matches_jax(ours, ref):
    """tests/test_torch_train.py's and tests/test_torch_dann.py's float64
    tolerances: losses 1e-5 relative, parameters 1e-7, running statistics
    1e-6 relative."""
    new_params, new_bstats, aux = ref
    for k, v in aux.items():
        np.testing.assert_allclose(ours["losses"][k], float(v), rtol=1e-5, err_msg=k)
    p, bs = _flax_tree(ours["state"])
    flat = dict(jax.tree_util.tree_leaves_with_path(p))
    leaves = jax.tree_util.tree_leaves_with_path(new_params)
    assert len(flat) == len(leaves)
    for k, v in leaves:
        np.testing.assert_allclose(flat[k], v, atol=1e-7, err_msg=jax.tree_util.keystr(k))
    flat = dict(jax.tree_util.tree_leaves_with_path(bs))
    for k, v in jax.tree_util.tree_leaves_with_path(new_bstats):
        np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(k))


def _exact_draws(key, n):
    """JAX's aug draws of ``n`` rows from ``key``, checked to fire only the
    exact augs (rotations and flips)."""
    with jax.enable_x64():
        draws = {k: v.numpy() for k, v in jax_draws(key, n, S).items()}
    assert not (draws["bc_on"].any() or draws["noise_on"].any())
    assert (draws["rot_on"] | draws["flip_on"]).any()
    return draws


@pytest.fixture(scope="module")
def krn_runs():
    """The plain and the styled KRN trainer step on a global batch of 8
    (AdamW, float64), and krn_step on JAX's draws with the inputs and
    weights of tests/test_torch_train.py (batch 2: one row a rank), with
    JAX's step on the latter."""
    rs = np.random.RandomState(1)
    cfg = dict(model_name="krn", input_shape=(S, S), batch_size=B, **ADAMW)
    torch.manual_seed(1)
    init = _state(get_model(default_cfg(**cfg)))
    stats = random_style_stats(3)
    torch.manual_seed(2)
    ghiasi = _state(StyleAugmentor(0.5, stats, device=torch.device("cpu")).ghiasi)
    batch = _batch(rs, B)
    cases = [dict(kind="krn", cfg=cfg, seed=1, batch=batch),
             dict(kind="krn", cfg=cfg, seed=1, batch=batch, style=(stats, ghiasi))]

    # tests/test_torch_train.py::test_styled_train_step_matches_jax's inputs
    # (its pixels as float64: JAX's augs under x64 take no uint8) and
    # weights, with JAX's aug draws of KEY.
    rs = np.random.RandomState(0)
    jb = {"image": rs.randint(0, 256, (2, S, S, 3)) / 255.0,
          "keypts": rs.rand(2, 2, 11).astype(np.float32)}
    torch.manual_seed(0)
    StyleAugmentor(0.5, random_style_stats(3), device=torch.device("cpu"))
    jinit = _state(get_model(default_cfg(model_name="krn", input_shape=(S, S))))
    aug_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), 0))[0]
    cases.append(dict(kind="krn_draws", cfg=dict(cfg, batch_size=2), state=jinit, batch=jb,
                      draws=_exact_draws(aug_key, 2)))
    two = _spawn(cases)
    ref = _jax_step(jax_make_krn_train_step, JaxKRN(11, dtype=jnp.float64), jinit, [jb])
    two = two.result()
    cases[1]["replay"] = two[1]["styled"]
    return init, jinit, ref, ranks.run(cases), two


def test_krn_plain_step_matches_one_process(krn_runs):
    init, _, _, one, two = krn_runs
    _assert_same_step(one[0], two[0], init)


def test_krn_styled_step_matches_one_process(krn_runs):
    """The restyle's embedding normals are drawn for the global batch, and
    the generator (B1 and B2 by their plain versions on the CPU) restyles
    each rank's rows: as one process restyles them within f32 rounding (its
    FiLM matmuls round by the row count). The step from the ranks' restyle
    is one process's step from the same restyle within 1e-9."""
    init, _, _, one, two = krn_runs
    np.testing.assert_allclose(two[1]["styled"], one[1]["styled"], rtol=0, atol=1e-5)
    _assert_same_step(one[1], two[1], init)
    assert one[1]["losses"] != one[0]["losses"]


def test_krn_plain_step_matches_jax(krn_runs):
    """Two ranks, one row each, against JAX's make_krn_train_step on one
    device (float64 model, AdamW) on the same batch and key."""
    _, jinit, ref, one, two = krn_runs
    _assert_matches_jax(two[2], ref)
    _assert_same_step(one[2], two[2], jinit)


def test_spn_step_with_dropout_matches_one_process():
    """SPN at 99^2 (its smallest pool5 of 2x2), 50 classes, dropout 0.5 with
    the masks of the global batch: two ranks against one process."""
    rs = np.random.RandomState(2)
    cfg = dict(model_name="spn", input_shape=(SPN_S, SPN_S), num_classes=SPN_CLASSES,
               batch_size=B, **ADAMW)
    y = np.zeros((B, SPN_CLASSES), np.float32)
    y[np.arange(B)[:, None], rs.randint(0, SPN_CLASSES, (B, 5))] = 0.2
    batch = {"image": rs.randint(0, 256, (B, SPN_S, SPN_S, 3)).astype(np.uint8),
             "y_classes": y, "y_weights": rs.dirichlet(np.ones(SPN_CLASSES), B).astype(np.float32)}
    case = dict(kind="spn", cfg=cfg, seed=3, batch=batch)
    two = _spawn([case])
    one = ranks.run([case])
    torch.manual_seed(3)
    _assert_same_step(one[0], two.result()[0], _state(get_model(default_cfg(**cfg))))


@pytest.fixture(scope="module")
def dann_runs():
    """The DANN trainer step on 8 + 8 (AdamW, float64), and dann_step on
    JAX's draws with tests/test_torch_dann.py's inputs and weights, with
    JAX's step on the latter."""
    rs = np.random.RandomState(3)
    cfg = dict(model_name="krn", dann=True, input_shape=(S, S), batch_size=B, **ADAMW)
    torch.manual_seed(4)
    init = _state(get_model(default_cfg(**cfg)))
    cases = [dict(kind="dann", cfg=cfg, seed=4, source=_batch(rs, B),
                  target=_batch(rs, B, labels=False), alpha=np.float32(0.37))]

    # tests/test_torch_dann.py's revgrad fixture and step inputs.
    torch.manual_seed(0)
    model = get_model(default_cfg(**cfg))
    rs = np.random.RandomState(0)
    for _, buf in model.named_buffers():
        buf.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    jinit = _state(model)
    rs = np.random.RandomState(4)
    src, tgt = rs.rand(2, S, S, 3), rs.rand(2, S, S, 3)
    keypts = rs.rand(2, 2, 11).astype(np.float32)
    src_key, tgt_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), 0))
    source, target = {"image": src, "keypts": keypts}, {"image": tgt}
    cases.append(dict(kind="dann_draws", cfg=dict(cfg, batch_size=2), state=jinit,
                      source=source, target=target, src_draws=_exact_draws(src_key, 2),
                      tgt_draws=_exact_draws(tgt_key, 2), alpha=np.float32(0.37)))
    two = _spawn(cases)
    ref = _jax_step(jax_make_dann_train_step, JaxRevGrad(11, dtype=jnp.float64), jinit,
                    [source, target], alpha=0.37, dann=True)
    return init, jinit, ref, ranks.run(cases), two.result()


def test_dann_step_matches_one_process(dann_runs):
    """Both streams' draws of the global batches, BatchNorm over the global
    source then target batch (JAX's bs1 -> bs2), the three losses global."""
    init, _, _, one, two = dann_runs
    _assert_same_step(one[0], two[0], init)


def test_dann_step_matches_jax(dann_runs):
    """Two ranks, one row of each stream each, against JAX's
    make_dann_train_step on one device (float64, AdamW, alpha 0.37)."""
    _, jinit, ref, one, two = dann_runs
    _assert_matches_jax(two[1], ref)
    _assert_same_step(one[1], two[1], jinit)


# --------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A fake dataset made and labelled by the port: 8 train rows and
    N_TEST = 6 test rows."""
    root = str(tmp_path_factory.mktemp("torch_parallel"))
    generate_fake_speedplus(root, num_train=CLI_B, num_test=N_TEST, device=torch.device("cpu"))
    for domain, jsonfile, csv in (("synthetic", "train.json", "splits_krn/train.csv"),
                                  ("lightbox", "test.json", "splits_krn/lightbox.csv")):
        preprocess_cli.main(["--dataroot", root, "--domain", domain, "--jsonfile", jsonfile,
                             "--csvfile", csv, "--no_cuda"])
    return root


def _dump_text(logdir):
    out = {}
    for name in DUMPS:
        with open(os.path.join(logdir, name)) as f:
            out[name] = f.read()
    return out


def test_train_and_test_clis_over_two_ranks(data, tmp_path):
    """``--num_devices 2 --no_cuda``: one epoch (one step) of the JAX
    package's DP test (KRN at 64^2, a global batch of 16, SGD at lr 1e-2),
    validated with an eval batch of 3, which two ranks do not divide.
    Exactly one model_best.pt, within that test's 1e-4 (f32) of the
    one-process run's: the f32 random-init KRN gradient follows the last
    bits of its reductions (one rank's half-batch sums, the global
    statistics' E[x^2] - E[x]^2), and this step moves the stem by up to
    5e-5. Its validation dumps are, in CSV order, the ones the test CLI
    writes for that checkpoint in one process and over two ranks."""
    def args(tag, n, **extra):
        out = ["--dataroot", data, "--savedir", str(tmp_path / f"save{tag}"),
               "--logdir", str(tmp_path / f"log{tag}"), "--input_shape", str(CLI_S), str(CLI_S),
               "--batch_size", str(CLI_B), "--max_epochs", "1", "--num_workers", "2",
               "--optimizer", "sgd", "--lr", "0.01", "--momentum", "0",
               "--weight_decay", "0", "--test_epoch", "1",
               "--resultfn", "results.txt", "--num_devices", str(n), "--no_cuda"]
        for k, v in extra.items():
            out += [f"--{k}", str(v)]
        return out

    one = train.main(args(1, 1, eval_batch_size=3))
    two = train.main(args(2, 2, eval_batch_size=3))
    assert len(one) == len(two) == 1
    saved = sorted(os.listdir(tmp_path / "save2"))
    assert saved == ["checkpoint.pt", "config.txt", "model_best.pt"]
    best = [torch.load(tmp_path / f"save{t}" / "model_best.pt", weights_only=True)
            for t in (1, 2)]
    assert set(best[0]) == set(best[1])
    for k, v in best[0].items():
        _close(best[1][k], v, 1e-4, k)

    train_dumps = _dump_text(tmp_path / "log2")
    assert all(len(v.split()) == N_TEST for v in train_dumps.values())
    for n, ebs in ((1, 3), (2, 3)):
        logdir = tmp_path / f"eval{n}_{ebs}"
        test_cli.main(["--dataroot", data, "--logdir", str(logdir), "--resultfn",
                       "results.txt", "--input_shape", str(CLI_S), str(CLI_S), "--eval_batch_size",
                       str(ebs), "--num_workers", "2", "--num_devices", str(n),
                       "--pretrained", str(tmp_path / "save2" / "model_best.pt"), "--no_cuda"])
        assert _dump_text(logdir) == train_dumps, (n, ebs)
    assert os.path.exists(tmp_path / "eval2_3" / "results.txt")
    np.testing.assert_array_equal(read_dumps(tmp_path / "eval2_3")["err_q.txt"].shape, (N_TEST,))
