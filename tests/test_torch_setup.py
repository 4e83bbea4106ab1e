"""The one home of each decision of a run's set-up: the precision policy
(``config.full_f32``), the model with its optimizer (``TrainState.for_config``),
the trainer's style augmentor (``styleaug.style_augmentor``) and the end of a
train or adapt epoch (``engine/run.py``)."""
import ast
import os

import pytest
import torch

from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params, style_augmentor
from speedplusbaseline_tpu_torch.config import default_cfg, full_f32
from speedplusbaseline_tpu_torch.engine.run import end_epoch, resume
from speedplusbaseline_tpu_torch.engine.state import TrainState
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "speedplusbaseline_tpu_torch")

# Each entry point of the port and chip_smoke, with the functions of it that
# set the precision policy: through full_f32 or open_run, which calls it.
ENTRY_POINTS = {
    "train.py": ("_train",),
    "adapt.py": ("_adapt",),
    "test.py": ("_test",),
    "embedding.py": ("main",),
    "profile_step.py": ("main",),
    "train_toy_ghiasi.py": ("main",),
    "perf/common.py": ("device",),
    "quality/spn_seed_sweep.py": ("live_run",),
    "quality/probe_spn_memorize.py": ("main",),
    "../chip_smoke.py": ("ddp_ranks", "ddp_nccl_rank", "main"),
}


def _tree(rel):
    with open(os.path.join(PORT, rel)) as f:
        return ast.parse(f.read())


def _functions(tree):
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}


def _called(node):
    """The names called anywhere inside ``node`` (``f()`` and ``m.f()``)."""
    return {c.func.id if isinstance(c.func, ast.Name) else c.func.attr
            for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, (ast.Name, ast.Attribute))}


def test_only_full_f32_sets_tf32():
    """No module of the port, and no line of chip_smoke, assigns
    ``allow_tf32`` but config.full_f32, which turns both switches off."""
    rels = [os.path.relpath(os.path.join(d, f), PORT) for d, _, fs in os.walk(PORT)
            for f in fs if f.endswith(".py")] + ["../chip_smoke.py"]
    sites = set()
    for rel in rels:
        tree = _tree(rel)
        owner = {}  # node -> its innermost function (ast.walk gives outer ones first)
        for fn in _functions(tree).values():
            for n in ast.walk(fn):
                owner[id(n)] = fn.name
        for node in ast.walk(tree):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                       else [])
            if any(isinstance(t, ast.Attribute) and t.attr == "allow_tf32" for t in targets):
                sites.add((rel, owner.get(id(node), "<module>")))
    assert sites == {("config.py", "full_f32")}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    full_f32()
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("rel", list(ENTRY_POINTS))
def test_entry_point_calls_full_f32(rel):
    """Each entry point that set the two switches itself now calls
    full_f32, or open_run, whose prologue calls it."""
    fns = _functions(_tree(rel))
    for name in ENTRY_POINTS[rel]:
        called = _called(fns[name])
        assert called & {"full_f32", "open_run"}, (rel, name)
        if "open_run" in called:
            assert "full_f32" in _called(_functions(_tree("engine/run.py"))["open_run"])


@pytest.mark.parametrize("model_name", ["krn", "spn"])
def test_for_config_places_the_model_and_its_optimizer(model_name):
    """``TrainState.for_config``: the config's model, its 4-D weights
    channels_last on the device, and the config's optimizer over exactly
    the model's parameters, in order."""
    cfg = default_cfg(model_name=model_name, input_shape=(67, 67), num_classes=10,
                      optimizer="adamw")
    state = TrainState.for_config(cfg, torch.device("cpu"))
    params = list(state.model.parameters())
    convs = [p for p in params if p.dim() == 4]
    assert convs and all(p.is_contiguous(memory_format=torch.channels_last) for p in convs)
    assert not all(p.is_contiguous() for p in convs)
    assert isinstance(state.optimizer, torch.optim.AdamW) and state.step == 0
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert len(held) == len(params) and all(a is b for a, b in zip(held, params))


@pytest.mark.parametrize("fp16", [False, True])
def test_style_augmentor_follows_the_config(fp16):
    """The trainer's style augmentor: alpha ``--texture_alpha``, a bf16
    generator under ``--use_fp16`` (f32 weights, as the flax module's), the
    shipped generator weights."""
    cfg = default_cfg(fp16=fp16, texture_alpha=0.25)
    aug = style_augmentor(cfg, torch.device("cpu"))
    assert aug.alpha == 0.25 and not aug.ghiasi.phase_space
    want = load_ghiasi_params(os.path.join(default_assets_dir(), "ghiasi_params.msgpack"))
    for k, v in aug.ghiasi.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    assert aug.ghiasi.dtype == (torch.bfloat16 if fp16 else torch.float32)


def test_end_epoch_keeps_the_cadence_and_resume_reads_it(tmp_path):
    """A checkpoint every ``--save_epoch`` epochs and at the last, "best"
    the latest; the resume restores the last one written."""
    cfg = default_cfg(savedir=str(tmp_path), save_epoch=2, max_epochs=3, optimizer="sgd",
                      input_shape=(32, 32))
    dev = torch.device("cpu")
    state = TrainState.for_config(cfg, dev)
    assert resume(cfg, state, dev) == (0, 0)
    best, written, ckpt = 0, [], tmp_path / "checkpoint.pt"
    for epoch in (1, 2, 3):
        state.step = 10 * epoch
        best = end_epoch(cfg, state, epoch, best, dev)
        written.append(ckpt.exists() and torch.load(ckpt, weights_only=True)["epoch"])
    assert best == 3 and written == [False, 2, 3]
    assert (tmp_path / "model_best.pt").exists()
    again = TrainState.for_config(cfg, dev)
    assert resume(cfg, again, dev) == (3, 3) and again.step == 30
    assert resume(default_cfg(savedir=str(tmp_path), auto_resume=False), again, dev) == (0, 0)
