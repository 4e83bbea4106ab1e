"""The measuring modules (``speedplusbaseline_tpu_torch/perf/``) and the
generator's ``f32_out`` against the JAX package, on the CPU.

* ``Ghiasi(bfloat16, f32_out=True)`` against the JAX module's, on the
  shipped weights and the same 32^2 input, in both lowerings. Tolerance:
  both run their convs in bf16 with their own rounding points, so each is
  about 1e-2 from the f32 generator; the two are held within 2^-6 (four
  bf16 ulps just under 1) at every pixel and 2e-3 on average.
* ``f32_out`` moves only the cast: the f32 output cast to bf16 equals the
  bf16 output bit for bit (the JAX package's
  ``test_models.py::test_f32_out_flag_only_moves_the_cast``).
* The styled train step with either flag gives the same loss and the same
  parameters bit for bit, in KRN and in SPN: the step returns the styled
  image to f32, the model's cast to its f32 parameters' dtype is a no-op,
  and its first op (KRN's stem conv, SPN's conv1) runs under the bf16
  autocast, which rounds the f32 image to bf16 exactly as the generator's
  own cast does. The f32 image itself does differ.
* ``bench_host_loader``'s JPEGs and boxes are the JAX script's byte for byte.
* Each module's JSON line holds the JAX script's keys and the port's, with
  finite positive rates, at a small size: the A/B arms at batch 2 (KRN at
  32^2; SPN at 67^2, the smallest side SPN's AlexNet trunk takes), the
  host loader at 16 images (its DataLoader's batch is 16 and drops a short
  batch, so fewer images count 0 img/s, in JAX too), bench_e2e's measure()
  at batch 4 and 64^2 over 8 frames.
* Without a GPU and without ``--no_cuda``, each module raises.
"""
import ast
import filecmp
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speedplusbaseline_tpu.ops.phase_conv  # noqa: F401 -- before any trace of the phase forward
from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi
from speedplusbaseline_tpu_torch.augment.styleaug import (StyleAugmentor, load_ghiasi_params,
                                                          random_style_stats)
from speedplusbaseline_tpu_torch.config import default_cfg
from speedplusbaseline_tpu_torch.convert import read_flax_msgpack
from speedplusbaseline_tpu_torch.engine.optim import build_optimizer
from speedplusbaseline_tpu_torch.engine.state import TrainState
from speedplusbaseline_tpu_torch.engine.steps import make_train_step
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
from speedplusbaseline_tpu_torch.models.build import get_model
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.perf import (ab_bf16_out, ab_spn_styled, bench_e2e,
                                              bench_host_loader)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL_BF16_MAX, TOL_BF16_MEAN = 2.0 ** -6, 2e-3
SIDE = {"krn": 32, "spn": 67}


def jax_script(name):
    """``scripts/<name>.py`` of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_json_keys(name):
    """The keys of the last ``json.dumps({...})`` of a dict literal in a JAX
    script."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    dicts = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps" and n.args
             and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dicts[-1].keys}


@pytest.fixture(scope="module")
def ghiasi_inputs():
    rs = np.random.RandomState(5)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    st = (rs.randn(2, 100) * 0.5).astype(np.float32)
    path = os.path.join(default_assets_dir(), "ghiasi_params.msgpack")
    return x, st, read_flax_msgpack(path), load_ghiasi_params(path)


def port_ghiasi(sd, x, st, phase_space, f32_out):
    g = Ghiasi(torch.bfloat16, phase_space, f32_out).eval()
    g.load_state_dict(sd)
    with torch.no_grad():
        return g(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(st))


@pytest.mark.parametrize("phase_space", [False, True], ids=["plain", "phase"])
def test_f32_out_matches_jax(ghiasi_inputs, phase_space):
    x, st, params, sd = ghiasi_inputs
    fn = jax.jit(lambda p, x, s: JaxGhiasi(dtype=jnp.bfloat16, tpu_opt=phase_space,
                                           f32_out=True).apply({"params": p}, x, s))
    ref = fn(params, jnp.asarray(x), jnp.asarray(st))
    out = port_ghiasi(sd, x, st, phase_space, True)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    diff = np.abs(out.permute(0, 2, 3, 1).numpy() - np.asarray(ref))
    assert diff.max() <= TOL_BF16_MAX and diff.mean() <= TOL_BF16_MEAN, (diff.max(), diff.mean())


@pytest.mark.parametrize("phase_space", [False, True], ids=["plain", "phase"])
def test_f32_out_moves_only_the_cast(ghiasi_inputs, phase_space):
    x, st, _, sd = ghiasi_inputs
    out_bf16 = port_ghiasi(sd, x, st, phase_space, False)
    out_f32 = port_ghiasi(sd, x, st, phase_space, True)
    assert out_bf16.dtype == torch.bfloat16 and out_f32.dtype == torch.float32
    assert torch.equal(out_f32.to(torch.bfloat16), out_bf16)
    assert not torch.equal(out_f32, out_bf16.float())


def styled_step(model_name, f32_out):
    """One styled train step (batch 2, bf16, AdamW) from seeded weights:
    (loss terms, parameters after it, the styled image)."""
    side = SIDE[model_name]
    cfg = default_cfg(model_name=model_name, batch_size=2, input_shape=(side, side),
                      optimizer="adamw", lr=1e-3, weight_decay=0.01, fp16=True)
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.rand(2, side, side, 3).astype(np.float32))}
    if model_name == "krn":
        batch["keypts"] = torch.from_numpy(rs.rand(2, 2, 11).astype(np.float32))
    else:
        for k in ("y_classes", "y_weights"):
            y = rs.rand(2, cfg.num_classes).astype(np.float32)
            batch[k] = torch.from_numpy(y / y.sum(1, keepdims=True))
    torch.manual_seed(0)
    model = get_model(cfg)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    torch.manual_seed(1)
    aug = StyleAugmentor(cfg.texture_alpha, random_style_stats(0), torch.bfloat16, CPU,
                         f32_out=f32_out)
    sm = make_train_step(cfg, CPU, aug)(state, batch, True)
    styled = aug(batch["image"].permute(0, 3, 1, 2), z=torch.zeros(2, 100))
    return sm, [p.detach().clone() for p in model.parameters()], styled


@pytest.mark.parametrize("model_name", ["krn", "spn"])
def test_styled_step_is_the_same_with_either_flag(model_name):
    sm_bf16, params_bf16, img_bf16 = styled_step(model_name, False)
    sm_f32, params_f32, img_f32 = styled_step(model_name, True)
    assert img_bf16.dtype == torch.bfloat16 and img_f32.dtype == torch.float32
    assert not torch.equal(img_f32, img_bf16.float())
    assert sm_bf16.keys() == sm_f32.keys()
    for k in sm_bf16:
        assert torch.equal(sm_bf16[k], sm_f32[k]), (k, sm_bf16[k], sm_f32[k])
    assert all(torch.equal(a, b) for a, b in zip(params_bf16, params_f32))


def test_host_loader_data_equals_jax(tmp_path):
    ref = jax_script("bench_host_loader")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = bench_host_loader.make_jpegs(str(tmp_path / "port"), 4)
    theirs = ref.make_jpegs(str(tmp_path / "jax"), 4)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    assert (bench_host_loader.rand_boxes(np.random.RandomState(3), 4)
            == ref.rand_boxes(np.random.RandomState(3), 4))


def positive(record, keys):
    for k in keys:
        v = record[k]
        assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, (k, v)


def test_host_loader_json(capsys):
    record = bench_host_loader.main(["16", "--no_cuda"])
    assert set(record) == jax_json_keys("bench_host_loader") | {"card"}
    assert record["card"] == "cpu"
    rates = ["python_img_s_per_worker", "cached_img_s_per_worker", "dataloader_img_s"]
    if record["native_img_s_per_worker"] is not None:
        rates.append("native_img_s_per_worker")
    positive(record, rates + ["host_cores"])
    assert capsys.readouterr().out.splitlines()[-1].startswith("{")


# bench_e2e's JAX keys (scripts/bench_e2e.py:135-143): its line is built up
# by assignment, so they are listed here.
E2E_JAX_KEYS = {"host_cores", "num_workers", "e2e_from_disk_img_s", "e2e_cached_img_s",
                "cache_build_s"}


def test_bench_e2e_json(tmp_path):
    record = bench_e2e.bench(8, 2, "both", str(tmp_path), CPU, batch=4, side=64)
    assert set(record) == E2E_JAX_KEYS | {"native", "card"}
    assert isinstance(record["native"], bool)
    positive(record, E2E_JAX_KEYS)
    # A second run finds the dataset and the cache and builds neither.
    again = bench_e2e.bench(8, 1, "cache", str(tmp_path), CPU, batch=4, side=64)
    assert set(again) == {"host_cores", "num_workers", "e2e_cached_img_s", "native", "card"}


@pytest.mark.parametrize("module,arm,model_name", [(ab_bf16_out, "krn_bf16", "krn"),
                                                   (ab_spn_styled, "phase", "spn")],
                         ids=["ab_bf16_out", "ab_spn_styled"])
def test_ab_arm_json(module, arm, model_name):
    name = module.__name__.rsplit(".", 1)[1]
    n = 3
    record = module.run_arm(arm, CPU, batch=2, side=SIDE[model_name], n=n)
    assert set(record) == jax_json_keys(name) | {"lowering", "batch", "input", "steps",
                                                 "device_busy_ms", "card"}
    assert record["arm"] == arm and record["lowering"] == ("phase" if arm == "phase" else "plain")
    assert record["steps"] == 5 + 2 + n and record["device_busy_ms"] is None
    positive(record, ["styled_step_ms"])


@pytest.mark.parametrize("module,argv", [
    (bench_host_loader, []), (bench_e2e, []), (ab_bf16_out, []),
    (ab_bf16_out, ["--arm", "krn_bf16"]), (ab_spn_styled, []),
    (ab_spn_styled, ["--arm", "plain"])],
    ids=["bench_host_loader", "bench_e2e", "ab_bf16_out", "ab_bf16_out-arm", "ab_spn_styled",
         "ab_spn_styled-arm"])
def test_raises_without_a_gpu(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
