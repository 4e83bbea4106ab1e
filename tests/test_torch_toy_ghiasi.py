"""The trainable Ghiasi generator and the toy-Ghiasi trainer
(``speedplusbaseline_tpu_torch/train_toy_ghiasi.py``) against the JAX
package and ``scripts/train_toy_ghiasi.py``, on the CPU at batch 2, 32^2, the
JAX side under ``default_matmul_precision("float32")``; then the shipped
style asset's behaviour through the port (``tests/test_styleaug_quality.py``'s
four checks).

* Gradients: every parameter of the port's ``Ghiasi`` against ``jax.grad`` of
  the same MSE loss, weights carried across by ``convert.py``, in both
  lowerings (``Ghiasi()`` / ``Ghiasi()`` and ``phase_space=True`` /
  ``tpu_opt=True``, the latter also at 32x31), within 5e-5 of the largest
  gradient of the parameter's layer (``layerN``): the conv biases and each
  block's ``fc_beta2`` feed only spatial constants into an instance norm,
  so their true gradient is 0 and both sides return rounding noise.
* Each kernel wrapper's gradient, in each argument alone, is the plain
  version's (on the CPU the forward is the plain version: bit for bit).
* ``style_targets`` against the script's own, ``make_batch`` against the
  script's ``sample_batch`` formula (written out below: it is a closure in
  ``main``) on the same draws, within 1e-6 / 1e-5.
* Three Adam steps from the same weights on the same batches in float64
  (the JAX module's float32 casts read as float64, see ``jax_float64``):
  parameters within 1e-10, after moving up to 6e-3.
* A file the port's CLI writes is read by flax's ``serialization.from_bytes``
  into ``Ghiasi().init``'s tree; the two generators then agree within 1e-4
  of scale.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

import speedplusbaseline_tpu.models.ghiasi as jax_ghiasi
import speedplusbaseline_tpu.ops.instancenorm as jax_instancenorm
# Imported here, outside any trace: the module makes its constants at import,
# and the phase forward would otherwise first import it inside a jit.
import speedplusbaseline_tpu.ops.phase_conv  # noqa: F401
from scripts.train_toy_ghiasi import style_targets as jax_style_targets
from speedplusbaseline_tpu_torch import train_toy_ghiasi as toy
from speedplusbaseline_tpu_torch.augment.styleaug import (StyleAugmentor, load_ghiasi_params,
                                                          load_style_stats, random_style_stats)
from speedplusbaseline_tpu_torch.convert import (flax_to_state_dict, read_flax_msgpack,
                                                 state_dict_to_flax)
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
from speedplusbaseline_tpu_torch.ops import (ghiasi_resblock, ghiasi_resblock_plain,
                                             instance_norm_film, instance_norm_film_plain)

torch.set_num_threads(1)

ASSET = os.path.join(default_assets_dir(), "ghiasi_params.msgpack")
TOL_GRAD = 5e-5  # of the largest gradient of the parameter's layer
TOL_ADAM = 1e-10  # absolute, float64


def seeded_ghiasi(seed: int = 3, **kw) -> Ghiasi:
    torch.manual_seed(seed)
    return Ghiasi(**kw)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


# ------------------------------------------------------------- gradients


@pytest.mark.parametrize("phase_space,hw", [(False, (32, 32)), (True, (32, 32)),
                                            (True, (32, 31))])
def test_every_gradient_matches_jax(phase_space, hw):
    net = seeded_ghiasi(phase_space=phase_space)
    params = state_dict_to_flax(net.state_dict())[0]
    rs = np.random.RandomState(4)
    x = rs.rand(2, *hw, 3).astype(np.float32)
    z = (rs.randn(2, 100) * 0.5).astype(np.float32)
    y = rs.rand(2, 4 * -(-hw[0] // 4), 4 * -(-hw[1] // 4), 3).astype(np.float32)

    model = jax_ghiasi.Ghiasi(tpu_opt=phase_space)
    loss = lambda p: jnp.mean((model.apply({"params": p}, x, z) - y) ** 2)  # noqa: E731
    with jax.default_matmul_precision("float32"):
        grads = jax.jit(jax.grad(loss))(params)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))

    out = net(nchw(x), torch.from_numpy(z)).permute(0, 2, 3, 1)
    (out - torch.from_numpy(y)).square().mean().backward()
    named = dict(net.named_parameters())
    assert set(named) == set(ref)
    missing = sorted(n for n, p in named.items() if p.grad is None)
    assert not missing, f"no gradient reached {missing}"
    for name, p in named.items():
        layer = name.split(".")[0]
        scale = max(np.abs(g.numpy()).max() for k, g in ref.items() if k.split(".")[0] == layer)
        err = np.abs(p.grad.numpy() - ref[name].numpy()).max()
        assert err <= TOL_GRAD * scale, (name, err, scale)


B1_ARGS = ("x", "w1", "b1", "w2", "b2", "gamma1", "beta1", "gamma2", "beta2")


def b1_inputs(rs, dtype=torch.float32):
    B, H, W, C = 2, 6, 5, 8
    shapes = {"x": (B, H, W, C), "w1": (3, 3, C, C), "w2": (3, 3, C, C), "b1": (C,),
              "b2": (C,)}
    return [torch.from_numpy(rs.randn(*shapes.get(n, (B, C))).astype(np.float32) * 0.3)
            .to(dtype if n == "x" else torch.float32) for n in B1_ARGS]


@pytest.mark.parametrize("wrt", B1_ARGS)
def test_resblock_wrapper_gradient_is_the_plain_vjp(wrt):
    """Any one argument that requires grad gets the plain block's gradient
    through the wrapper (``ops/_vjp.py::PlainVJP``), and only it."""
    rs = np.random.RandomState(9)
    args = b1_inputs(rs)
    args[B1_ARGS.index(wrt)].requires_grad_()
    out = ghiasi_resblock(*args)
    assert out.grad_fn is not None
    cot = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    (got,) = torch.autograd.grad(out, args[B1_ARGS.index(wrt)], cot)
    (ref,) = torch.autograd.grad(ghiasi_resblock_plain(*args), args[B1_ARGS.index(wrt)], cot)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_instance_norm_wrapper_gradient_is_the_plain_vjp(film, relu):
    rs = np.random.RandomState(10)
    x = torch.from_numpy(rs.randn(2, 5, 7, 6).astype(np.float32)).requires_grad_()
    gb = [torch.from_numpy(rs.randn(2, 6).astype(np.float32)).requires_grad_() if film
          else None for _ in range(2)]
    out = instance_norm_film(x, *gb, relu=relu)
    assert out.grad_fn is not None
    cot = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    wrt = [x] + [t for t in gb if t is not None]
    got = torch.autograd.grad(out, wrt, cot)
    ref = torch.autograd.grad(instance_norm_film_plain(x, *gb, relu=relu), wrt, cot)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_frozen_generator_keeps_no_graph():
    """Frozen (the style augmentor's generator) or under no_grad, nothing is
    recorded; an input that requires grad gets its gradient through both
    kernels' VJPs."""
    net = seeded_ghiasi().requires_grad_(False)
    x = torch.rand(2, 3, 16, 16)
    z = torch.randn(2, 100)
    assert net(x, z).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert net(x, z).grad_fn is None
    net(x, z).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


# ---------------------------------------------------- the trainer's pieces


def test_style_targets_match_the_script():
    rs = np.random.RandomState(5)
    x = rs.rand(3, 16, 12, 3).astype(np.float32)
    emb = rs.randn(3, 100).astype(np.float32)
    ref = np.asarray(jax_style_targets(jnp.asarray(x), jnp.asarray(emb)))
    got = toy.style_targets(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.1


def jax_sample_batch(freq, phase, noise):
    """scripts/train_toy_ghiasi.py:97-108 on given draws (its uniforms and
    normals, passed in rather than drawn from a key)."""
    S = noise.shape[1]
    xy = jnp.stack(jnp.meshgrid(jnp.arange(S), jnp.arange(S)), -1) / S
    img = 0.5 + 0.35 * jnp.sin(
        2 * np.pi * (xy[None, :, :, :, None] * freq).sum(3) + phase[..., 0, :])
    img = img + 0.08 * noise
    return jnp.clip(img, 0.0, 1.0)


def test_make_batch_matches_the_script_formula():
    g = torch.Generator().manual_seed(6)
    draws = toy.draw_batch(g, 4, 24)
    assert draws["freq"].shape == (4, 1, 1, 2, 3) and draws["phase"].shape == (4, 1, 1, 1, 3)
    assert draws["noise"].shape == (4, 24, 24, 3) and draws["z"].shape == (4, 100)
    assert 2.0 <= draws["freq"].min() and draws["freq"].max() < 9.0
    assert 0.0 <= draws["phase"].min() and draws["phase"].max() < np.pi
    ref = np.asarray(jax_sample_batch(*(jnp.asarray(draws[k].numpy())
                                        for k in ("freq", "phase", "noise"))))
    got = toy.make_batch(draws).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # Deterministic in the draws, and a fresh generator of the same seed
    # draws the same batch.
    again = toy.draw_batch(torch.Generator().manual_seed(6), 4, 24)
    assert torch.equal(toy.make_batch(again), toy.make_batch(draws))


class _Float64Jnp(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX generator in float64 throughout: its instance norm, FiLM
    denses and sigmoid cast to ``jnp.float32`` by name, so those two modules
    read a ``jnp`` whose float32 is float64 (under ``jax.enable_x64``)."""
    shim = _Float64Jnp("jax.numpy.float64")
    monkeypatch.setattr(jax_ghiasi, "jnp", shim)
    monkeypatch.setattr(jax_instancenorm, "jnp", shim)


def flax_tree64(sd):
    """``convert.state_dict_to_flax``'s mapping of the Ghiasi keys, in float64."""
    tree = {}
    for key, v in sd.items():
        *mods, owner, leaf = key.split(".")
        v = v.detach().numpy().copy()
        if leaf == "weight":
            v, leaf = (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T), "kernel"
        node = tree
        for m in mods + ["Conv_0" if owner == "conv" else owner]:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def test_three_adam_steps_match_the_script(jax_float64):
    """The script's train_step (targets, MSE, optax.adam at lr 2e-3) against
    the port's (``toy.train_step``, torch Adam), three steps in float64."""
    net = seeded_ghiasi(dtype=torch.float64).double()
    start = flax_tree64(net.state_dict())
    rs = np.random.RandomState(7)
    batches = [(rs.rand(2, 32, 32, 3), rs.randn(2, 100) * 0.3) for _ in range(3)]
    lr = 2e-3
    with jax.enable_x64():
        model = jax_ghiasi.Ghiasi(dtype=jnp.float64)
        tx = optax.adam(lr)

        @jax.jit
        def step(p, opt_state, x, z):
            y = jax_style_targets(x, z)
            loss, grads = jax.value_and_grad(
                lambda q: jnp.mean((model.apply({"params": q}, x, z) - y) ** 2))(p)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(p, updates), opt_state, loss

        p = jax.tree_util.tree_map(jnp.asarray, start)
        opt_state = tx.init(p)
        ref_losses = []
        for x, z in batches:
            p, opt_state, loss = step(p, opt_state, jnp.asarray(x), jnp.asarray(z))
            ref_losses.append(float(loss))
        ref = jax.tree_util.tree_map(np.asarray, p)
    assert jax.tree_util.tree_leaves(ref)[0].dtype == np.float64

    opt = toy.make_optimizer(net, lr)
    losses = [toy.train_step(net, opt, torch.from_numpy(x), torch.from_numpy(z)).item()
              for x, z in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-12)
    ours = flax_tree64(net.state_dict())
    err = jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(), ours, ref)
    moved = jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(), ours, start)
    assert max(jax.tree_util.tree_leaves(err)) <= TOL_ADAM, err
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-3


def test_written_file_is_read_by_flax(tmp_path):
    """The CLI (--no_cuda, 2 steps) writes a params tree with the shipped
    asset's keys and shapes, which flax reads into Ghiasi().init's tree;
    the JAX generator on it equals the port's on the same file."""
    out = str(tmp_path / "toy.msgpack")
    result = toy.main(["--no_cuda", "--steps", "2", "--batch", "2", "--size", "32",
                       "--out", out])
    assert result["out"] == out and set(result["mse"]) == {0, 1}
    assert np.isfinite(result["final_mse"])

    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), tree)

    assert shapes(read_flax_msgpack(out)) == shapes(read_flax_msgpack(ASSET))
    model = jax_ghiasi.Ghiasi()
    template = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                          jnp.zeros((1, 100)))["params"]
    with open(out, "rb") as f:
        params = serialization.from_bytes(template, f.read())
    rs = np.random.RandomState(8)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    z = (rs.randn(2, 100) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.jit(model.apply)({"params": params}, x, z))
    net = Ghiasi().eval()
    net.load_state_dict(load_ghiasi_params(out))
    with torch.no_grad():
        got = net(nchw(x), torch.from_numpy(z)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


# ------------------------------------ the shipped asset through the port


@pytest.fixture(scope="module")
def augmentor():
    try:
        stats = load_style_stats(default_assets_dir())
    except FileNotFoundError:
        stats = random_style_stats(0)
    aug = StyleAugmentor(alpha=0.5, stats=stats, device=torch.device("cpu"))
    aug.ghiasi.load_state_dict(load_ghiasi_params(ASSET))
    return aug


@pytest.fixture(scope="module")
def content():
    """tests/test_styleaug_quality.py's 64^2 content, NCHW."""
    rs = np.random.RandomState(3)
    xy = np.stack(np.meshgrid(np.arange(64), np.arange(64)), -1) / 64.0
    img = 0.5 + 0.35 * np.sin(2 * np.pi * (xy @ np.array([[5.0], [2.0]])))
    img = np.repeat(img[None, :, :, :], 3, axis=-1)
    img = img + 0.05 * rs.randn(2, 64, 64, 3)
    return nchw(np.clip(img, 0, 1).astype(np.float32))


def restyle(aug, content, seed: int) -> torch.Tensor:
    return aug(content, torch.Generator().manual_seed(seed))


def corr(a, b) -> float:
    a = a.double().flatten() - a.double().mean()
    b = b.double().flatten() - b.double().mean()
    return float(a @ b / (a.norm() * b.norm() + 1e-9))


class TestShippedAsset:
    """tests/test_styleaug_quality.py::TestToyGhiasiAsset through the port's
    StyleAugmentor, with its thresholds."""

    def test_content_preserved(self, augmentor, content):
        out = restyle(augmentor, content, 1)
        assert out.shape == content.shape and torch.isfinite(out).all()
        assert corr(out[0], content[0]) > 0.5

    def test_embedding_conditioned(self, augmentor, content):
        a, b = restyle(augmentor, content, 1), restyle(augmentor, content, 2)
        assert float((a - b).abs().mean()) > 0.01

    def test_deterministic_per_generator_seed(self, augmentor, content):
        assert torch.equal(restyle(augmentor, content, 7), restyle(augmentor, content, 7))

    def test_actually_changes_the_image(self, augmentor, content):
        assert float((restyle(augmentor, content, 1) - content).abs().mean()) > 0.01
