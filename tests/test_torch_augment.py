"""Port augmentations against the JAX package.

JAX draws its random numbers inside the augs from keys; the port splits
draw and apply. So these tests re-derive, from the same JAX keys, every
number JAX draws (gates, k, flip side, contrast, brightness, noise), hand
them to the port's apply step, and compare with JAX's own output: equal to
1e-6 (the same f32 arithmetic). The port's own draws are checked by their
distribution.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedplusbaseline_tpu.augment.photometric import augment_batch
from speedplusbaseline_tpu.augment.styleaug import StyleAugmentor as JaxStyleAugmentor
from speedplusbaseline_tpu.augment.styleaug import random_style_stats
from speedplusbaseline_tpu_torch.augment.photometric import apply_augment, draw_augment
from speedplusbaseline_tpu_torch.augment.styleaug import StyleAugmentor, load_style_stats
from speedplusbaseline_tpu_torch.convert import state_dict_to_flax
from speedplusbaseline_tpu_torch.io_utils import default_assets_dir

torch.set_num_threads(1)


def jax_draws(key, batch, hw):
    """The numbers augment_batch draws, per sample, as the port's draws."""
    out = {k: [] for k in ("rot_on", "rot_k", "flip_on", "flip_h", "bc_on", "bc_a",
                           "bc_b", "noise_on", "noise")}
    for sk in jax.random.split(key, batch):
        keys = jax.random.split(sk, 8)
        gate = [bool(jax.random.uniform(keys[2 * i]) < 0.5) for i in range(4)]
        op = [keys[2 * i + 1] for i in range(4)]
        ka, kb = jax.random.split(op[2])
        lo, hi = jnp.log(0.5), jnp.log(2.0)
        out["rot_on"].append(gate[0])
        out["rot_k"].append(int(jax.random.randint(op[0], (), 1, 4)))
        out["flip_on"].append(gate[1])
        out["flip_h"].append(bool(jax.random.uniform(op[1]) < 0.5))
        out["bc_on"].append(gate[2])
        out["bc_a"].append(float(jnp.exp(jax.random.uniform(ka) * (hi - lo) + lo)))
        out["bc_b"].append(float((jax.random.uniform(kb) * 50.0 - 25.0) / 255.0))
        out["noise_on"].append(gate[3])
        noise = np.asarray(jax.random.normal(op[3], (hw, hw, 3), dtype=jnp.float32))
        out["noise"].append(noise.transpose(2, 0, 1))
    d = {k: torch.tensor(np.array(v)) for k, v in out.items()}
    d["bc_a"] = d["bc_a"].float()
    d["bc_b"] = d["bc_b"].float()
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_matches_jax_on_same_draws(seed):
    B, H = 16, 12
    rs = np.random.RandomState(seed)
    images = rs.rand(B, H, H, 3).astype(np.float32)
    keypts = rs.rand(B, 2, 11).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_kp = augment_batch(key, jnp.asarray(images), jnp.asarray(keypts))
    d = jax_draws(key, B, H)
    # every branch is taken somewhere in the batch
    assert set(d["rot_k"][d["rot_on"]].tolist()) == {1, 2, 3}
    assert d["flip_on"].any() and d["bc_on"].any() and d["noise_on"].any()
    img, kp = apply_augment(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                            torch.from_numpy(keypts), d)
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), np.asarray(ref_img),
                               atol=1e-6)
    np.testing.assert_allclose(kp.numpy(), np.asarray(ref_kp), atol=1e-6)


def test_draw_distributions():
    n = 200_000
    g = torch.Generator().manual_seed(0)
    d = draw_augment(g, n, (3, 2, 2))
    for gate in ("rot_on", "flip_on", "bc_on", "noise_on", "flip_h"):
        assert abs(d[gate].float().mean().item() - 0.5) < 0.01, gate
    counts = torch.bincount(d["rot_k"], minlength=4)
    assert counts[0] == 0 and d["rot_k"].max() == 3
    assert torch.allclose(counts[1:].float() / n, torch.full((3,), 1 / 3), atol=0.01)
    log_a = torch.log(d["bc_a"])  # log-uniform contrast on [1/2, 2]
    assert log_a.min() >= math.log(0.5) - 1e-6 and log_a.max() <= math.log(2.0) + 1e-6
    assert abs(log_a.mean().item()) < 0.01
    assert abs(log_a.std().item() - 2 * math.log(2.0) / math.sqrt(12)) < 0.01
    assert d["bc_b"].abs().max() <= 25.0 / 255.0 + 1e-7
    assert abs(d["bc_b"].mean().item()) < 0.001
    assert abs(d["noise"].mean().item()) < 0.01 and abs(d["noise"].std().item() - 1) < 0.01


def test_style_stats_and_embedding_match_jax():
    """load_style_stats (SVD factor) and sample_embedding on the same z,
    then the whole restyle on the same weights, against the JAX
    StyleAugmentor (plain Ghiasi path on the CPU)."""
    stats = load_style_stats(default_assets_dir())
    from speedplusbaseline_tpu.augment.styleaug import load_style_stats as jax_stats

    for ours, ref in zip(stats, jax_stats(default_assets_dir())):
        np.testing.assert_array_equal(ours, ref)

    stats = random_style_stats(4)
    jaug = JaxStyleAugmentor(0.5, stats)
    torch.manual_seed(1)
    aug = StyleAugmentor(0.5, stats, device=torch.device("cpu"))
    params, _ = state_dict_to_flax(aug.ghiasi.state_dict())

    key = jax.random.PRNGKey(2)
    z = np.array(jax.random.normal(key, (3, 100), dtype=jnp.float32))
    np.testing.assert_allclose(
        aug.sample_embedding(3, z=torch.from_numpy(z)).numpy(),
        np.asarray(jaug.sample_embedding(key, 3)), atol=1e-6)

    x = np.random.RandomState(5).rand(3, 16, 16, 3).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.jit(lambda p, x: jaug(p, key, x))(params, jnp.asarray(x)))
    out = aug(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), z=torch.from_numpy(z))
    assert not out.requires_grad
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4)
