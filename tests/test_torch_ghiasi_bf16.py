"""The bf16 Ghiasi generator on flax-init weights: the port's plain bf16
generator against JAX's bf16 generator, each against its own f32 generator.

The weights are flax's default init drawn with numpy
(``chip_smoke.flax_init_ghiasi(s)``, the same in every torch version) for
each seed s of ``SEEDS``, taken into JAX by ``state_dict_to_flax``; the
inputs are chip_smoke's phase ghiasi's (``torch.Generator().manual_seed(1)``:
x = rand(2, 3, 224, 224), style = randn(2, 100) * 0.5). For each seed:

* J(s): JAX's ``Ghiasi(dtype=bfloat16, use_pallas=True,
  pallas_interpret=True)``, the function JAX's TPU main path computes,
  against JAX's f32 generator at float32 matmul precision;
* P(s): the port's plain bf16 generator (the CPU runs the kernels' plain
  versions) against the port's f32 generator.

Each is (max, mean) of |bf16 - f32| over the 301,056 outputs. No fixed
bound fits the bf16 generator on these weights (JAX's own max passes 2^-6 at
every seed but one here), so the port is held to JAX at the same seed:
P(s) within chip_smoke's rule of J(s) (max within 1.5x, mean within 1.25x),
and its mean within 1.02x: the mean over 301,056 outputs is the port's and
JAX's bf16 function, where the max is one element, which moves by a few
percent with the rounding of a single intermediate value. chip_smoke phase
ghiasi holds the card's bf16 generator to ``chip_smoke.JAX_GHIASI_BF16``
(J(s) as constants, since chip_smoke imports no JAX) by the rule
``chip_smoke.ghiasi_bf16_fault``; ``test_chip_smoke_constants_match_jax``
holds the constants to J(s).

``python tests/test_torch_ghiasi_bf16.py`` prints the table of J(s), JAX's
XLA path and P(s) (max / mean / elements over 2^-6) for every seed.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from speedplusbaseline_tpu.models.ghiasi import Ghiasi as JaxGhiasi  # noqa: E402
from speedplusbaseline_tpu_torch.convert import state_dict_to_flax  # noqa: E402
from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi  # noqa: E402

SEEDS = tuple(sorted(chip_smoke.JAX_GHIASI_BF16))
# P(s)'s mean against J(s)'s; the constants against J(s).
RATIO_MEAN, RATIO_CONSTANTS = 1.02, 0.02
OVER = 2.0 ** -6


def stats(got: np.ndarray, ref: np.ndarray):
    """(max, mean, elements over 2^-6) of |got - ref|."""
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return float(err.max()), float(err.mean()), int((err > OVER).sum())


@functools.lru_cache(maxsize=None)
def weights(seed: int):
    return chip_smoke.flax_init_ghiasi(seed)


@functools.lru_cache(maxsize=None)
def inputs():
    """phase ghiasi's x (NCHW) and style, as numpy."""
    x, st = chip_smoke.ghiasi_inputs()
    return x.numpy(), st.numpy()


@functools.lru_cache(maxsize=None)
def jax_errors(seed: int):
    """{"pallas": J(s), "xla": JAX's XLA path}, each (max, mean, over)."""
    params, _ = state_dict_to_flax(weights(seed))
    x, st = inputs()
    x, st = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(st)

    def run(**kw):
        return np.asarray(jax.jit(lambda p, a, s: JaxGhiasi(**kw).apply({"params": p}, a, s))(
            params, x, st)).astype(np.float32)

    with jax.default_matmul_precision("float32"):
        ref = run()
    return {"pallas": stats(run(dtype=jnp.bfloat16, use_pallas=True, pallas_interpret=True),
                            ref),
            "xla": stats(run(dtype=jnp.bfloat16), ref)}


@functools.lru_cache(maxsize=None)
def port_errors(seed: int):
    """P(s): the port's plain bf16 generator against its f32 one."""
    x, st = (torch.from_numpy(a) for a in inputs())
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = Ghiasi(dtype).eval()
        net.load_state_dict(weights(seed))
        with torch.no_grad():
            out[dtype] = net(x, st).float().numpy()
    return stats(out[torch.bfloat16], out[torch.float32])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_bf16_within_rule_of_jax(seed):
    j, p = jax_errors(seed)["pallas"], port_errors(seed)
    assert not chip_smoke.ghiasi_bf16_fault(seed, p[0], p[1]), (seed, p, j)
    assert p[1] <= RATIO_MEAN * j[1], f"seed {seed}: port mean {p[1]:.4e}, JAX {j[1]:.4e}"


def test_chip_smoke_constants_match_jax():
    for seed in SEEDS:
        j = jax_errors(seed)["pallas"][:2]
        np.testing.assert_allclose(chip_smoke.JAX_GHIASI_BF16[seed], j, rtol=RATIO_CONSTANTS,
                                   err_msg=f"seed {seed}")


def test_fault_rule():
    """chip_smoke's rule: max over 1.5x JAX's, or mean over 1.25x."""
    jmax, jmean = chip_smoke.JAX_GHIASI_BF16[SEEDS[0]]
    assert not chip_smoke.ghiasi_bf16_fault(SEEDS[0], 1.5 * jmax, 1.25 * jmean)
    assert chip_smoke.ghiasi_bf16_fault(SEEDS[0], 1.51 * jmax, jmean)
    assert chip_smoke.ghiasi_bf16_fault(SEEDS[0], jmax, 1.26 * jmean)


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    print("seed | JAX Pallas path J(s) | JAX XLA path | port plain P(s)   "
          "(max / mean / elements over 2^-6 of 301056)")
    for s in SEEDS:
        j = jax_errors(s)
        print(f"{s} | " + " | ".join("%.4e / %.4e / %d" % e
                                     for e in (j["pallas"], j["xla"], port_errors(s))),
              flush=True)
