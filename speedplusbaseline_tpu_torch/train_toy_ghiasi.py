"""Toy Ghiasi trainer: ``python -m speedplusbaseline_tpu_torch.train_toy_ghiasi``.

The counterpart of ``scripts/train_toy_ghiasi.py``, which made the shipped
``assets/ghiasi_params.msgpack``, flag for flag, plus ``--no_cuda``. The
reference's real generator weights (``checkpoint_transformer.pth``) are not
in the repo, so the style path ships a toy generator trained to perform a
visibly style-conditioned transform: the target is a parametric photometric
restyle whose 3x3 color matrix, brightness and contrast are fixed linear
projections of the 100-d style embedding (``style_targets``), drawn from
the same distribution the style augmentor samples (z @ A^T + mean,
``augment/styleaug.py``). The content is gratings plus noise
(``make_batch``), so that "keep the content" is a real constraint.

The port's ``Ghiasi()`` in f32 with the plain lowering trains with
``torch.optim.Adam`` at optax.adam's defaults; on the card its forward runs
B1 five times and B2 six times a step, and its backward is the VJP of their
plain versions (``ops/_vjp.py``). Every random number of a step comes from
one ``torch.Generator`` on the device (``draw_batch``); the batch is a
deterministic function of the draws (``make_batch``), as
``augment/photometric.py`` splits draw and apply. The JAX script draws from
``jax.random``, so the two runs share their recipe, not their numbers.

Prints ``step N  mse X`` every 50 steps and at the last, as the script
does, and writes the parameters as the flax msgpack the script writes
(``convert.state_dict_to_flax`` + ``write_flax_msgpack``), which flax's
``serialization.from_bytes``, the train CLI and ``augment/styleaug.py``
read. Runs on CUDA unless ``--no_cuda``, with TF32 off; with no GPU and no
``--no_cuda`` it raises.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .augment.styleaug import load_style_stats, random_style_stats
from .config import full_f32, resolve_device
from .convert import state_dict_to_flax, write_flax_msgpack
from .io_utils.assets import default_assets_dir
from .models.ghiasi import EMBED_DIM, Ghiasi


def style_targets(x: torch.Tensor, emb: torch.Tensor, seed: int = 11) -> torch.Tensor:
    """The parametric restyle the toy generator learns to imitate.

    x: (B, H, W, 3) in [0, 1]; emb: (B, 100). Returns (B, H, W, 3) in [0, 1]:
    per-image color mixing, contrast and brightness, all linear in emb.
    """
    rs = np.random.RandomState(seed)
    # Fixed projections: emb -> (3x3 color delta, brightness, log-contrast).
    p_mix, p_bri, p_con = (torch.from_numpy(a).to(emb) for a in (
        rs.randn(EMBED_DIM, 9).astype(np.float32) * 0.05,
        rs.randn(EMBED_DIM).astype(np.float32) * 0.08,
        rs.randn(EMBED_DIM).astype(np.float32) * 0.10))

    mix = torch.eye(3, dtype=emb.dtype, device=emb.device) + (emb @ p_mix).reshape(-1, 3, 3)
    bri = (emb @ p_bri)[:, None, None, None]
    con = torch.exp(torch.tanh(emb @ p_con))[:, None, None, None]

    y = torch.einsum("bhwc,bcd->bhwd", x, mix)
    y = (y - 0.5) * con + 0.5 + bri
    return torch.clip(y, 0.0, 1.0)


def draw_batch(generator: torch.Generator, batch: int, size: int) -> Dict[str, torch.Tensor]:
    """One step's random numbers, on the generator's device: grating
    frequencies in [2, 9) and phases in [0, pi) per image and color, pixel
    noise and the embedding's unit normals."""
    kw = dict(generator=generator, device=generator.device)
    return {"freq": 2.0 + 7.0 * torch.rand((batch, 1, 1, 2, 3), **kw),
            "phase": math.pi * torch.rand((batch, 1, 1, 1, 3), **kw),
            "noise": torch.randn((batch, size, size, 3), **kw),
            "z": torch.randn((batch, EMBED_DIM), **kw)}


def make_batch(draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The content images (B, S, S, 3) in [0, 1] of one step's draws:
    mixed-frequency gratings plus noise (scripts/train_toy_ghiasi.py:97-108)."""
    freq, noise = draws["freq"], draws["noise"]
    size = noise.shape[1]
    r = torch.arange(size, device=noise.device)
    xy = torch.stack(torch.meshgrid(r, r, indexing="xy"), -1).to(noise.dtype) / size
    img = 0.5 + 0.35 * torch.sin(
        2 * np.pi * (xy[None, :, :, :, None] * freq).sum(3) + draws["phase"][..., 0, :])
    img = img + 0.08 * noise
    return torch.clip(img, 0.0, 1.0)


def embed(z: torch.Tensor, A: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Style embeddings from unit normals: z @ A^T + mean."""
    return z @ A.T + mean


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam at optax.adam's defaults."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def mse_loss(model: Ghiasi, x: torch.Tensor, emb: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the generator's restyle of x (B, H, W, 3)."""
    out = model(x.permute(0, 3, 1, 2), emb).permute(0, 2, 3, 1)
    return (out - target).square().mean()


def train_step(model: Ghiasi, opt: torch.optim.Optimizer, x: torch.Tensor,
               emb: torch.Tensor) -> torch.Tensor:
    """One Adam step on the batch; returns the loss before it (a tensor on
    the device, not read back)."""
    loss = mse_loss(model, x, emb, style_targets(x, emb))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("Train the toy Ghiasi generator")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default="assets/ghiasi_params.msgpack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_cuda", dest="use_cuda", action="store_false", default=True)
    ap.set_defaults(gpu_id=0)  # resolve_device's card; no flag
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train and write ``--out``. Returns {"out", "mse": {step: value}, "final_mse",
    "train_s": the loop's seconds on the host clock, synchronised}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args)
    full_f32()

    try:
        stats = load_style_stats(default_assets_dir())
    except FileNotFoundError:
        stats = random_style_stats(0)
    A, mean = (torch.as_tensor(a, device=device) for a in stats[:2])

    torch.manual_seed(args.seed)
    model = Ghiasi().to(device)  # the plain lowering, as the script's
    opt = make_optimizer(model, args.lr)
    generator = torch.Generator(device).manual_seed(args.seed)

    mse: Dict[int, float] = {}
    t0 = time.perf_counter()
    for step in range(args.steps):
        draws = draw_batch(generator, args.batch, args.size)
        loss = train_step(model, opt, make_batch(draws), embed(draws["z"], A, mean))
        if step % 50 == 0 or step == args.steps - 1:
            mse[step] = loss.item()
            print(f"step {step:4d}  mse {mse[step]:.5f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_flax_msgpack(state_dict_to_flax(model.state_dict())[0], args.out)
    print("wrote", args.out)
    return {"out": args.out, "mse": mse, "final_mse": mse[args.steps - 1], "train_s": train_s}


if __name__ == "__main__":
    main()
