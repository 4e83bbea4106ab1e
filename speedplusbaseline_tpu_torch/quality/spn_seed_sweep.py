"""SPN Run S seed sweep: the first epochs of Run S at many seeds, which of
them stall at the uniform-class loss, and which ReLU units are live as a
run sets off.

    python -m speedplusbaseline_tpu_torch.quality.spn_seed_sweep --root DIR
        [--seeds S ...] [--epochs 4] [--live_seeds S ...]
        [--seeds_dir DIR] [--tabulate] [--compare DIR] [--no_cuda]
        [--n_train N] [--render_w W] [--render_h H] [--input HW]
        [extra train CLI flags...]

Each seed is one train CLI run with Run S's flags (``run_s_flags``: the
convergence driver's ``--model spn --num_classes 500 --cache
--lr_decay_step 3 --save_epoch 10``) and ``--seed S --max_epochs E``, into
``{seeds_dir}/seed_S`` (default ``{root}/seeds``). The dataset is Run S's
(3072 frames of 640x400), made in ``--root`` when missing, as the
convergence driver makes it. A seed is stalled when the mean ``loss_c`` of
its last epoch is at least ln(num_classes) - ``STALL_MARGIN``: a classifier
that has not left the uniform prediction.

``--live_seeds`` also trains those seeds in this process as the train CLI
does (``live_run``) and prints, per layer, the share of ReLU units that are
live on a fixed batch (the first ``--batch_size`` training rows in CSV
order) before the steps ``LIVE_STEPS``: a unit, a conv channel or a dense
neuron, is live when its pre-activation is positive somewhere on the batch.
The ReLU-free heads fc8 and fc11 are not counted.

``--tabulate`` trains nothing and reads the runs found in ``--seeds_dir``
that reached ``--epochs`` epochs;
``--compare DIR`` tabulates the runs in DIR too (the JAX package's
``train.py`` runs with the same flags, for instance) and prints the
two-sided Fisher exact p of the two stall counts. The last line is a JSON
object of the table.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import full_f32, parse_cfg, resolve_device
from ..data.csv_dataset import SPNDataset
from ..data.loader import make_dataloader
from ..engine.loops import train_epoch
from ..engine.optim import set_lr, step_lr_schedule
from ..engine.state import TrainState
from ..engine.steps import images_to_float, make_spn_train_step
from ..io_utils import default_assets_dir
from ..models.weight_convert import maybe_load_pretrained
from . import common, convergence_run

NUM_CLASSES = 500
STALL_MARGIN = 0.05
DEFAULT_SEEDS = (2021,) + tuple(range(11))
LIVE_LAYERS = ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc9", "fc10")
LIVE_STEPS = (0, 16, 64, 256)


def run_s_flags(root: str, seed: int, epochs: int, out: str, input_hw: int = 227) -> List[str]:
    """The train CLI's flags of Run S at ``seed`` for ``epochs`` epochs,
    writing into ``out``/save and ``out``/log (no device flag)."""
    return convergence_run.train_flags(root, epochs, input_hw, 10, "spn", True, NUM_CLASSES) + [
        "--lr_decay_step", "3", "--save_epoch", "10", "--seed", str(seed),
        "--savedir", os.path.join(out, "save"), "--logdir", os.path.join(out, "log")]


def loss_c_by_epoch(logdir: str) -> List[float]:
    """``train/loss_c`` of each epoch, in epoch order, from
    ``{logdir}/scalars.jsonl``."""
    out: Dict[int, float] = {}
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "train/loss_c":
                out[rec["step"]] = rec["value"]
    return [out[e] for e in sorted(out)]


def is_stalled(curve: Sequence[float], num_classes: int = NUM_CLASSES) -> bool:
    """The last epoch's mean loss_c is within STALL_MARGIN of ln(num_classes)
    or above it."""
    return curve[-1] >= math.log(num_classes) - STALL_MARGIN


def fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """Two-sided Fisher exact p of the 2x2 table [[a, b], [c, d]]: the sum of
    the probabilities, under fixed margins, of the tables no likelier than
    the one seen."""
    row, col, n = a + b, a + c, a + b + c + d

    def prob(x):
        return math.comb(col, x) * math.comb(n - col, row - x) / math.comb(n, row)

    seen = prob(a)
    lo, hi = max(0, row + col - n), min(row, col)
    return min(1.0, sum(prob(x) for x in range(lo, hi + 1) if prob(x) <= seen * (1 + 1e-9)))


def live_shares(model: torch.nn.Module, images: torch.Tensor,
                layers: Sequence[str] = LIVE_LAYERS) -> Dict[str, float]:
    """Per layer, the share of units whose pre-activation is positive for
    some row (and, for a conv, some position) of ``images`` (B, 3, H, W),
    with the model in eval mode (no dropout); its mode is restored."""
    live: Dict[str, float] = {}

    def hook(name):
        def fn(_module, _inputs, out):
            alive = (out > 0).any(0)  # (C, H, W) of a conv, (N,) of a dense layer
            if alive.dim() == 3:
                alive = alive.flatten(1).any(1)
            live[name] = alive.float().mean().item()
        return fn

    handles = [getattr(model, n).register_forward_hook(hook(n)) for n in layers]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(images)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return live


def fixed_batch(cfg, device: torch.device) -> torch.Tensor:
    """The first ``cfg.batch_size`` training crops in CSV order, as the
    model's input."""
    ds = SPNDataset(cfg, is_train=True, is_source=True)
    images = np.stack([ds[i]["image"] for i in range(cfg.batch_size)])
    return images_to_float(torch.from_numpy(images).to(device))


def live_run(cfg, steps_at: Sequence[int] = LIVE_STEPS):
    """Train ``cfg`` as the train CLI does (seed, init, pretrained assets,
    loader, optimizer, StepLR a epoch, ``train_epoch`` over the SPN step; no
    validation or checkpoint), measuring ``live_shares`` on ``fixed_batch``
    before each step of ``steps_at`` (after the last step for the step
    count the run ends on). Returns ({step: shares}, [mean loss_c of each
    epoch])."""
    device = resolve_device(cfg)
    full_f32()
    torch.manual_seed(cfg.seed)
    state = TrainState.for_config(cfg, device)
    model = state.model
    loader = make_dataloader(cfg, device)
    maybe_load_pretrained(cfg, model, default_assets_dir())
    step = make_spn_train_step(cfg, device)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step, len(loader))
    fixed = fixed_batch(cfg, device)
    shares: Dict[int, Dict[str, float]] = {}

    def measured_step(state, batch, styled):
        if state.step in steps_at:
            shares[state.step] = live_shares(model, fixed)
        return step(state, batch, styled)

    epochs: List[float] = []
    for epoch in range(cfg.max_epochs):
        lr_value = schedule(state.step)
        set_lr(state.optimizer, lr_value)
        records = train_epoch(epoch + 1, cfg, state, measured_step, loader, None,
                              lr_value=lr_value)
        epochs.append(float(np.mean([r["loss_c"] for r in records])))
    if state.step in steps_at:
        shares[state.step] = live_shares(model, fixed)
    return shares, epochs


def tabulate(seeds_dir: str, title: str, epochs: int,
             num_classes: int = NUM_CLASSES) -> dict:
    """Print and return {seed: {"loss_c": [...], "stalled": bool}} of the
    runs in ``seeds_dir`` (subdirectories ``seed_S`` with a log) that
    reached ``epochs`` epochs, judged on their first ``epochs``."""
    table = {}
    for name in os.listdir(seeds_dir):
        m = re.fullmatch(r"seed_(\d+)", name)
        log = os.path.join(seeds_dir, name, "log")
        if m and os.path.exists(os.path.join(log, "scalars.jsonl")):
            curve = loss_c_by_epoch(log)[:epochs]
            if len(curve) == epochs:
                table[int(m.group(1))] = {"loss_c": curve,
                                          "stalled": is_stalled(curve, num_classes)}
    print(f"\n{title}: train/loss_c by epoch, stalled = last >= ln {num_classes} - "
          f"{STALL_MARGIN} = {math.log(num_classes) - STALL_MARGIN:.4f}")
    for seed in sorted(table):
        row = table[seed]
        print(f"seed {seed:5d}  " + " ".join(f"{v:.4f}" for v in row["loss_c"])
              + f"  {'stalled' if row['stalled'] else 'learned'}")
    n = sum(r["stalled"] for r in table.values())
    print(f"{title}: {n} of {len(table)} seeds stalled", flush=True)
    return table


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=list(DEFAULT_SEEDS))
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--live_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seeds_dir", type=str, default="")
    p.add_argument("--tabulate", action="store_true", help="read the runs; train nothing")
    p.add_argument("--compare", type=str, default="",
                   help="a second directory of seed_S runs to tabulate and test against")
    p.add_argument("--n_train", type=int, default=3072)
    p.add_argument("--render_w", type=int, default=640)
    p.add_argument("--render_h", type=int, default=400)
    p.add_argument("--input", type=int, default=227)
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args, extra = p.parse_known_args(argv)
    seeds_dir = args.seeds_dir or os.path.join(args.root, "seeds")

    if not args.tabulate:
        dev = common.device(args.no_cuda)
        convergence_run.prepare(args.root, args.n_train, args.render_w, args.render_h, "spn",
                                True, NUM_CLASSES, dev)
        for seed in args.seeds:
            out = os.path.join(seeds_dir, f"seed_{seed}")
            common.run_arm("train", run_s_flags(args.root, seed, args.epochs, out, args.input)
                           + common.device_flags(dev) + list(extra))
            shutil.rmtree(os.path.join(out, "save"))  # weights and Adam moments: 1.4 GB
    result = {"port": tabulate(seeds_dir, "seeds", args.epochs)}
    if args.compare:
        result["compare"] = tabulate(args.compare, "compare", args.epochs)
        a = sum(r["stalled"] for r in result["port"].values())
        c = sum(r["stalled"] for r in result["compare"].values())
        result["fisher_p"] = fisher_exact(a, len(result["port"]) - a,
                                          c, len(result["compare"]) - c)
        print(f"Fisher exact p (two-sided): {result['fisher_p']:.4f}")

    result["live"] = {}
    for seed in args.live_seeds:
        out = os.path.join(seeds_dir, f"live_{seed}")
        cfg = parse_cfg(run_s_flags(args.root, seed, args.epochs, out, args.input)
                        + common.device_flags(common.device(args.no_cuda)) + list(extra))
        shares, epochs = live_run(cfg)
        result["live"][seed] = {"shares": shares, "loss_c": epochs}
        print(f"\nlive ReLU units, seed {seed} (loss_c by epoch "
              + " ".join(f"{v:.4f}" for v in epochs) + ")")
        print("step  " + " ".join(f"{n:>6s}" for n in LIVE_LAYERS))
        for s in sorted(shares):
            print(f"{s:4d}  " + " ".join(f"{shares[s][n]:6.3f}" for n in LIVE_LAYERS))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
