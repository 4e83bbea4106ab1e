"""SPN memorization probe (counterpart of the JAX package's
``scripts/probe_spn_memorize.py``): can the SPN training path overfit a few
fixed batches?

    python -m speedplusbaseline_tpu_torch.quality.probe_spn_memorize
        [--steps 1500] [--n_batches 1] [--no_clip] [train CLI flags...]

Takes ``n_batches`` batches of real ``SPNDataset`` crops in CSV order and
trains on them in turn with the train CLI's model, optimizer and
``make_spn_train_step`` (dropout on, its masks drawn per step), the lr held
(``--lr_decay_step 10000``), for ``--steps`` steps. ``--no_clip`` swaps the
optimizer for Adam(b1 = ``--momentum``, b2 = 0.999, eps = 1e-8), decoupled
weight decay and the held lr, with no clip, as the JAX probe's optax chain.
The flags ``--model_name spn --input_shape 227 227 --dataroot runs/spn_conv
--train_csv train.csv --cache_dir runs/spn_conv/cache --lr_decay_step 10000``
come first; later flags override them. Prints the JAX probe's lines: a
``loaded batch`` line every 8 batches, the batch's shapes, ``step i loss_c
... (cyc-avg ...) loss_r ... (...s)`` every 100 steps and at the last step,
then ``DONE``.

Runs on CUDA unless ``--no_cuda`` is given; with no GPU and no ``--no_cuda``
it raises. f32 math is full f32 (no TF32), as in the train CLI.

The JAX probe's record: one batch of the 5000-class set collapses from
8.52 to the n-hot entropy floor of 1.61 (ln 5) in under 100 steps
(BASELINE.md, round-4 SPN diagnosis).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import check_ported, full_f32, parse_cfg, resolve_device
from ..data.csv_dataset import SPNDataset
from ..engine.optim import adam
from ..engine.state import TrainState
from ..engine.steps import make_spn_train_step

DEFAULTS = ["--model_name", "spn", "--input_shape", "227", "227",
            "--dataroot", "runs/spn_conv", "--train_csv", "train.csv",
            "--cache_dir", "runs/spn_conv/cache",
            "--lr_decay_step", "10000"]  # hold the lr flat for the probe


def _pop(argv: List[str], flag: str, default: int) -> int:
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = int(argv[i + 1])
    del argv[i:i + 2]
    return value


def no_clip_optimizer(cfg, params) -> torch.optim.Optimizer:
    """The JAX probe's ``--no_clip`` chain: scale_by_adam(b1=momentum,
    b2=0.999, eps=1e-8), add_decayed_weights(weight_decay), the held lr;
    torch's AdamW is that chain, built as the trainer builds it."""
    return adam(torch.optim.AdamW, params, cfg.lr, cfg.momentum, cfg.weight_decay)


def load_batches(cfg, n_batches: int) -> List[dict]:
    """``n_batches`` batches of training crops in CSV order, as numpy."""
    ds = SPNDataset(cfg, is_train=True, is_source=True)
    batches = []
    for b in range(n_batches):
        items = [ds[b * cfg.batch_size + i] for i in range(cfg.batch_size)]
        batches.append({k: np.stack([it[k] for it in items]) for k in items[0]})
        if b % 8 == 0:
            print(f"loaded batch {b}/{n_batches}", flush=True)
    return batches


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the probe; returns one record per printed line: {step, loss_c,
    cyc_avg, loss_r, seconds}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    steps = _pop(argv, "--steps", 1500)
    n_batches = _pop(argv, "--n_batches", 1)
    no_clip = "--no_clip" in argv
    if no_clip:
        argv.remove("--no_clip")
    cfg = parse_cfg(DEFAULTS + argv)
    check_ported(cfg)
    device = resolve_device(cfg)
    full_f32()
    torch.manual_seed(cfg.seed)

    host = load_batches(cfg, n_batches)
    print("batch:", {k: (v.shape, str(v.dtype)) for k, v in host[0].items()}, flush=True)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in host]

    state = TrainState.for_config(cfg, device)
    if no_clip:
        state.optimizer = no_clip_optimizer(cfg, state.model.parameters())
    step = make_spn_train_step(cfg, device, clip=not no_clip)

    records: List[dict] = []
    t0 = time.time()
    win = []
    for i in range(steps):
        sm = step(state, batches[i % n_batches], False)
        win.append(sm["loss_c"])
        if i % 100 == 99 or i == steps - 1:
            lc = float(sm["loss_c"])
            avg = float(np.mean([float(x) for x in win[-min(len(win), n_batches):]]))
            lr_ = float(sm["loss_r"])
            secs = time.time() - t0
            print(f"step {i:5d}  loss_c {lc:.4f} (cyc-avg {avg:.4f})  "
                  f"loss_r {lr_:.4f}  ({secs:.1f}s)", flush=True)
            records.append({"step": i, "loss_c": lc, "cyc_avg": avg, "loss_r": lr_,
                            "seconds": secs})
            win = win[-n_batches:]
    print("DONE", flush=True)
    return records


if __name__ == "__main__":
    main()
