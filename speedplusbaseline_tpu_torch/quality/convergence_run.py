"""Convergence run: the train CLI on the learnable fake dataset until the
train -> EPnP -> SPEED-score loop reaches a low pose error on unseen images
(the counterpart of the JAX package's ``scripts/convergence_run.py``).

    python -m speedplusbaseline_tpu_torch.quality.convergence_run [--model krn|spn]
        [--n_train N] [--epochs E] [--input HW] [--test_every K] [--root DIR]
        [--render_w W] [--render_h H] [--cache] [--num_classes N] [--no_cuda]
        [extra train CLI flags...]

Defaults: 384 images, 60 epochs, 224^2 (KRN) / 227^2 (SPN), validation every
10 epochs on 48 unseen images, a temporary root, 320x200 renders. ``--cache``
builds the RoI cache first. Unrecognised arguments go to the train CLI as
they are (e.g. ``--lr_decay_step 50``). ``--model spn --num_classes N``
trains against N farthest-point-sampled attitude bins
(``data/synthetic.py::generate_attitude_classes``) instead of the 5000-bin
asset. With ``--root`` the dataset and checkpoints stay, so rerunning the
same command resumes. Prints the eR/eT/SPEED curve, the last validation's
per-image median and p90 (``err_q.txt``) and, last, a JSON line with the
JAX driver's keys.

KRN Run B: ``--n_train 3072 --render_w 640 --render_h 400 --epochs 150
--test_every 10``. SPN Run S: ``--model spn --num_classes 500 --n_train 3072
--render_w 640 --render_h 400 --cache --epochs 80 --test_every 10
--lr_decay_step 3 --save_epoch 10``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.synthetic import generate_attitude_classes, generate_fake_speedplus
from . import common

N_VALID = 48


def generate(root: str, n_train: int, width: int, height: int, model: str,
             cache_dir: str, num_classes: int, dev: torch.device) -> None:
    """Render, label and cache as the JAX driver's ``_GEN``. Each stage skips
    what exists, so a root holding images (and a cache) from an earlier run
    only makes its bins and CSVs again."""
    data = os.path.join(root, common.DATANAME, "synthetic")
    if not os.path.isdir(os.path.join(data, "images")):
        generate_fake_speedplus(root, num_train=n_train, num_test=N_VALID, width=width,
                                height=height, domains=("synthetic",), device=dev)
    att = ""
    if num_classes:
        att = attitude_path(root, num_classes)
        if not os.path.exists(att):
            np.save(att, generate_attitude_classes(num_classes))
    sp = "splits_" + model
    common.label(root, "synthetic", "train.json", sp + "/train.csv", model, dev, att)
    common.label(root, "synthetic", "test.json", sp + "/validation.csv", model, dev, att)
    # Stamp the bin count the class columns were made with (needs_generate).
    with open(os.path.join(common.split_dir(root, model), "gen_meta.json"), "w") as f:
        json.dump({"num_classes": num_classes}, f)
    if cache_dir and not os.path.exists(os.path.join(cache_dir, common.DATANAME, "synthetic",
                                                     "cache_manifest.csv")):
        common.cache(root, "synthetic", [sp + "/train.csv", sp + "/validation.csv"], cache_dir)


def train_flags(root: str, epochs: int, input_hw: int, test_every: int, model: str = "krn",
                cache: bool = False, num_classes: int = 0) -> list:
    """The train CLI's flags of a run on ``root`` (without the device flag):
    the JAX driver's, which its ``train.py`` takes as they are."""
    flags = [
        "--dataroot", root,
        "--savedir", os.path.join(root, "save"),
        "--logdir", os.path.join(root, "log"),
        "--model_name", model,
        "--input_shape", str(input_hw), str(input_hw),
        "--batch_size", "48",
        "--max_epochs", str(epochs),
        "--num_workers", common.workers(),
        "--test_domain", "synthetic",
        "--test_csv", "validation.csv",
        "--eval_batch_size", "48",
        "--optimizer", "adamw",
        "--lr", "1e-3",
        "--weight_decay", "0.01",
        "--test_epoch", str(test_every),
    ]
    if num_classes:
        flags += ["--num_classes", str(num_classes),
                  "--attitude_class", attitude_path(root, num_classes)]
    return flags + (["--cache_dir", os.path.join(root, "cache")] if cache else [])


def attitude_path(root: str, num_classes: int) -> str:
    return os.path.join(root, f"attitude_classes_{num_classes}.npy")


def prepare(root: str, n_train: int, width: int, height: int, model: str, cache: bool,
            num_classes: int, dev: torch.device) -> None:
    """Generate the dataset of a run on ``root`` when ``needs_generate``
    says so."""
    attitude_npy = attitude_path(root, num_classes) if num_classes else ""
    if common.needs_generate(root, model, attitude_npy, num_classes):
        generate(root, n_train, width, height, model,
                 os.path.join(root, "cache") if cache else "", num_classes, dev)


def run(root: str, n_train: int, epochs: int, input_hw: int, test_every: int, extra=(),
        width: int = 320, height: int = 200, model: str = "krn", cache: bool = False,
        num_classes: int = 0, *, dev: torch.device):
    """Generate when needed, train; returns the Valid/ curve."""
    prepare(root, n_train, width, height, model, cache, num_classes, dev)
    common.run_arm("train", train_flags(root, epochs, input_hw, test_every, model, cache,
                                        num_classes) + common.device_flags(dev) + list(extra))
    return common.arm_curve(os.path.join(root, "log"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run; prints and returns the final JSON object."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="krn", choices=("krn", "spn"))
    p.add_argument("--n_train", type=int, default=384)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--input", type=int, default=0,
                   help="input H=W (default: 224 for krn, 227 for spn)")
    p.add_argument("--test_every", type=int, default=10)
    p.add_argument("--root", type=str, default="")
    p.add_argument("--render_w", type=int, default=320)
    p.add_argument("--render_h", type=int, default=200)
    p.add_argument("--cache", action="store_true", help="build the RoI cache first")
    p.add_argument("--num_classes", type=int, default=0,
                   help="SPN only: this many FPS-sampled attitude bins instead of the "
                        "5000-bin asset")
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args, extra = p.parse_known_args(argv)
    dev = common.device(args.no_cuda)
    input_hw = args.input or (227 if args.model == "spn" else 224)

    kw = dict(extra=extra, width=args.render_w, height=args.render_h, model=args.model,
              cache=args.cache, num_classes=args.num_classes, dev=dev)
    if args.root:
        os.makedirs(args.root, exist_ok=True)
        curve = run(args.root, args.n_train, args.epochs, input_hw, args.test_every, **kw)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            curve = run(tmp, args.n_train, args.epochs, input_hw, args.test_every, **kw)

    print("epoch  eR[deg]   eT[m]    speed(raw)")
    for ep in sorted(curve):
        print(f"{ep:5d}  {common.curve_row(curve[ep])}")
    if not curve:
        sys.exit(f"[convergence] no validation scalars recorded — is --epochs "
                 f"({args.epochs}) smaller than --test_every ({args.test_every})?")
    last = curve[max(curve)]
    summary = {
        "convergence_final_eR_deg": round(last.get(common.VALID_TAGS[0], -1), 4),
        "convergence_final_eT_m": round(last.get(common.VALID_TAGS[1], -1), 5),
        "convergence_final_speed": round(last.get(common.VALID_TAGS[2], -1), 5),
        "model": args.model,
        "n_train": args.n_train, "epochs": args.epochs, "input": input_hw,
        "num_classes": args.num_classes or None,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
