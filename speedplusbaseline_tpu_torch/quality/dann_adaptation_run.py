"""DANN adaptation A/B on the domain-gapped fake dataset (the counterpart of
the JAX package's ``scripts/dann_adaptation_run.py``).

The source domain (synthetic: gaussian blobs on dim noise) is labelled; the
target (lightbox: ring markers on a bright striped background with optical
blur, ``data/synthetic.py::DOMAIN_STYLES``) is one large test split, read
both as the unlabelled DANN stream and as the labelled evaluation. Two
arms, both scored on that lightbox split every ``--test_every`` epochs:

  A (source-only): the train CLI, the README KRN recipe (224^2, batch 48,
     AdamW lr 1e-3);
  B (DANN): the adapt CLI with ``--perform_dann`` (batch 16, AdamW lr 1e-3,
     StepLR step 10 gamma 0.95). The port's train CLI refuses
     ``--perform_dann``, so this arm runs through the adapt CLI.

    python -m speedplusbaseline_tpu_torch.quality.dann_adaptation_run --root DIR
        [--n_src 768] [--n_tgt 768] [--epochs_src 150] [--epochs_dann 250]
        [--test_every 25] [--render_w 640] [--render_h 400] [--timeout_s 3600]
        [--no_cuda] [extra CLI flags for both arms...]

With ``--root`` the dataset, cache and checkpoints stay; an arm runs once and
a crash raises, and rerunning the command resumes both arms from their
checkpoints. Prints both curves and, last, a JSON line with the JAX
driver's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch

from ..data.synthetic import generate_fake_speedplus
from . import common

N_SOURCE_VALID = 48


def generate(root: str, n_src: int, n_tgt: int, width: int, height: int, cache_dir: str,
             dev: torch.device) -> None:
    """Render, label and cache as the JAX driver's ``_GEN``: the labelled
    synthetic train split (with a small source validation split the arms do
    not use), one lightbox test split of ``n_tgt`` frames (seed 1), and the
    cache of the synthetic train and lightbox test frames."""
    generate_fake_speedplus(root, num_train=n_src, num_test=N_SOURCE_VALID, width=width,
                            height=height, domains=("synthetic",), device=dev)
    generate_fake_speedplus(root, num_train=0, num_test=n_tgt, width=width, height=height,
                            domains=("lightbox",), seed=1, device=dev)
    common.label(root, "synthetic", "train.json", "splits_krn/train.csv", "krn", dev)
    common.label(root, "synthetic", "test.json", "splits_krn/validation.csv", "krn", dev)
    common.label(root, "lightbox", "test.json", "splits_krn/test.csv", "krn", dev)
    common.cache(root, "synthetic", ["splits_krn/train.csv"], cache_dir)
    common.cache(root, "lightbox", ["splits_krn/test.csv"], cache_dir)


def common_flags(root: str, test_every: int, dev: torch.device) -> list:
    """The flags both arms (and the style-aug arms) share."""
    return [
        "--dataroot", root,
        "--input_shape", "224", "224",
        "--num_workers", common.workers(),
        "--train_domain", "synthetic", "--train_csv", "train.csv",
        "--test_domain", "lightbox", "--test_csv", "test.csv",
        "--eval_batch_size", "48",
        "--optimizer", "adamw", "--lr", "1e-3", "--weight_decay", "0.01",
        "--test_epoch", str(test_every), "--save_epoch", str(test_every),
        "--cache_dir", os.path.join(root, "cache"),
    ] + common.device_flags(dev)


def run(root: str, n_src: int, n_tgt: int, epochs_src: int, epochs_dann: int,
        test_every: int, width: int, height: int, timeout_s: float, dev: torch.device,
        extra=()):
    """Generate when needed, run both arms; returns their Valid/ curves."""
    if not os.path.exists(os.path.join(root, common.DATANAME, "lightbox", "splits_krn",
                                       "test.csv")):
        generate(root, n_src, n_tgt, width, height, os.path.join(root, "cache"), dev)
    flags = common_flags(root, test_every, dev)
    # Arm A: the README KRN recipe (README.md:78-87).
    common.run_arm("train", flags + [
        "--savedir", os.path.join(root, "save_src"),
        "--logdir", os.path.join(root, "log_src"),
        "--batch_size", "48", "--max_epochs", str(epochs_src),
    ] + list(extra), timeout_s)
    # Arm B: the README DANN recipe (README.md:102-111).
    common.run_arm("adapt", flags + [
        "--savedir", os.path.join(root, "save_dann"),
        "--logdir", os.path.join(root, "log_dann"),
        "--perform_dann", "--batch_size", "16",
        "--max_epochs", str(epochs_dann),
        "--lr_decay_step", "10", "--lr_decay_alpha", "0.95",
    ] + list(extra), timeout_s)
    return tuple(common.arm_curve(os.path.join(root, d)) for d in ("log_src", "log_dann"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run; prints and returns the final JSON object."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, default="")
    p.add_argument("--n_src", type=int, default=768)
    p.add_argument("--n_tgt", type=int, default=768)
    p.add_argument("--epochs_src", type=int, default=150)
    p.add_argument("--epochs_dann", type=int, default=250)
    p.add_argument("--test_every", type=int, default=25)
    p.add_argument("--render_w", type=int, default=640)
    p.add_argument("--render_h", type=int, default=400)
    p.add_argument("--timeout_s", type=int, default=3600)
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args, extra = p.parse_known_args(argv)
    dev = common.device(args.no_cuda)

    def _go(root):
        return run(root, args.n_src, args.n_tgt, args.epochs_src, args.epochs_dann,
                   args.test_every, args.render_w, args.render_h, args.timeout_s, dev,
                   extra)

    if args.root:
        os.makedirs(args.root, exist_ok=True)
        src, dann = _go(args.root)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            src, dann = _go(tmp)

    common.print_arms("target-domain (lightbox) validation", {"src": src, "dann": dann})
    if not src or not dann:
        sys.exit(f"[dann_ab] no validation scalars recorded (src: {len(src)} points, dann: "
                 f"{len(dann)}) — are --epochs_src/--epochs_dann smaller than --test_every "
                 f"({args.test_every})?")
    a, b = src[max(src)], dann[max(dann)]
    summary = {
        "src_only_final_eR_deg": round(a.get(common.VALID_TAGS[0], -1), 3),
        "src_only_final_speed": round(a.get(common.VALID_TAGS[2], -1), 4),
        "dann_final_eR_deg": round(b.get(common.VALID_TAGS[0], -1), 3),
        "dann_final_speed": round(b.get(common.VALID_TAGS[2], -1), 4),
        "n_src": args.n_src, "n_tgt": args.n_tgt,
        "epochs_src": args.epochs_src, "epochs_dann": args.epochs_dann,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
