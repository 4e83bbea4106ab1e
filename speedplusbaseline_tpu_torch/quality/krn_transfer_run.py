"""KRN backbone-transfer A/B: boot against scratch on a small split (the
counterpart of the JAX package's ``scripts/krn_transfer_run.py``).

The reference KRN starts from ImageNet MobileNetV2 features; those weights
are not in the repository, so the transfer is reproduced in-house:

  1. Donor: a KRN trained on a full synthetic split. Without ``--donor``
     (default ``runs/dann_ab/save_src/model_best.pt``, the DANN A/B's arm A)
     one is trained under ``{root}/donor``: ``N_DONOR`` frames (render seed
     0), the README recipe, ``EPOCHS_DONOR`` epochs, no validation.
  2. ``dump_krn_backbone`` writes its trunk as a torchvision state dict, the
     ``convert_weights mobilenet_v2`` CLI converts it as it would the real
     torchvision file, and the train CLI's ``maybe_load_pretrained`` reads it
     through SPEEDPLUS_ASSETS_DIR from a mirrored assets directory.
  3. Both arms train on a fresh ``--n_train``-frame split (render seed 7)
     and validate on 48 unseen frames every ``--test_every`` epochs; the
     scratch arm's assets directory holds no trunk, the boot arm's the
     donor's.

    python -m speedplusbaseline_tpu_torch.quality.krn_transfer_run --root DIR
        [--donor PATH] [--n_train 96] [--epochs 120] [--test_every 10]
        [--render_w 640] [--render_h 400] [--timeout_s 3600] [--no_cuda] [extra CLI flags for every arm...]

Rerunning the command resumes (an arm that finished leaves ``done`` in its
log dir). Prints both curves and, last, a JSON line with the JAX driver's
keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import torch

from ..data.synthetic import generate_fake_speedplus
from . import common, dump_krn_backbone

N_VALID = 48
# The donor trained here when --donor is absent (the JAX driver's fixed values).
N_DONOR, EPOCHS_DONOR = 768, 120


def generate(root: str, n_train: int, width: int, height: int, cache_dir: str, seed: int,
             dev: torch.device) -> None:
    """The JAX driver's ``_GEN``: a synthetic split of ``n_train`` + 48
    frames from render seed ``seed``, labelled and cached."""
    generate_fake_speedplus(root, num_train=n_train, num_test=N_VALID, width=width,
                            height=height, domains=("synthetic",), seed=seed, device=dev)
    sp = "splits_krn"
    common.label(root, "synthetic", "train.json", sp + "/train.csv", "krn", dev)
    common.label(root, "synthetic", "test.json", sp + "/validation.csv", "krn", dev)
    common.cache(root, "synthetic", [sp + "/train.csv", sp + "/validation.csv"], cache_dir)


def prepare_assets(donor: str, assets_dir: str, dev: torch.device, timeout_s: float) -> None:
    """Donor checkpoint -> torchvision .pth -> the converted trunk in
    ``assets_dir``, made again on every call so that an earlier donor's
    trunk never stands in for this one."""
    common.mirror_assets(assets_dir)
    pth = os.path.join(assets_dir, "krn_backbone.pth")
    dump_krn_backbone.dump(donor, pth)
    common.run_arm("convert_weights", ["mobilenet_v2", "--src", pth, "--out",
                                       os.path.join(assets_dir, common.BACKBONE_ASSET)]
                   + common.device_flags(dev), timeout_s)


def train_flags(root: str, dev: torch.device) -> list:
    return [
        "--dataroot", root,
        "--input_shape", "224", "224",
        "--num_workers", common.workers(),
        "--train_domain", "synthetic", "--train_csv", "train.csv",
        "--optimizer", "adamw", "--lr", "1e-3", "--weight_decay", "0.01",
        "--batch_size", "48",
        "--cache_dir", os.path.join(root, "cache"),
    ] + common.device_flags(dev)


def train_donor(root: str, width: int, height: int, timeout_s: float, env,
                dev: torch.device, extra=()) -> str:
    """A donor of ``N_DONOR`` frames (render seed 0, unlike the A/B split's
    7), the README recipe, ``EPOCHS_DONOR`` epochs, no validation; returns
    its model_best.pt."""
    droot = os.path.join(root, "donor")
    ckpt = os.path.join(droot, "save", "model_best.pt")
    if os.path.exists(ckpt):
        return ckpt
    if not os.path.exists(os.path.join(common.split_dir(droot, "krn"), "train.csv")):
        generate(droot, N_DONOR, width, height, os.path.join(droot, "cache"), 0, dev)
    common.run_arm("train", train_flags(droot, dev) + [
        "--test_domain", "synthetic", "--test_csv", "validation.csv",
        "--max_epochs", str(EPOCHS_DONOR), "--save_epoch", "10",
        "--savedir", os.path.join(droot, "save"),
        "--logdir", os.path.join(droot, "log"),
    ] + list(extra), timeout_s, env=env)
    return ckpt


def run(root: str, donor: str, n_train: int, epochs: int, test_every: int, width: int,
        height: int, timeout_s: float, dev: torch.device, extra=()):
    """Donor, assets, both arms; returns their Valid/ curves."""
    # Neither the donor nor the scratch arm may see a trunk: the repository's
    # assets or the caller's SPEEDPLUS_ASSETS_DIR could hold one.
    scratch_assets = os.path.join(root, "scratch_assets")
    common.mirror_assets(scratch_assets)
    clean_env = dict(os.environ, SPEEDPLUS_ASSETS_DIR=scratch_assets)
    if not os.path.exists(donor):
        print(f"[krn_transfer] donor {donor} absent; training one under {root}/donor",
              flush=True)
        donor = train_donor(root, width, height, timeout_s, clean_env, dev, extra)

    if not os.path.exists(os.path.join(common.split_dir(root, "krn"), "train.csv")):
        generate(root, n_train, width, height, os.path.join(root, "cache"), 7, dev)
    assets_dir = os.path.join(root, "boot_assets")
    prepare_assets(donor, assets_dir, dev, timeout_s)

    flags = train_flags(root, dev) + [
        "--test_domain", "synthetic", "--test_csv", "validation.csv",
        "--eval_batch_size", "48",
        "--test_epoch", str(test_every), "--save_epoch", str(test_every),
        "--max_epochs", str(epochs)]
    # Scratch: random init (the reference recipe without pretrained=True).
    # Boot: the donor's trunk through maybe_load_pretrained (park2019.py:107:
    # trunk pretrained, extras and head fresh).
    for arm, env in (("scratch", clean_env),
                     ("boot", dict(os.environ, SPEEDPLUS_ASSETS_DIR=assets_dir))):
        done = os.path.join(root, f"log_{arm}", "done")
        if not os.path.exists(done):
            common.run_arm("train", flags + [
                "--savedir", os.path.join(root, f"save_{arm}"),
                "--logdir", os.path.join(root, f"log_{arm}"),
            ] + list(extra), timeout_s, env=env)
            open(done, "w").close()
    return tuple(common.arm_curve(os.path.join(root, f"log_{arm}"))
                 for arm in ("scratch", "boot"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run; prints and returns the final JSON object."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--donor", type=str,
                   default=os.path.join(common.REPO, "runs", "dann_ab", "save_src",
                                        "model_best.pt"))
    p.add_argument("--n_train", type=int, default=96)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--test_every", type=int, default=10)
    p.add_argument("--render_w", type=int, default=640)
    p.add_argument("--render_h", type=int, default=400)
    p.add_argument("--timeout_s", type=int, default=3600)
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args, extra = p.parse_known_args(argv)
    dev = common.device(args.no_cuda)

    os.makedirs(args.root, exist_ok=True)
    scratch, boot = run(args.root, args.donor, args.n_train, args.epochs, args.test_every,
                        args.render_w, args.render_h, args.timeout_s, dev, extra)
    common.print_arms(f"unseen-split validation ({args.n_train}-image training set)",
                      {"scratch": scratch, "boot": boot}, width=8)
    if not scratch or not boot:
        sys.exit(f"[krn_transfer] no validation scalars recorded (scratch: {len(scratch)} "
                 f"points, boot: {len(boot)}) — is --epochs ({args.epochs}) smaller than "
                 f"--test_every ({args.test_every})?")
    a, b = scratch[max(scratch)], boot[max(boot)]
    summary = {
        "scratch_final_eR_deg": round(a.get(common.VALID_TAGS[0], -1), 3),
        "scratch_final_speed": round(a.get(common.VALID_TAGS[2], -1), 4),
        "boot_final_eR_deg": round(b.get(common.VALID_TAGS[0], -1), 3),
        "boot_final_speed": round(b.get(common.VALID_TAGS[2], -1), 4),
        "n_train": args.n_train, "epochs": args.epochs,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
