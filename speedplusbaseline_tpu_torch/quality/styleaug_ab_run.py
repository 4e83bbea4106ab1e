"""Style-augmentation A/B on the domain-gapped fake dataset (the counterpart
of the JAX package's ``scripts/styleaug_ab_run.py``): does
``--randomize_texture`` move the target-domain pose error without any target
data?

Both arms train on the synthetic source split with the README KRN recipe
(224^2, batch 48, AdamW lr 1e-3) and are scored on the lightbox split every
``--test_every`` epochs:

  A (source-only): the DANN A/B's arm A (``save_src``, ``log_src``), reused
     when ``--root`` is that A/B's root, trained here otherwise;
  C (style-aug): the train CLI with ``--randomize_texture --texture_ratio
     0.5``, which restyles through the Ghiasi generator and both kernels.

Then both ``model_best.pt`` are scored by the test CLI on a photometric-only
target split: sunlamp frames of the source's blob markers in the target's
bright, blurred surroundings (style ``blobs_bright``, seed 2, ``N_PHOTO``
frames), the gap style augmentation is meant for.

    python -m speedplusbaseline_tpu_torch.quality.styleaug_ab_run --root DIR
        [--epochs 150] [--n_src 768] [--n_tgt 768] [--test_every 25]
        [--render_w 640] [--render_h 400] [--timeout_s 3600] [--no_cuda] [extra CLI flags for every arm...]

Rerunning the command resumes. Prints both curves, the sunlamp scores and,
last, a JSON line with the JAX driver's keys.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from ..data.synthetic import generate_fake_speedplus
from . import common
from .dann_adaptation_run import common_flags, generate

# Frames of the sunlamp blobs_bright split (the JAX driver's fixed 192).
N_PHOTO = 192

def photometric_generate(root: str, n: int, width: int, height: int, cache_dir: str,
                         dev: torch.device) -> None:
    """The JAX driver's ``_GEN_PHOTO``: ``n`` sunlamp test frames of style
    blobs_bright (seed 2), labelled and cached."""
    generate_fake_speedplus(root, num_train=0, num_test=n, width=width, height=height,
                            domains=("sunlamp",), seed=2,
                            domain_styles={"sunlamp": "blobs_bright"}, device=dev)
    common.label(root, "sunlamp", "test.json", "splits_krn/test.csv", "krn", dev)
    common.cache(root, "sunlamp", ["splits_krn/test.csv"], cache_dir)


def eval_arm(root: str, tag: str, ckpt: str, timeout_s: float, dev: torch.device,
             extra=()) -> Dict[str, float]:
    """Score one checkpoint on the sunlamp split through the test CLI;
    returns its results file as {metric: value}."""
    logdir = os.path.join(root, f"log_photo_{tag}")
    common.run_arm("test", [
        "--dataroot", root,
        "--input_shape", "224", "224",
        "--test_domain", "sunlamp", "--test_csv", "test.csv",
        "--eval_batch_size", "48", "--batch_size", "48",
        "--cache_dir", os.path.join(root, "cache"),
        "--pretrained", ckpt,
        "--logdir", logdir, "--resultfn", "results.txt",
    ] + common.device_flags(dev) + list(extra), timeout_s)
    common.err_q_stats(logdir)
    out = {}
    with open(os.path.join(logdir, "results.txt")) as f:
        for line in f:
            metric, rest = line.split(":", 1)
            out[metric.strip()] = float(rest.split("[")[0])
    return out


def photometric_eval(root: str, n_eval: int, width: int, height: int, timeout_s: float,
                     dev: torch.device, extra=()):
    if not os.path.exists(os.path.join(root, common.DATANAME, "sunlamp", "splits_krn",
                                       "test.csv")):
        photometric_generate(root, n_eval, width, height, os.path.join(root, "cache"), dev)
    return tuple(eval_arm(root, tag, os.path.join(root, save, "model_best.pt"), timeout_s,
                          dev, extra)
                 for tag, save in (("src", "save_src"), ("style", "save_style")))


def run(root: str, n_src: int, n_tgt: int, epochs: int, test_every: int, width: int,
        height: int, timeout_s: float, dev: torch.device, extra=()):
    """Generate when needed, train arm A if absent and arm C; returns their
    Valid/ curves."""
    if not os.path.exists(os.path.join(root, common.DATANAME, "lightbox", "splits_krn",
                                       "test.csv")):
        generate(root, n_src, n_tgt, width, height, os.path.join(root, "cache"), dev)
    flags = common_flags(root, test_every, dev) + [
        "--batch_size", "48", "--max_epochs", str(epochs)]
    # Arm A: plain supervised, shared with the DANN A/B when the roots match.
    if not os.path.exists(os.path.join(root, "log_src", "scalars.jsonl")):
        common.run_arm("train", flags + [
            "--savedir", os.path.join(root, "save_src"),
            "--logdir", os.path.join(root, "log_src"),
        ] + list(extra), timeout_s)
    # Arm C: + style augmentation at the reference's default ratio and alpha.
    common.run_arm("train", flags + [
        "--savedir", os.path.join(root, "save_style"),
        "--logdir", os.path.join(root, "log_style"),
        "--randomize_texture", "--texture_ratio", "0.5",
    ] + list(extra), timeout_s)
    return tuple(common.arm_curve(os.path.join(root, d)) for d in ("log_src", "log_style"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run; prints and returns the final JSON object."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--n_src", type=int, default=768)
    p.add_argument("--n_tgt", type=int, default=768)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--test_every", type=int, default=25)
    p.add_argument("--render_w", type=int, default=640)
    p.add_argument("--render_h", type=int, default=400)
    p.add_argument("--timeout_s", type=int, default=3600)
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args, extra = p.parse_known_args(argv)
    dev = common.device(args.no_cuda)

    os.makedirs(args.root, exist_ok=True)
    src, style = run(args.root, args.n_src, args.n_tgt, args.epochs, args.test_every,
                     args.render_w, args.render_h, args.timeout_s, dev, extra)
    common.print_arms("target-domain (lightbox) validation", {"src": src, "style": style})
    photo_src, photo_style = photometric_eval(args.root, N_PHOTO, args.render_w,
                                              args.render_h, args.timeout_s, dev, extra)
    print("\n       photometric-gap (sunlamp blobs_bright) test")
    print(f"src    eR {photo_src.get('eR', -1):8.3f}  "
          f"speed {photo_src.get('speed (raw)', -1):8.4f}")
    print(f"style  eR {photo_style.get('eR', -1):8.3f}  "
          f"speed {photo_style.get('speed (raw)', -1):8.4f}")

    a, c = src[max(src)], style[max(style)]
    summary = {
        "src_only_final_eR_deg": round(a.get(common.VALID_TAGS[0], -1), 3),
        "src_only_final_speed": round(a.get(common.VALID_TAGS[2], -1), 4),
        "styleaug_final_eR_deg": round(c.get(common.VALID_TAGS[0], -1), 3),
        "styleaug_final_speed": round(c.get(common.VALID_TAGS[2], -1), 4),
        "photo_src_eR_deg": photo_src.get("eR", -1),
        "photo_style_eR_deg": photo_style.get("eR", -1),
        "photo_src_speed": photo_src.get("speed (raw)", -1),
        "photo_style_speed": photo_style.get("speed (raw)", -1),
        "epochs": args.epochs,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
