"""Configuration: the JAX package's CLI surface (``speedplusbaseline_tpu/
config.py``), flag for flag, plus the device choice.

Every flag keeps its name, type and default, so a command line written for
``train.py`` parses here unchanged. ``--no_cuda`` asks for the CPU; without
it the entry points run on CUDA and raise when no GPU is present.
"""
from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Configurations for SPEED+ Baseline Study (PyTorch)")

    # ----- Basic directories and names (reference config.py:12-21)
    parser.add_argument("--seed", type=int, default=2021)
    parser.add_argument("--projroot", type=str, default=".")
    parser.add_argument("--dataroot", type=str, default="datasets")
    parser.add_argument("--dataname", type=str, default="speedplus")
    parser.add_argument("--savedir", type=str, default="checkpoints/synthetic/krn")
    parser.add_argument("--resultfn", type=str, default="")
    parser.add_argument("--logdir", type=str, default="log/synthetic/krn")
    parser.add_argument("--pretrained", type=str, default="")

    # ----- Model config (reference config.py:24-30)
    parser.add_argument("--model_name", type=str, default="krn")
    parser.add_argument("--input_shape", nargs="+", type=int, default=(224, 224))
    parser.add_argument("--num_keypoints", type=int, default=11)
    parser.add_argument("--num_classes", type=int, default=5000)
    parser.add_argument("--num_neighbors", type=int, default=5)
    parser.add_argument("--keypts_3d_model", type=str,
                        default="src/utils/tangoPoints.mat")
    parser.add_argument("--attitude_class", type=str,
                        default="src/utils/attitudeClasses.mat")

    # ----- Training config (reference config.py:34-49)
    parser.add_argument("--start_over", dest="auto_resume",
                        action="store_false", default=True)
    parser.add_argument("--randomize_texture", dest="randomize_texture",
                        action="store_true", default=False)
    parser.add_argument("--perform_dann", dest="dann",
                        action="store_true", default=False)
    parser.add_argument("--texture_alpha", type=float, default=0.5)
    parser.add_argument("--texture_ratio", type=float, default=0.5)
    parser.add_argument("--use_fp16", dest="fp16",
                        action="store_true", default=False)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_epochs", type=int, default=75)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--test_epoch", type=int, default=-1)
    parser.add_argument("--optimizer", type=str, default="rmsprop")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=5e-5)
    parser.add_argument("--lr_decay_alpha", type=float, default=0.96)
    parser.add_argument("--lr_decay_step", type=int, default=1)

    # ----- Dataset-related inputs (reference config.py:53-56)
    parser.add_argument("--train_domain", type=str, default="synthetic")
    parser.add_argument("--test_domain", type=str, default="lightbox")
    parser.add_argument("--train_csv", type=str, default="train.csv")
    parser.add_argument("--test_csv", type=str, default="lightbox.csv")

    # ----- Miscellaneous (reference config.py:60-61)
    parser.add_argument("--gpu_id", type=int, default=0)
    parser.add_argument("--no_cuda", dest="use_cuda",
                        action="store_false", default=True)

    # ----- Additions of the JAX package (not in the reference)
    parser.add_argument("--num_devices", type=int, default=0,
                        help="Data-parallel process count (0 = every local CUDA device; "
                             "1 with --no_cuda, where N > 1 runs N processes over gloo)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="If set, capture a profiler trace here")
    parser.add_argument("--eval_batch_size", type=int, default=32,
                        help="Batched eval (the reference evaluates batch=1)")
    parser.add_argument("--use_native_loader", action="store_true", default=False,
                        help="Decode with the C++ core (built at first use; "
                             "RuntimeError if it cannot be)")
    parser.add_argument("--cache_dir", type=str, default="",
                        help="Pre-decoded RoI cache directory")
    parser.add_argument("--save_epoch", type=int, default=1,
                        help="Checkpoint every N epochs (always at the final epoch)")
    return parser


def parse_cfg(argv=None) -> SimpleNamespace:
    """Parse CLI args into a config namespace (list -> tuple normalization)."""
    args = build_parser().parse_args(argv)
    args.input_shape = tuple(args.input_shape)
    return args


def default_cfg(**overrides) -> SimpleNamespace:
    """Programmatic config with defaults (for tests / library use)."""
    cfg = parse_cfg([])
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config key: {k}")
        setattr(cfg, k, v)
    cfg.input_shape = tuple(cfg.input_shape)
    return cfg


def check_ported(cfg) -> None:
    """Raise ValueError for a model name that is neither krn nor spn, or
    for DANN on another model than KRN."""
    from .models.build import MODEL_NAMES

    if cfg.model_name not in MODEL_NAMES:
        raise ValueError(f"--model_name must be krn or spn, got {cfg.model_name!r}")
    if cfg.dann and cfg.model_name != "krn":
        raise ValueError("--perform_dann adapts KRN only (--model_name krn)")


def resolve_device(cfg) -> torch.device:
    """CUDA unless ``--no_cuda``; never a quiet fallback to the CPU."""
    if not cfg.use_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --no_cuda to run "
                           "on the CPU")
    return torch.device("cuda", cfg.gpu_id)


def full_f32() -> None:
    """f32 math is full f32: cuDNN and cuBLAS would run f32 convs and
    matmuls in TF32 by default. Every entry point sets this before it
    builds a model."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def save_cfg(cfg, savedir: str, filename: str = "config.txt") -> None:
    """Snapshot config as JSON, matching reference train.py:69-70."""
    os.makedirs(savedir, exist_ok=True)
    with open(os.path.join(savedir, filename), "w") as f:
        json.dump({k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in vars(cfg).items()}, f, indent=2)


# Flags that determine the checkpoint's structure (parameter shapes and the
# optimizer state).
_RESUME_STRUCTURAL_KEYS = ("model_name", "optimizer", "num_classes",
                           "num_keypoints", "input_shape", "dann")


def check_resume_compat(cfg, savedir: str, filename: str = "config.txt") -> None:
    """Fail fast, with a readable message, when an auto-resume is about to
    restore a checkpoint written under structurally different flags.
    Must run BEFORE save_cfg (which overwrites the snapshot being compared)."""
    path = os.path.join(savedir, filename)
    if not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    mismatched = []
    for key in _RESUME_STRUCTURAL_KEYS:
        if key not in saved:
            continue
        old, new = saved[key], getattr(cfg, key)
        if isinstance(new, tuple):
            new = list(new)
        if old != new:
            mismatched.append(f"{key}: checkpoint={old!r} vs current={new!r}")
    if mismatched:
        raise ValueError(
            "auto-resume config mismatch — the checkpoint in "
            f"{savedir!r} was written with different structural flags:\n  "
            + "\n  ".join(mismatched)
            + "\nPass --start_over to ignore the checkpoint, or rerun with "
            "the original flags (see the saved config.txt).")
