"""Checkpoint I/O in the port's own format (``torch.save`` of a dict), with
the reference's file-per-run layout (utils.py:109-135):

  $savedir/checkpoint.pt   -- {epoch, model, variables, opt_state, step,
                               best_score}: the full train state
  $savedir/model_best.pt   -- the model's state_dict alone

The write is atomic (temp file + ``os.replace``): a crash never leaves a
truncated resume file.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict

import torch

logger = logging.getLogger(__name__)

CKPT_NAME = "checkpoint.pt"
BEST_NAME = "model_best.pt"


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(state_dict: Dict[str, Any], is_best: bool, output_dir: str,
                    filename: str = CKPT_NAME) -> None:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    _atomic_save(state_dict, path)
    logger.info("Checkpoint saved to %s", path)
    if is_best and "variables" in state_dict:
        best_path = os.path.join(output_dir, BEST_NAME)
        _atomic_save(state_dict["variables"], best_path)
        logger.info("Best model saved to %s", best_path)


def load_checkpoint(path: str, device: torch.device) -> Dict[str, Any]:
    ckpt = torch.load(path, map_location=device, weights_only=True)
    logger.info("Checkpoint loaded from %s at epoch %s", path, ckpt.get("epoch", "?"))
    return ckpt


def checkpoint_exists(savedir: str) -> bool:
    return os.path.exists(os.path.join(savedir, CKPT_NAME))
