"""What the train and adapt CLIs share around their loops: the prologue of a
run, the auto-resume from ``CKPT_NAME`` and the end of an epoch (reference
train.py:49-75 and 141-158)."""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Optional, Tuple

import torch

from ..config import check_resume_compat, full_f32, resolve_device, save_cfg
from ..io_utils import (SummaryWriter, checkpoint_exists, load_checkpoint, save_checkpoint,
                        setup_logger)
from ..io_utils.checkpoint import CKPT_NAME
from ..parallel import barrier, is_main
from .state import TrainState

logger = logging.getLogger(__name__)


def open_run(cfg) -> Tuple[torch.device, Optional[SummaryWriter]]:
    """(device, rank 0's writer, None on the other ranks): the logger, full
    f32, ``torch.manual_seed(cfg.seed)``, the savedir, the resume check
    against the savedir's config snapshot, then rank 0 rewrites the snapshot
    once every rank has read it."""
    device = resolve_device(cfg)
    setup_logger("train")
    logger.info("Random seed value: %d", cfg.seed)
    logger.info("Device: %s", device)
    full_f32()
    torch.manual_seed(cfg.seed)

    os.makedirs(cfg.savedir, exist_ok=True)
    logger.info("Checkpoints will be saved to %s", cfg.savedir)
    writer = SummaryWriter(cfg.logdir) if is_main() else None
    logger.info("Logs will be saved to %s", cfg.logdir)
    if cfg.auto_resume and checkpoint_exists(cfg.savedir):
        check_resume_compat(cfg, cfg.savedir)
    barrier(device)  # every rank has read the snapshot before rank 0 rewrites it
    if is_main():
        save_cfg(cfg, cfg.savedir)
    return device, writer


def resume(cfg, state: TrainState, device: torch.device) -> Tuple[int, int]:
    """(epochs done, best score): (0, 0), or, under auto-resume with a
    checkpoint in the savedir, its epoch twice after restoring ``state``
    from it."""
    if not (cfg.auto_resume and checkpoint_exists(cfg.savedir)):
        return 0, 0
    ckpt = load_checkpoint(osp.join(cfg.savedir, CKPT_NAME), device)
    state.restore(ckpt)
    epoch = int(ckpt["epoch"])
    return epoch, epoch


def end_epoch(cfg, state: TrainState, epoch: int, best_perf: int,
              device: torch.device) -> int:
    """After the 1-based ``epoch``: "best" degenerates to the latest, as in
    the reference (train.py:141-146); rank 0 writes the checkpoint every
    ``--save_epoch`` epochs and at the last while the other ranks wait.
    Returns the new best."""
    is_best = epoch > best_perf
    best_perf = max(best_perf, epoch)
    if epoch % cfg.save_epoch == 0 or epoch == cfg.max_epochs:
        if is_main():
            save_checkpoint(state.as_checkpoint_dict(epoch, cfg.model_name, best_perf),
                            is_best, cfg.savedir)
        barrier(device)
    return best_perf
