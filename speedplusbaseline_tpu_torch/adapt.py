"""DANN adaptation CLI: ``python -m speedplusbaseline_tpu_torch.adapt``.

Follows the JAX package's root ``adapt.py`` (reference adapt.py): KRN only,
so it takes ``--perform_dann --model_name krn`` and refuses anything else
with ``ValueError``. Three loaders: the labelled source train CSV, the
unlabelled target stream (the test domain's CSV, shuffled, images only) and,
when validating, the labelled target test CSV. StepLR counts
min(len(source), len(target)) steps an epoch. Per epoch the gradient
reversal coefficient of step ``idx`` of ``n`` is 2 / (1 + exp(-10 p)) - 1
with p = (idx + epoch n) / max_epochs / n (dann.py:77-78); validation with
the KRN eval step every ``--test_epoch`` epochs; checkpoint.pt and
model_best.pt with ``"model": "krn"``. Auto-resume as in the train CLI. As
there, the Tango points and ``camera.json`` are read only when validating,
and ``--num_devices N`` runs N data-parallel ranks, each on its rows of
both streams' global batches (rank 0 writes).

Runs on CUDA unless ``--no_cuda`` is given; with no GPU and no ``--no_cuda``
it raises.
"""
from __future__ import annotations

import logging
import math
import os
import os.path as osp
from typing import List, Optional, Sequence

import torch

from .config import check_ported, check_resume_compat, parse_cfg, resolve_device, save_cfg
from .data.loader import make_dataloader
from .engine.loops import run_validation, train_epoch
from .engine.optim import build_optimizer, set_lr, step_lr_schedule
from .engine.state import TrainState
from .engine.steps import make_dann_train_step
from .io_utils import (SummaryWriter, checkpoint_exists, load_checkpoint, save_checkpoint,
                       setup_logger)
from .io_utils.checkpoint import CKPT_NAME
from .models.build import get_model
from .parallel import barrier, broadcast_params, is_main, launch
from .train import eval_setup

logger = logging.getLogger(__name__)


def grl_alpha(idx: int, n_batches: int, epoch: int, max_epochs: int) -> float:
    """The gradient reversal coefficient of step ``idx`` of ``n_batches`` in
    0-based ``epoch`` (dann.py:77-78): 0 at the start, towards 1 at the end."""
    p = float(idx + epoch * n_batches) / max_epochs / n_batches
    return 2.0 / (1.0 + math.exp(-10.0 * p)) - 1.0


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Adapt; returns one record per step ({epoch, step, styled, ms, alpha}
    and loss_pose, loss_source, loss_target)."""
    cfg = parse_cfg(argv)
    if not (cfg.dann and cfg.model_name == "krn"):
        raise ValueError("the adapt CLI trains DANN on KRN: pass --perform_dann and "
                         "--model_name krn")
    check_ported(cfg)
    resolve_device(cfg)
    return launch(_adapt, cfg)


def _adapt(cfg) -> List[dict]:
    device = resolve_device(cfg)
    setup_logger("train")
    logger.info("Random seed value: %d", cfg.seed)
    logger.info("Device: %s", device)
    # f32 math is full f32 (cuDNN would run f32 convs in TF32 by default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(cfg.seed)

    os.makedirs(cfg.savedir, exist_ok=True)
    logger.info("Checkpoints will be saved to %s", cfg.savedir)
    writer = SummaryWriter(cfg.logdir) if is_main() else None
    if cfg.auto_resume and checkpoint_exists(cfg.savedir):
        check_resume_compat(cfg, cfg.savedir)
    barrier(device)  # every rank has read the snapshot before rank 0 rewrites it
    if is_main():
        save_cfg(cfg, cfg.savedir)

    model = get_model(cfg).to(device, memory_format=torch.channels_last)  # RevGrad
    source_loader = make_dataloader(cfg, device)
    target_loader = make_dataloader(cfg, device, is_source=False, load_labels=False)
    steps_per_epoch = min(len(source_loader), len(target_loader))
    state = TrainState(model, build_optimizer(cfg, model.parameters()))

    begin_epoch, best_perf = 0, 0
    if cfg.auto_resume and checkpoint_exists(cfg.savedir):
        ckpt = load_checkpoint(osp.join(cfg.savedir, CKPT_NAME), device)
        state.restore(ckpt)
        begin_epoch = int(ckpt["epoch"])
        best_perf = begin_epoch
    broadcast_params(model)

    train_step = make_dann_train_step(cfg, device)
    validate = cfg.test_epoch > 0
    if validate:
        test_loader, eval_step = eval_setup(cfg, device)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step,
                                steps_per_epoch)
    records: List[dict] = []
    try:
        for epoch in range(begin_epoch, cfg.max_epochs):
            def alpha_fn(idx, n_batches, epoch=epoch):
                return grl_alpha(idx, n_batches, epoch, cfg.max_epochs)

            lr_value = schedule(state.step)
            set_lr(state.optimizer, lr_value)
            for r in train_epoch(epoch + 1, cfg, state, train_step, None, writer,
                                 lr_value=lr_value, dann_loaders=(source_loader, target_loader),
                                 dann_alpha_fn=alpha_fn):
                records.append({"epoch": epoch + 1,
                                "alpha": alpha_fn(r["step"], steps_per_epoch), **r})
            if validate and (epoch + 1) % cfg.test_epoch == 0:
                run_validation(epoch + 1, cfg, eval_step, state.model, test_loader, writer)
            # "Best" degenerates to latest, as in the reference.
            perf = epoch + 1
            is_best = perf > best_perf
            best_perf = max(best_perf, perf)
            if (epoch + 1) % cfg.save_epoch == 0 or epoch + 1 == cfg.max_epochs:
                if is_main():
                    save_checkpoint(state.as_checkpoint_dict(epoch + 1, cfg.model_name,
                                                             best_perf),
                                    is_best, cfg.savedir)
                barrier(device)
    finally:
        if writer is not None:
            writer.close()
    return records


if __name__ == "__main__":
    main()
