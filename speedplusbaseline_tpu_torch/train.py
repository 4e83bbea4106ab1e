"""KRN and SPN training CLI: ``python -m speedplusbaseline_tpu_torch.train``.

Follows the JAX package's ``train.py`` (reference train.py:49-158): seed,
savedir/logdir, config.txt snapshot, model (``--model_name krn|spn``) +
optional StyleAugmentor, optimizer + StepLR, auto-resume, the pretrained
weights of the assets directory when the run starts at epoch 0
(``models/weight_convert.py::maybe_load_pretrained``), loaders, then per
epoch train -> validate every ``--test_epoch`` epochs -> checkpoint. SPN
loads the attitude classes (``--attitude_class``), whose count must equal
``--num_classes``. Unlike the JAX trainer, the test loader, the Tango points
and ``camera.json`` are read only when validation is on (``--test_epoch >
0``), so a run without validation needs no test split. ``--perform_dann``
raises ``ValueError``: DANN trains through the adapt CLI
(``python -m speedplusbaseline_tpu_torch.adapt``); the JAX trainer would
train RevGrad's ``net`` alone. Multi-device runs are not ported yet; their
flags raise ``NotImplementedError`` (config.check_ported).

Runs on CUDA unless ``--no_cuda`` is given; with no GPU and no ``--no_cuda``
it raises.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import List, Optional, Sequence

import torch

from .augment.styleaug import (StyleAugmentor, load_ghiasi_params,
                               load_style_stats, random_style_stats)
from .config import (check_ported, check_resume_compat, parse_cfg,
                     resolve_device, save_cfg)
from .data.loader import make_dataloader
from .engine.loops import run_validation, train_epoch
from .engine.optim import build_optimizer, set_lr, step_lr_schedule
from .engine.state import TrainState
from .engine.steps import make_krn_eval_step, make_spn_eval_step, make_train_step
from .io_utils import (SummaryWriter, checkpoint_exists, default_assets_dir,
                       load_attitude_classes, load_camera_intrinsics, load_checkpoint,
                       load_tango_3d_keypoints, save_checkpoint, setup_logger)
from .io_utils.checkpoint import CKPT_NAME
from .models.build import get_model
from .models.weight_convert import maybe_load_pretrained

logger = logging.getLogger(__name__)


def _style_augmentor(cfg, device: torch.device) -> StyleAugmentor:
    try:
        stats = load_style_stats(default_assets_dir())
    except FileNotFoundError:
        logger.warning("Style embedding assets missing; using random stats")
        stats = random_style_stats(cfg.seed)
    dtype = torch.bfloat16 if cfg.fp16 else torch.float32
    torch.manual_seed(cfg.seed + 1)  # random Ghiasi init when the asset is absent
    aug = StyleAugmentor(cfg.texture_alpha, stats, dtype=dtype, device=device)
    ghiasi_ckpt = osp.join(default_assets_dir(), "ghiasi_params.msgpack")
    if osp.exists(ghiasi_ckpt):
        aug.ghiasi.load_state_dict(load_ghiasi_params(ghiasi_ckpt))
        logger.info("Ghiasi transformer weights loaded from %s", ghiasi_ckpt)
    else:
        logger.warning("Ghiasi transformer weights not found (%s); using random "
                       "init", ghiasi_ckpt)
    logger.info("Texture randomization enabled with alpha = %s", cfg.texture_alpha)
    logger.info("   - Randomization ratio: %.2f", cfg.texture_ratio)
    return aug


def attitude_classes(cfg):
    """SPN's (num_classes, 4) class quaternions from ``--attitude_class``;
    their count must be ``--num_classes`` (the JAX train.py:145-147)."""
    q_class = load_attitude_classes(cfg.attitude_class)
    if q_class.shape[0] != cfg.num_classes:
        raise ValueError(f"--attitude_class holds {q_class.shape[0]} classes, "
                         f"--num_classes is {cfg.num_classes}")
    return q_class


def eval_setup(cfg, device: torch.device):
    """(test loader, eval step of cfg.model_name) from the test CSV, the
    Tango points, ``{dataroot}/{dataname}/camera.json`` and, for SPN, the
    attitude classes."""
    corners3d = load_tango_3d_keypoints(cfg.keypts_3d_model)
    camera_matrix, dist_coeffs = load_camera_intrinsics(
        osp.join(cfg.dataroot, cfg.dataname, "camera.json"))
    if cfg.model_name == "spn":
        step = make_spn_eval_step(attitude_classes(cfg), corners3d, camera_matrix,
                                  dist_coeffs, cfg.num_neighbors, device, cfg.fp16)
    else:
        step = make_krn_eval_step(corners3d, camera_matrix, dist_coeffs, device, cfg.fp16)
    return make_dataloader(cfg, device, is_train=False), step


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Train; returns one record per step ({epoch, step, styled, ms} and the
    loss terms: loss_x, loss_y for KRN, loss_c, loss_r for SPN)."""
    cfg = parse_cfg(argv)
    check_ported(cfg)
    if cfg.dann:
        raise ValueError("--perform_dann: DANN adaptation runs through the adapt CLI, "
                         "python -m speedplusbaseline_tpu_torch.adapt")
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
    writer = SummaryWriter(cfg.logdir)
    logger.info("Logs will be saved to %s", cfg.logdir)
    if cfg.auto_resume and checkpoint_exists(cfg.savedir):
        check_resume_compat(cfg, cfg.savedir)
    save_cfg(cfg, cfg.savedir)

    model = get_model(cfg).to(device, memory_format=torch.channels_last)
    if cfg.model_name == "spn":
        attitude_classes(cfg)  # fail before training, as the JAX trainer does

    style_aug = _style_augmentor(cfg, device) if cfg.randomize_texture else None

    train_loader = make_dataloader(cfg, device)
    steps_per_epoch = len(train_loader)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))

    begin_epoch, best_perf = 0, 0
    if cfg.auto_resume and checkpoint_exists(cfg.savedir):
        ckpt = load_checkpoint(osp.join(cfg.savedir, CKPT_NAME), device)
        state.restore(ckpt)
        begin_epoch = int(ckpt["epoch"])
        best_perf = begin_epoch
    # Pretrained init (reference park2019.py:107 / spn.py:101-123), from the
    # converted assets when present, as the JAX trainer (train.py:131-136).
    if begin_epoch == 0 and maybe_load_pretrained(cfg, model, default_assets_dir()):
        # load_state_dict copied in place: the optimizer still holds the model's parameters.
        held = [p for group in state.optimizer.param_groups for p in group["params"]]
        assert len(held) == len(list(model.parameters())) and all(
            a is b for a, b in zip(held, model.parameters()))
    if cfg.fp16:
        logger.info("bf16 autocast enabled (f32 parameters, no loss scaling)")

    train_step = make_train_step(cfg, device, style_aug)
    validate = cfg.test_epoch > 0
    if validate:
        test_loader, eval_step = eval_setup(cfg, device)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step,
                                steps_per_epoch)
    records: List[dict] = []
    try:
        for epoch in range(begin_epoch, cfg.max_epochs):
            lr_value = schedule(state.step)
            set_lr(state.optimizer, lr_value)
            for r in train_epoch(epoch + 1, cfg, state, train_step, train_loader,
                                 writer, styled=style_aug is not None,
                                 lr_value=lr_value):
                records.append({"epoch": epoch + 1, **r})
            if validate and (epoch + 1) % cfg.test_epoch == 0:
                run_validation(epoch + 1, cfg, eval_step, state.model, test_loader, writer)
            # "Best" degenerates to latest, as in the reference (train.py:141-146).
            perf = epoch + 1
            is_best = perf > best_perf
            best_perf = max(best_perf, perf)
            if (epoch + 1) % cfg.save_epoch == 0 or epoch + 1 == cfg.max_epochs:
                save_checkpoint(state.as_checkpoint_dict(epoch + 1, cfg.model_name,
                                                         best_perf),
                                is_best, cfg.savedir)
    finally:
        writer.close()
    return records


if __name__ == "__main__":
    main()
