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
train RevGrad's ``net`` alone. ``--profile_dir`` records ``torch.profiler``
(CPU, and CUDA on the card) from the second epoch of the run to its end and
writes a Chrome trace there, as the JAX trainer (train.py:162-189) captures
from its second epoch; a one-epoch run writes none. ``--cache_dir`` and
``--use_native_loader`` go to the datasets (data/csv_dataset.py).
``--num_devices N`` trains data-parallel over N processes, each on its rows
of every global batch of ``--batch_size`` (parallel/mesh.py): spawned here
(N CUDA devices over NCCL; with ``--no_cuda``, N CPU processes over gloo),
or one rank each under ``torchrun``. Rank 0 alone writes the scalars, the
dumps and the checkpoints.

Runs on CUDA unless ``--no_cuda`` is given; with no GPU and no ``--no_cuda``
it raises.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import List, Optional, Sequence

import torch

from .augment.styleaug import style_augmentor
from .config import check_ported, parse_cfg, resolve_device
from .data.loader import make_dataloader
from .engine.loops import run_validation, train_epoch
from .engine.optim import set_lr, step_lr_schedule
from .engine.run import end_epoch, open_run, resume
from .engine.state import TrainState
from .engine.steps import make_krn_eval_step, make_spn_eval_step, make_train_step
from .io_utils import (default_assets_dir, load_attitude_classes, load_camera_intrinsics,
                       load_tango_3d_keypoints)
from .models.weight_convert import maybe_load_pretrained
from .parallel import broadcast_params, is_main, launch

logger = logging.getLogger(__name__)


def attitude_classes(cfg):
    """SPN's (num_classes, 4) class quaternions from ``--attitude_class``;
    their count must be ``--num_classes`` (the JAX train.py:145-147)."""
    q_class = load_attitude_classes(cfg.attitude_class)
    if q_class.shape[0] != cfg.num_classes:
        raise ValueError(f"--attitude_class holds {q_class.shape[0]} classes, "
                         f"--num_classes is {cfg.num_classes}")
    return q_class


def start_profiler(device: torch.device):
    """A started ``torch.profiler`` of the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


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
    loss terms: loss_x, loss_y for KRN, loss_c, loss_r for SPN), rank 0's
    under data parallelism."""
    cfg = parse_cfg(argv)
    check_ported(cfg)
    if cfg.dann:
        raise ValueError("--perform_dann: DANN adaptation runs through the adapt CLI, "
                         "python -m speedplusbaseline_tpu_torch.adapt")
    resolve_device(cfg)
    return launch(_train, cfg)


def _train(cfg) -> List[dict]:
    device, writer = open_run(cfg)
    state = TrainState.for_config(cfg, device)
    if cfg.model_name == "spn":
        attitude_classes(cfg)  # fail before training, as the JAX trainer does

    style_aug = style_augmentor(cfg, device) if cfg.randomize_texture else None

    train_loader = make_dataloader(cfg, device)
    steps_per_epoch = len(train_loader)

    begin_epoch, best_perf = resume(cfg, state, device)
    # Pretrained init (reference park2019.py:107 / spn.py:101-123), from the
    # converted assets when present, as the JAX trainer (train.py:131-136).
    if begin_epoch == 0 and maybe_load_pretrained(cfg, state.model, default_assets_dir()):
        # load_state_dict copied in place: the optimizer still holds the model's parameters.
        held = [p for group in state.optimizer.param_groups for p in group["params"]]
        params = list(state.model.parameters())
        assert len(held) == len(params) and all(a is b for a, b in zip(held, params))
    broadcast_params(state.model)
    if cfg.fp16:
        logger.info("bf16 autocast enabled (f32 parameters, no loss scaling)")

    train_step = make_train_step(cfg, device, style_aug)
    validate = cfg.test_epoch > 0
    if validate:
        test_loader, eval_step = eval_setup(cfg, device)
    schedule = step_lr_schedule(cfg.lr, cfg.lr_decay_alpha, cfg.lr_decay_step,
                                steps_per_epoch)
    records: List[dict] = []
    prof = None
    try:
        for epoch in range(begin_epoch, cfg.max_epochs):
            if cfg.profile_dir and epoch == begin_epoch + 1 and is_main():
                prof, first_profiled = start_profiler(device), epoch + 1
            lr_value = schedule(state.step)
            set_lr(state.optimizer, lr_value)
            for r in train_epoch(epoch + 1, cfg, state, train_step, train_loader,
                                 writer, styled=style_aug is not None,
                                 lr_value=lr_value):
                records.append({"epoch": epoch + 1, **r})
            if validate and (epoch + 1) % cfg.test_epoch == 0:
                run_validation(epoch + 1, cfg, eval_step, state.model, test_loader, writer)
            best_perf = end_epoch(cfg, state, epoch + 1, best_perf, device)
        if prof is not None:
            prof.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            trace = osp.join(cfg.profile_dir,
                             f"trace_epochs{first_profiled}-{cfg.max_epochs}.json")
            prof.export_chrome_trace(trace)
            prof = None
            logger.info("Profiler trace written to %s", trace)
    finally:
        if prof is not None:  # an error left it running
            prof.stop()
        if writer is not None:
            writer.close()
    return records


if __name__ == "__main__":
    main()
