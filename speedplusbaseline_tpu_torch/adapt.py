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

import math
from typing import List, Optional, Sequence

from .config import check_ported, parse_cfg, resolve_device
from .data.loader import make_dataloader
from .engine.loops import run_validation, train_epoch
from .engine.optim import set_lr, step_lr_schedule
from .engine.run import end_epoch, open_run, resume
from .engine.state import TrainState
from .engine.steps import make_dann_train_step
from .parallel import broadcast_params, launch
from .train import eval_setup


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
    device, writer = open_run(cfg)
    state = TrainState.for_config(cfg, device)  # RevGrad
    source_loader = make_dataloader(cfg, device)
    target_loader = make_dataloader(cfg, device, is_source=False, load_labels=False)
    steps_per_epoch = min(len(source_loader), len(target_loader))

    begin_epoch, best_perf = resume(cfg, state, device)
    broadcast_params(state.model)

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
            best_perf = end_epoch(cfg, state, epoch + 1, best_perf, device)
    finally:
        if writer is not None:
            writer.close()
    return records


if __name__ == "__main__":
    main()
