"""KRN and SPN evaluation CLI: ``python -m speedplusbaseline_tpu_torch.test``.

The counterpart of the JAX package's root ``test.py`` (reference test.py):
build the model of ``--model_name`` (with ``--perform_dann``, KRN inside
``RevGrad``, to score a DANN checkpoint), load ``--pretrained``, validate
over the test CSV (SPN also loads ``--attitude_class``), write the
per-image dumps (err_q.txt, err_t.txt, speed_raw.txt, speed_mod.txt) to
``--logdir`` and the four averaged meters to ``$logdir/$resultfn``.

``--pretrained`` takes the port's ``model_best.pt`` (a bare state_dict) or
its ``checkpoint.pt`` (the ``"variables"`` key), and the JAX package's
``model_best.msgpack`` or ``checkpoint.msgpack`` (read without flax, then
converted). A missing file raises ``FileNotFoundError``: random weights are
never scored quietly. Without ``--pretrained`` the seeded random init is
scored, as in the JAX CLI. ``--num_devices N`` scores over N data-parallel
ranks (rank 0 writes the dumps and the results file).

Runs on CUDA unless ``--no_cuda`` is given; with no GPU and no ``--no_cuda``
it raises.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Dict, Optional, Sequence

import torch

from .config import check_ported, full_f32, parse_cfg, resolve_device
from .convert import flax_to_state_dict, read_flax_msgpack
from .engine.loops import run_validation
from .io_utils import AverageMeter, setup_logger
from .models.build import get_model
from .parallel import is_main, launch
from .train import eval_setup

logger = logging.getLogger(__name__)


def load_pretrained(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """A model state_dict from a port ``.pt`` or a JAX ``.msgpack``
    checkpoint, each either the bare model or the full train state."""
    if not osp.exists(path):
        raise FileNotFoundError(f"--pretrained checkpoint not found: {path}")
    if path.endswith(".msgpack"):
        raw = read_flax_msgpack(path)
        variables = raw.get("variables", raw)
        return flax_to_state_dict(variables["params"], variables.get("batch_stats"))
    sd = torch.load(path, map_location=device, weights_only=True)
    return sd.get("variables", sd)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, AverageMeter]:
    """Evaluate; returns the meters {eR, eT, speed (raw), speed (thr)}
    (rank 0's under data parallelism)."""
    cfg = parse_cfg(argv)
    check_ported(cfg)
    resolve_device(cfg)
    return launch(_test, cfg)


def _test(cfg) -> Dict[str, AverageMeter]:
    device = resolve_device(cfg)
    setup_logger("test")
    os.makedirs(cfg.logdir, exist_ok=True)
    logger.info("Random seed value: %d", cfg.seed)
    full_f32()
    torch.manual_seed(cfg.seed)

    model = get_model(cfg)
    if cfg.pretrained:
        model.load_state_dict(load_pretrained(cfg.pretrained, device), strict=True)
        logger.info("Model loaded from %s", cfg.pretrained)
    model = model.to(device, memory_format=torch.channels_last)

    test_loader, eval_step = eval_setup(cfg, device)
    performances = run_validation(0, cfg, eval_step, model, test_loader, None)
    if not is_main():
        return performances

    # Averaged results file (reference test.py:79-88).
    writefn = osp.join(cfg.logdir, cfg.resultfn)
    try:
        with open(writefn, "w") as f:
            for metric, meter in performances.items():
                f.write(f"{metric}: {meter.avg:.5f} [{meter.unit}]\n")
        logger.info("Test results written to %s", writefn)
    except OSError:
        logger.warning("Failed to write test results to %s", writefn)
    return performances


if __name__ == "__main__":
    main()
