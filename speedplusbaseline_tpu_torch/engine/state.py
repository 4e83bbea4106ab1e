"""Train state: model, optimizer and step count (counterpart of
``speedplusbaseline_tpu/engine/state.py``), and its checkpoint dict in the
reference's payload shape (utils.py:109-119)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.build import get_model
from .optim import build_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def for_config(cls, cfg, device: torch.device) -> "TrainState":
        """``get_model(cfg)`` channels_last on ``device`` and its optimizer.
        Draws only the model's init: the caller seeds."""
        model = get_model(cfg).to(device, memory_format=torch.channels_last)
        return cls(model, build_optimizer(cfg, model.parameters()))

    def as_checkpoint_dict(self, epoch: int, model_name: str, best_score):
        return {
            "epoch": epoch,
            "model": model_name,
            "variables": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "best_score": best_score,
        }

    def restore(self, ckpt: dict) -> None:
        """Load a checkpoint dict (strict, like the reference's load)."""
        self.model.load_state_dict(ckpt["variables"], strict=True)
        self.optimizer.load_state_dict(ckpt["opt_state"])
        self.step = int(ckpt.get("step", 0))
