"""Model factory (counterpart of ``speedplusbaseline_tpu/models/build.py``;
reference src/nets/build.py:39-58). ``--use_fp16`` is a bf16 autocast around
the forward in the steps, so the models keep f32 parameters either way."""
from __future__ import annotations

import logging

import torch.nn as nn

from .krn import KeypointRegressionNet
from .revgrad import RevGrad
from .spn import SpacecraftPoseNet

logger = logging.getLogger(__name__)

MODEL_NAMES = ("krn", "spn")


def get_model(cfg) -> nn.Module:
    """KRN or SPN from ``cfg.model_name``, sized by ``cfg.input_shape``;
    with ``cfg.dann``, KRN inside ``RevGrad`` (DANN adapts KRN only)."""
    if cfg.model_name not in MODEL_NAMES:
        raise ValueError(f"unknown model_name {cfg.model_name!r}; expected one of "
                         f"{MODEL_NAMES}")
    if cfg.dann:
        if cfg.model_name != "krn":
            raise ValueError("--perform_dann adapts KRN only (--model_name krn)")
        model = RevGrad(cfg.num_keypoints, cfg.input_shape)
    elif cfg.model_name == "krn":
        model = KeypointRegressionNet(cfg.num_keypoints, cfg.input_shape)
    else:
        model = SpacecraftPoseNet(cfg.num_classes, input_shape=cfg.input_shape)
    n = sum(p.numel() for p in model.parameters())
    logger.info("%s created; %s parameters", "RevGrad (KRN)" if cfg.dann
                else cfg.model_name.upper(), f"{n:,}")
    return model
