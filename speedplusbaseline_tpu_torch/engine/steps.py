"""KRN train step (counterpart of ``speedplusbaseline_tpu/engine/steps.py::
make_krn_train_step``; reference trainer.py:41-112).

One step: uint8 -> [0, 1] on the device, the photometric augs, the Ghiasi
restyle when the host gate says so, the forward, ``krn_loss``, backward,
clip by global norm 1.0 and the optimizer step. ``--use_fp16`` means a
bfloat16 autocast around the forward with f32 parameters and no GradScaler,
as the JAX package's bf16 compute; the restyle runs in the style
augmentor's own dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..augment.photometric import apply_augment, draw_augment
from ..models.krn import krn_loss
from .optim import KRN_CLIP_NORM
from .state import TrainState


def images_to_float(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 from the loader -> (B, 3, H, W) float32 in [0, 1],
    channels_last (the permute is a view; the loader ships 4x fewer bytes
    than f32). Float inputs pass through, permuted."""
    x = images.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = x.float() * (1.0 / 255.0)
    return x.contiguous(memory_format=torch.channels_last)


def krn_step(state: TrainState, images: torch.Tensor, keypts: torch.Tensor,
             draws: Dict[str, torch.Tensor], fp16: bool, style_aug=None,
             generator: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One KRN step on given aug draws (and optional style normals ``z``).
    ``style_aug=None`` is the plain step. Returns the loss terms (device
    scalars, detached)."""
    x, kp = apply_augment(images_to_float(images), keypts, draws)
    if style_aug is not None:
        x = style_aug(x, generator, z).to(x.dtype)

    model, opt = state.model, state.optimizer
    model.train()
    with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=fp16):
        xc, yc = model(x)
    loss, sm = krn_loss(xc.float(), yc.float(), kp)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), KRN_CLIP_NORM)
    opt.step()
    state.step += 1
    return {k: v.detach() for k, v in sm.items()}


def make_krn_train_step(cfg, device: torch.device, style_aug=None):
    """Returns fn(state, batch, styled) -> loss terms. The per-batch styled /
    plain choice is the caller's (the host gate in engine/loops.py). The aug
    and style draws come from a device generator reseeded from (seed, step),
    as the JAX step folds the step into its key, so a resumed run draws what
    an uninterrupted one would."""
    gen = torch.Generator(device=device)

    def train_step(state: TrainState, batch, styled: bool):
        images, keypts = batch["image"], batch["keypts"]
        gen.manual_seed((cfg.seed << 32) + state.step)
        draws = draw_augment(gen, images.shape[0],
                             (images.shape[3], images.shape[1], images.shape[2]))
        return krn_step(state, images, keypts, draws, cfg.fp16,
                        style_aug if styled else None, gen)

    return train_step
