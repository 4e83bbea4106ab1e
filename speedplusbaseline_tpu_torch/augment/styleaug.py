"""Style augmentation (counterpart of ``speedplusbaseline_tpu/augment/
styleaug.py``; reference styleAugmentor.py).

A style embedding z ~ N(mean_pbn, cov_pbn) is sampled through the SVD factor
A = U S^1/2 of the covariance, interpolated with the SPEED+ mean embedding
(alpha*z + (1-alpha)*base) and fed with the batch to the frozen Ghiasi
generator under ``torch.no_grad()`` (the reference's ``.detach()``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import flax_to_state_dict, read_flax_msgpack
from ..io_utils.assets import default_assets_dir
from ..io_utils.spans import span
from ..models.ghiasi import EMBED_DIM, Ghiasi

logger = logging.getLogger(__name__)


def load_style_stats(assets_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, mean, base) for the embedding sampler (styleAugmentor.py:38-41)."""
    mean = np.load(os.path.join(assets_dir, "style_embedding_pbn_mean.npy"))
    cov = np.load(os.path.join(assets_dir, "style_embedding_pbn_cov.npy"))
    base = np.load(os.path.join(assets_dir, "style_embedding_speedplus_mean.npy"))
    u, s, _ = np.linalg.svd(cov)
    A = u @ np.diag(np.sqrt(s))
    return (A.astype(np.float32), mean.reshape(-1).astype(np.float32),
            base.reshape(-1).astype(np.float32))


def random_style_stats(seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random stand-in stats for tests / when assets are unavailable."""
    rs = np.random.RandomState(seed)
    A = (rs.randn(EMBED_DIM, EMBED_DIM) * 0.05).astype(np.float32)
    mean = rs.randn(EMBED_DIM).astype(np.float32) * 0.1
    base = rs.randn(EMBED_DIM).astype(np.float32) * 0.1
    return A, mean, base


def load_ghiasi_params(path: str) -> dict:
    """State dict of the port's ``Ghiasi`` from a flax msgpack checkpoint
    (e.g. ``assets/ghiasi_params.msgpack``)."""
    return flax_to_state_dict(read_flax_msgpack(path))


class StyleAugmentor:
    """Frozen style randomizer applied to image batches on ``device``.

    aug = StyleAugmentor(alpha, stats, dtype, device)
    aug.ghiasi.load_state_dict(load_ghiasi_params(path))   # or random init
    out = aug(images, generator)

    ``phase_space`` runs the generator's phase-space lowering (the JAX
    augmentor's ``tpu_opt``, its default on an accelerator); the port's
    default is the plain lowering. ``f32_out`` returns the generator's f32
    sigmoid instead of its cast to ``dtype`` (``Ghiasi.f32_out``).
    """

    def __init__(self, alpha: float, stats, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cuda"), phase_space: bool = False,
                 f32_out: bool = False):
        self.alpha = float(alpha)
        self.device = torch.device(device)
        A, mean, base = stats
        self.A = torch.as_tensor(A, dtype=torch.float32, device=self.device)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.base = torch.as_tensor(base, dtype=torch.float32, device=self.device)
        self.ghiasi = Ghiasi(dtype, phase_space, f32_out).to(self.device)
        self.ghiasi.eval().requires_grad_(False)

    def sample_embedding(self, n: int, generator: Optional[torch.Generator] = None,
                         z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z ~ N(mean, cov): randn @ A^T + mean (styleAugmentor.py:44-49).
        Pass ``z`` (n, 100) to use given normal draws."""
        if z is None:
            z = torch.randn((n, EMBED_DIM), generator=generator, device=self.device)
        return z @ self.A.T + self.mean

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Restyle (B, 3, H, W) in [0, 1]; returns the generator's dtype (f32
        with ``f32_out``)."""
        with span("speedplus.restyle"):
            emb = self.sample_embedding(x.shape[0], generator, z)
            emb = self.alpha * emb + (1.0 - self.alpha) * self.base
            return self.ghiasi(x, emb)


def style_augmentor(cfg, device: torch.device, phase_space: bool = False) -> StyleAugmentor:
    """The train CLI's style augmentor: alpha ``--texture_alpha``, bf16 under
    ``--use_fp16`` (else f32), the shipped embedding statistics and generator
    weights of the assets directory, each replaced by a seeded stand-in
    (with a warning) where the assets lack it."""
    try:
        stats = load_style_stats(default_assets_dir())
    except FileNotFoundError:
        logger.warning("Style embedding assets missing; using random stats")
        stats = random_style_stats(cfg.seed)
    dtype = torch.bfloat16 if cfg.fp16 else torch.float32
    torch.manual_seed(cfg.seed + 1)  # random Ghiasi init when the asset is absent
    aug = StyleAugmentor(cfg.texture_alpha, stats, dtype=dtype, device=device,
                         phase_space=phase_space)
    ghiasi_ckpt = os.path.join(default_assets_dir(), "ghiasi_params.msgpack")
    if os.path.exists(ghiasi_ckpt):
        aug.ghiasi.load_state_dict(load_ghiasi_params(ghiasi_ckpt))
        logger.info("Ghiasi transformer weights loaded from %s", ghiasi_ckpt)
    else:
        logger.warning("Ghiasi transformer weights not found (%s); using random "
                       "init", ghiasi_ckpt)
    logger.info("Texture randomization enabled with alpha = %s", cfg.texture_alpha)
    logger.info("   - Randomization ratio: %.2f", cfg.texture_ratio)
    return aug
