"""Misc utilities (counterpart of ``speedplusbaseline_tpu/io_utils/misc.py``;
reference utils.py:289-315)."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_all_seeds(seed: int) -> torch.Generator:
    """Seed python, numpy and torch (reference utils.py:289-299, which also
    leaves cuDNN nondeterministic) and return a CPU ``torch.Generator``
    seeded with ``seed``, the root of any further draws (the JAX package
    returns its PRNG key here)."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def compute_mean_std(loader):
    """Per-channel dataset statistics (reference utils.py:301-308): the
    per-batch channel means and (population) stds of ``batch["image"]``
    (B, H, W, 3), averaged over the batches. Returns two (3,) float64
    arrays."""
    mu = np.zeros(3)
    std = np.zeros(3)
    n = 0
    for batch in loader:
        x = torch.as_tensor(batch["image"]).double()
        mu += x.mean(dim=(0, 1, 2)).cpu().numpy()
        std += x.std(dim=(0, 1, 2), correction=0).cpu().numpy()
        n += 1
    return mu / n, std / n
