"""The Ghiasi style generator, plain (Ghiasi et al. 2017, "Exploring the
structure of a real-time, arbitrary neural artistic stylization network",
arXiv:1705.06830), and the style-embedding sampler of the restyle.

Three ReflectionPad + conv + InstanceNorm + ReLU layers down to a quarter
of the side, five residual blocks with two FiLM-conditioned 3x3 convs each,
two nearest-upsample + conv + IN + FiLM + ReLU layers, a 9x9 conv + IN +
FiLM and a sigmoid. FiLM gamma and beta are dense layers of the 100-wide
style embedding. Weights come from the flax msgpack file that the program
also reads (``assets/ghiasi_params.msgpack``), decoded here by ``msgpack``.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Params, Precision, conv, dense, instance_norm

EMBED_DIM = 100
RESBLOCKS = 5


def read_msgpack_tree(path: str) -> dict:
    """A ``flax.serialization.to_bytes`` file as nested dicts of numpy arrays
    (msgpack ext type 1 holds (shape, dtype name, raw bytes))."""
    import msgpack

    def ext_hook(code, data):
        if code == 1:
            shape, dtype, buf = msgpack.unpackb(data)
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, strict_map_key=False)


def load_params(path: str, device: torch.device) -> Params:
    """The generator's weights as ``layer{i}.{conv|fc_*}.{weight|bias}``:
    conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in)."""
    tree = read_msgpack_tree(path)
    if "params" in tree and "layer0" not in tree:
        tree = tree["params"]
    out: Params = {}
    for layer, mods in tree.items():
        for mod, leaves in mods.items():
            name = "conv" if mod == "Conv_0" else mod
            for leaf, v in leaves.items():
                if leaf == "kernel":
                    v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
                    key = "weight"
                else:
                    key = "bias"
                out[f"{layer}.{name}.{key}"] = torch.as_tensor(
                    np.ascontiguousarray(v, dtype=np.float32), device=device)
    return out


def load_style_stats(assets: str, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(A, mean, base) of the embedding sampler: A = U S^1/2 of the PBN
    covariance, its mean, and the SPEED+ mean embedding."""
    mean = np.load(os.path.join(assets, "style_embedding_pbn_mean.npy"))
    cov = np.load(os.path.join(assets, "style_embedding_pbn_cov.npy"))
    base = np.load(os.path.join(assets, "style_embedding_speedplus_mean.npy"))
    u, s, _ = np.linalg.svd(cov)
    A = u @ np.diag(np.sqrt(s))
    return tuple(torch.as_tensor(np.asarray(a, np.float32).reshape(shape), device=device)
                 for a, shape in ((A, A.shape), (mean, (-1,)), (base, (-1,))))


def embedding(z: torch.Tensor, stats, alpha: float) -> torch.Tensor:
    """The style embedding of normals z (B, 100): z A^T + mean, interpolated
    with the SPEED+ mean, alpha * emb + (1 - alpha) * base."""
    A, mean, base = stats
    emb = z @ A.T + mean
    return alpha * emb + (1.0 - alpha) * base


def _pad(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.pad(x, (k // 2,) * 4, mode="reflect") if k > 1 else x


def _film(p: Params, name: str, style: torch.Tensor, prec: Precision, suffix: str = ""):
    return (dense(p, f"{name}.fc_gamma{suffix}", style, prec),
            dense(p, f"{name}.fc_beta{suffix}", style, prec))


def forward(p: Params, x: torch.Tensor, style: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x (B, 3, H, W) in [0, 1], style (B, 100) -> (B, 3, 4 ceil(H/4),
    4 ceil(W/4)) in (0, 1): the stride-2 convs round odd sides up."""
    y = x
    for i, (k, s) in enumerate(((9, 1), (3, 2), (3, 2))):
        y = instance_norm(conv(p, f"layer{i}.conv", _pad(y, k), prec, stride=s), relu=True)
    for i in range(3, 3 + RESBLOCKS):
        g1, b1 = _film(p, f"layer{i}", style, prec, "1")
        g2, b2 = _film(p, f"layer{i}", style, prec, "2")
        h = instance_norm(conv(p, f"layer{i}.conv1", _pad(y, 3), prec), g1, b1, relu=True)
        h = instance_norm(conv(p, f"layer{i}.conv2", _pad(h, 3), prec), g2, b2)
        y = y + h
    for i in (8, 9):
        g, b = _film(p, f"layer{i}", style, prec)
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        y = instance_norm(conv(p, f"layer{i}.conv", _pad(y, 3), prec), g, b, relu=True)
    g, b = _film(p, "layer10", style, prec)
    y = instance_norm(conv(p, "layer10.conv", _pad(y, 9), prec), g, b)
    return torch.sigmoid(y)


def restyle(p: Params, stats, alpha: float, x: torch.Tensor, z: torch.Tensor,
            prec: Precision) -> torch.Tensor:
    """The restyle of a batch, as the trainer applies it (no gradient)."""
    with torch.no_grad():
        return forward(p, x, embedding(z, stats, alpha), prec)

