"""DANN's FLOPs at a side, per pair of images (one source, one target), as
``work.step_flops`` reads them: it counts a training step as 3 times
``forward_flops`` a row of the batch, so this is a third of what a step
requires of a pair. Each stream runs KRN (``work/krn.py``) and the domain
head (1x1 convs 320 -> 1280 -> 1 on the backbone's map, the mean between
them not counted) forward and backward, 3 forwards, except the target's
tail after the backbone (KRN's extras, router and head), whose output
reaches no loss and so runs forward only."""
from __future__ import annotations

from typing import Tuple

from ..reference import dann, krn
from . import conv_flops
from . import krn as krn_work


def parts(config: dict, side: int) -> Tuple[int, int, int]:
    """(KRN's forward, the part of it after the backbone's map, the domain
    head's forward), one image at ``side``."""
    net = krn.network()
    units = {f"{u.name}.conv:out": u for u in net.units}
    sides = {krn.INPUT: side}
    backbone = 0
    for layer in net.layers[:-1]:
        n = sides[layer.ins[-1]]
        u = units.get(layer.out)
        if u is not None:
            n = -(-n // u.stride)
            if u.name.startswith("base."):
                backbone += conv_flops(u.cin, u.cout, u.k, u.groups, n, n)
        sides[layer.out] = n
    whole = krn_work.forward_flops(config, side)
    m = sides[dann.FEATURE[len(dann.PREFIX):]]
    domain = (conv_flops(dann.FEATURES, dann.HIDDEN, 1, 1, m, m)
              + conv_flops(dann.HIDDEN, 1, 1, 1, 1, 1))
    return whole, whole - backbone, domain


def forward_flops(config: dict, side: int) -> float:
    whole, tail, domain = parts(config, side)
    return (2 * 3 * (whole + domain) - 2 * tail) / 3
