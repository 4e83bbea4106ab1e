"""SPN's forward FLOPs at a side: the trunk's convs (conv1, conv2 and
conv5 each followed by a 3 / 2 max pool) and both branches' three dense
layers."""
from __future__ import annotations

from ..reference import spn
from . import conv_flops


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def forward_flops(config: dict, side: int) -> int:
    total, n = 0, side
    for i, (_name, cin, cout, k, s, p, g) in enumerate(spn.CONVS):
        n = _out(n, k, s, p)
        total += conv_flops(cin, cout, k, g, n, n)
        if i in (0, 1, 4):
            n = _out(n, 3, 2, 0)
    flat = 256 * n * n
    return total + 2 * 2 * (flat * spn.HIDDEN + spn.HIDDEN * spn.HIDDEN
                            + spn.HIDDEN * config["num_classes"])
