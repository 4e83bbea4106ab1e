"""KRN's forward FLOPs at a side: its 58 convs and the head, each at the
side of the map it reads (BatchNorm, the activations and the router's
reorder are not counted)."""
from __future__ import annotations

from ..reference import krn
from . import conv_flops


def forward_flops(config: dict, side: int) -> int:
    net = krn.network()
    units = {f"{u.name}.conv:out": u for u in net.units}
    sides = {krn.INPUT: side}
    total = 0
    for layer in net.layers[:-1]:
        n = sides[layer.ins[-1]]
        u = units.get(layer.out)
        if u is not None:
            n = -(-n // u.stride)
            total += conv_flops(u.cin, u.cout, u.k, u.groups, n, n)
        sides[layer.out] = n
    k = krn.head_kernel(config)[0]
    n = sides[net.layers[-1].ins[0]] - k + 1
    return total + conv_flops(krn.EXTRA, 2 * config["num_keypoints"], k, 1, n, n)
