"""The work the algorithm needs, counted from shapes: FLOPs at 2 a
multiply-add, bytes as each input read once and each output written once.
It reads the same whatever implements the work, and it is what the
rooflines and the step's utilization divide by.

* B1, one Ghiasi residual block at the generator's quarter side: two 3x3
  128 -> 128 convs (``b1_flops``); x read, the block's output written, the
  conv weights, biases and FiLM vectors read (``b1_bytes``).
* B2, one instance norm + FiLM (+ ReLU) site: x read, y written, gamma and
  beta read (``b2_bytes``); the six sites outside the residual blocks
  (``generator_norm_sites``).
* A model's forward (``forward_flops``), its convs and dense layers,
  counted by ``work/<reference>.py`` of its configuration; a training step
  counts 3 times the forward (forward, and backward for the inputs and the
  weights), nothing recomputed, plus the generator's forward on a restyled
  step (``step_flops``).
* The card's peaks (``peaks.json``), by the name the card reports.
"""
from __future__ import annotations

import importlib
import json
import os
from typing import List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FILM_DIM = 4  # float32 gamma and beta


def peaks(kind: str) -> dict:
    """{"bf16_flops": FLOP/s, "hbm_bytes": bytes/s} of the card ``kind``."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r}; known: {sorted(table)}")
    return table[kind]


def _half(n: int) -> int:
    return -(-n // 2)


def generator_sides(side: int) -> Tuple[int, int, int]:
    """(side, side / 2, side / 4) of the generator's maps, rounded up."""
    return side, _half(side), _half(_half(side))


def generator_norm_sites(side: int) -> List[Tuple[int, int, int, bool]]:
    """(H, W, C, film) of the six instance norms outside the residual blocks."""
    s, h, q = generator_sides(side)
    return [(s, s, 32, False), (h, h, 64, False), (q, q, 128, False),
            (2 * q, 2 * q, 64, True), (4 * q, 4 * q, 32, True), (4 * q, 4 * q, 3, True)]


def b1_flops(batch: int, side: int, channels: int = 128) -> int:
    q = generator_sides(side)[2]
    return 2 * (2 * 9 * channels * channels * q * q * batch)


def b1_bytes(batch: int, side: int, elem: int, channels: int = 128) -> int:
    q = generator_sides(side)[2]
    act = 2 * batch * q * q * channels * elem
    params = 4 * (2 * 9 * channels * channels + 2 * channels) + FILM_DIM * 4 * batch * channels
    return act + params


def b2_bytes(batch: int, h: int, w: int, c: int, elem: int, film: bool) -> int:
    return 2 * batch * h * w * c * elem + (2 * FILM_DIM * batch * c if film else 0)


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The larger of the compute time and the byte time at the peaks."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])


def conv_flops(cin: int, cout: int, k: int, groups: int, h: int, w: int) -> int:
    return 2 * (cin // groups) * k * k * cout * h * w


def ghiasi_forward_flops(side: int) -> int:
    """One image through the generator at ``side``: its convs and the dense
    layers that make FiLM's gamma and beta from the 100-wide embedding."""
    s, h, q = generator_sides(side)
    film = 2 * 100 * (5 * 4 * 128 + 2 * (64 + 32 + 3))
    return (film + conv_flops(3, 32, 9, 1, s, s) + conv_flops(32, 64, 3, 1, h, h)
            + conv_flops(64, 128, 3, 1, q, q) + 10 * conv_flops(128, 128, 3, 1, q, q)
            + conv_flops(128, 64, 3, 1, 2 * q, 2 * q) + conv_flops(64, 32, 3, 1, 4 * q, 4 * q)
            + conv_flops(32, 3, 9, 1, 4 * q, 4 * q))


def forward_flops(config: dict, side: int) -> int:
    """One image through the configuration's model at ``side``."""
    counter = importlib.import_module(f"{__package__}.{config['reference']}")
    return counter.forward_flops(config, side)


def step_flops(config: dict, batch: int, styled: bool) -> int:
    """The FLOPs a training step requires. A restyled step feeds the model
    the generator's output, 4 ceil(side / 4) on a side."""
    side = config["input_side"]
    if not styled:
        return 3 * forward_flops(config, side) * batch
    out = 4 * generator_sides(side)[2]
    return (3 * forward_flops(config, out) + ghiasi_forward_flops(side)) * batch
