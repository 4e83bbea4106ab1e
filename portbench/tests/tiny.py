"""Cells small enough for a test run on the CPU: the configurations' own
files with the input side and class count cut, and small batches."""
from __future__ import annotations

import json
import os

from portbench import spec

LIMITS = {"loss1_gap": 1.0, "grad_gap": 1.0, "grad_gap_median": 1.0, "change_gap": 1.0}


def cell(config: str = "spn", ratio: float = 0.5, limits=None, **overrides) -> spec.Cell:
    bench = spec.benchmark()
    with open(os.path.join(spec.HERE, "configs", f"{config}.json")) as f:
        conf = json.load(f)
    conf.update(input_side=67, num_classes=50)
    traffic = {"runner": "train_resident", "batch": 4, "texture_ratio": ratio,
               "distinct_batches": 8}
    conf.update(overrides)
    return spec.Cell(f"tiny-{config}", 1, conf, traffic, dict(limits or LIMITS),
                     [m for m in bench["end_to_end"]],
                     [m for m in bench["per_layer"]])
