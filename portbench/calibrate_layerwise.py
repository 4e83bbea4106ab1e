"""The readings that the limits of ``correct`` are set from, for a cell run
by ``runners/train_layerwise``, over many seeds in one process:

    python -m portbench.calibrate_layerwise --workload <name> --seeds 1 2 3 ... [--controls 3]

For each seed, the program's warm-up exactly as a run makes it
(``train_layerwise.warm_up``), checked layer by layer against the float32
reference at the compared steps: the sound readings. For the first
``--controls`` seeds also the control, the reference with every conv
operand rounded to float8 (one precision below the configuration's bf16),
computed layer by layer from the same inputs in the program's place; and
the program again with each fault of ``faults_krn`` planted in its timed
path, at the cell's own size. Prints one JSON line a seed (each number the
largest over the compared steps) and a summary line: the largest sound
reading of each number and the smallest reading of the control and of
each fault. Runs on the card (``--cpu`` for a rehearsal at the sizes the
configuration states).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import faults_krn, spec
from .runners import train_layerwise as d


def _program(cell, seeds, device, control=False):
    cfg, state, step, _weights, batches = d.build(cell.config, cell.traffic, seeds, device, {})
    gate = d.Gate(cell.traffic["texture_ratio"], seeds.gate)
    _source, _stepper, readings = d.warm_up(cell.config, cfg, state, step, batches, gate,
                                            device, control)
    del state, step, _source, _stepper, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return readings


def readings(cell, seed: int, device: torch.device, controls: bool) -> dict:
    seeds = d.Seeds.of(seed)
    got = _program(cell, seeds, device, controls)
    out = {"seed": seed, "program": d.worst(got), "steps": got}
    if controls:
        out["control_fp8"] = d.worst(got, "control_fp8")
        for key, plant in faults_krn.of(cell.traffic).items():
            with plant():
                out[key] = d.worst(_program(cell, seeds, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate_layerwise")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds that also read the control and the faults")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("calibrate_layerwise: no CUDA device (pass --cpu to rehearse)", file=sys.stderr)
        return 1
    rows = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        row = readings(cell, seed, device, i < args.controls)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "sound_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for key in ("control_fp8", *faults_krn.ALL):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[f"{key}_min"] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
